#!/usr/bin/env python3
"""Smoke test of the zllm_torch port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final result line):
  1. build the six CUDA kernels from zllm_torch/csrc (nvcc, in parallel);
  2. small-model checks: 2-layer llamas in Q4_K, Q4_K_M (zllm_torch.quantize
     from an F16 file) and Q8_0, each generated on the GPU (kernels) and on
     the CPU (their plain versions), logits compared step by step;
  3. main paths, at TinyLlama geometry (all 22 layers, full width, random
     weights from a seed, byte-level tokenizer), loaded in bf16 on the GPU,
     each Generator(max_len=2048).generate on a 300-token prompt (two
     256-token prefill chunks) with 32 greedy tokens, the launch counters
     set to 0 just before and read just after:
       - Q4_K everywhere: 89 K1 + 22 K2 launches per decode step, 89 K3 +
         22 K6 per chunk;
       - Q4_K_M (zllm_torch.quantize from an F16 file: attn_v, the first 11
         ffn_down and the head Q6_K): 99 K1 + 34 K4 + 22 K2 per decode step,
         99 K3 + 34 K5 + 22 K6 per chunk;
  4. each kernel at its main path's shapes against its plain PyTorch
     version on the card (tolerance stated per kernel), timed (device time,
     launches replayed from a CUDA graph) beside the plain version, the
     one-call PyTorch yardstick where there is one, and its bound (bytes
     over 3.35 TB/s or operations over the peak of their type); K4 and K5
     also once each on a full-width Q8_0 weight.

Prints one JSON line per phase result, then the `kernels` line, then the
card's name and power limit from nvidia-smi, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Built kernels and the GGUF files are cached under .cache/ in the checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CACHE = REPO / ".cache" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks
# GGUF bytes per weight: a Q4_K super-block holds 256 weights in 144 bytes,
# a Q6_K one in 210, a Q8_0 block 32 weights in 34
GGUF_BYTES_PER_WEIGHT = {"Q4_K": 144 / 256, "Q6_K": 210 / 256, "Q8_0": 34 / 32}

PROMPT_TOKENS = 300
NEW_TOKENS = 32
MAX_LEN = 2048
CHUNK = 256
SMALL = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512, vocab_size=512)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def nmse(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean() / ((b ** 2).mean() + 1e-30))


def cuda_ms(fn, reps: int) -> float:
    """Device time of fn() in ms: fn's launches are captured once in a CUDA
    graph and the graph is replayed `reps` times between two events, so the
    host's launch overhead does not open gaps on the device."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matvec_phase(torch, fn, plain, calls, n_real, bpw: float, eps: float, check=(),
                 groups=None) -> dict:
    """One decode step's matvecs `calls` [(x, w, fuse, aux)] through the
    kernel wrapper `fn`: device ms (and ms per group of call indices), the
    bound (`bpw` GGUF bytes a weight over each weight's `n_real(w)` columns,
    activations and outputs), and for `check` indices given: agreement with
    `plain` there, the plain version's ms and the cuBLAS bf16 matmul on the
    dequantized weights (`library_ms`)."""
    def run(f, sub):
        for x, w, fuse, aux in sub:
            f(x, w, fuse, aux, eps)

    nbytes = sum(w.shape[0] * n_real(w) * bpw + x.numel() * x.element_size() + 4 * n_real(w)
                 + (4 * w.shape[0] if fuse == "norm" else 0) for x, w, fuse, _ in calls)
    ops = sum(2 * w.shape[0] * n_real(w) for _, w, _, _ in calls)
    bms, bby = bound_ms(nbytes, ops, "int8")
    out = dict(ms=cuda_ms(lambda: run(fn, calls), 20), bound_ms=bms, bound_by=bby)
    if groups:
        out["ms_by_group"] = {name: cuda_ms(lambda idx=idx: run(fn, [calls[i] for i in idx]), 20)
                              for name, idx in groups.items()}
    if check:
        errs, maxabs = [], 0.0
        for x, w, fuse, aux in (calls[i] for i in check):
            a, b = fn(x, w, fuse, aux, eps), plain(x, w, fuse, aux, eps)
            errs.append(nmse(a, b))
            maxabs = max(maxabs, float((a - b).abs().max()))
        dense = [w.dequant(torch.bfloat16) for _, w, _, _ in calls]
        xb = {id(x): x.to(torch.bfloat16) for x, _, _, _ in calls}

        def lib():
            for (x, _, _, _), wd in zip(calls, dense):
                torch.matmul(xb[id(x)][:, : wd.shape[0]], wd)

        out.update(nmse=max(errs), max_abs_err=maxabs,
                   plain_ms=cuda_ms(lambda: run(plain, calls), 2), library_ms=cuda_ms(lib, 20))
    return out


def gemm_phase(torch, fn, plain, calls, n_real, bpw: float, check=(), groups=None) -> dict:
    """One prefill chunk's GEMMs `calls` [(x, w)], as matvec_phase; the
    bound is the larger of the bytes and 2*M*K*N bf16 operations."""
    def run(f, sub):
        for x, w in sub:
            f(x, w)

    m = calls[0][0].shape[0]
    nbytes = sum(w.shape[0] * n_real(w) * bpw + x.numel() * x.element_size() + 4 * m * n_real(w)
                 for x, w in calls)
    ops = sum(2 * m * w.shape[0] * n_real(w) for _, w in calls)
    bms, bby = bound_ms(nbytes, ops, "bf16")
    out = dict(ms=cuda_ms(lambda: run(fn, calls), 5), bound_ms=bms, bound_by=bby)
    if groups:
        out["ms_by_group"] = {name: cuda_ms(lambda idx=idx: run(fn, [calls[i] for i in idx]), 5)
                              for name, idx in groups.items()}
    if check:
        errs, maxabs = [], 0.0
        for x, w in (calls[i] for i in check):
            a, b = fn(x, w), plain(x, w)
            errs.append(nmse(a, b))
            maxabs = max(maxabs, float((a - b).abs().max()))
        dense = [w.dequant(torch.bfloat16) for _, w in calls]
        xb = {id(x): x.to(torch.bfloat16) for x, _ in calls}

        def lib():
            for (x, _), wd in zip(calls, dense):
                torch.matmul(xb[id(x)], wd)

        out.update(nmse=max(errs), max_abs_err=maxabs,
                   plain_ms=cuda_ms(lambda: run(plain, calls), 1), library_ms=cuda_ms(lib, 5))
    return out


def prompt_ids(tok, n: int) -> list[int]:
    text = ("The quick brown fox jumps over the lazy dog while the chip counts every "
            "byte it reads. ") * 8
    ids = tok.encode(text, add_special=True, parse_special=True)[:n]
    if len(ids) != n:
        fail(f"prompt tokenized to {len(ids)} ids, wanted {n}")
    return ids


def gguf_file(name: str, shape: dict, ftype: str) -> tuple[Path, float]:
    """A random-weight llama GGUF in `ftype` (cached): Q4_K and Q8_0 written
    directly by the factory, Q4_K_M requantized by zllm_torch.quantize from
    an F16 file, as users make one.  Returns (path, seconds to make it)."""
    from zllm_torch.gguf.constants import GGMLType
    from zllm_torch.quantize import quantize_file
    from zllm_torch.testing import make_llama_gguf

    path = CACHE / f"{name}_{ftype.lower()}.gguf"
    t0 = time.perf_counter()
    if not path.exists():
        if ftype == "Q4_K_M":
            src = CACHE / f"{name}_f16.gguf"
            make_llama_gguf(str(src), **shape, gtype=GGMLType.F16, seed=0, with_tokenizer=True)
            quantize_file(str(src), str(path), "Q4_K_M", quiet=True)
            src.unlink()
        else:
            make_llama_gguf(str(path), **shape, gtype=GGMLType[ftype], seed=0,
                            with_tokenizer=True)
    return path, time.perf_counter() - t0


def small_model_check(torch, ftype: str):
    """Kernels on the GPU vs plain versions on the CPU, same model, same
    tokens fed to both (teacher forcing), logits compared each step."""
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    path, _ = gguf_file("small", SMALL, ftype)
    runs = {}
    for dev in ("cuda", "cpu"):
        m = Model.load(str(path), device=dev, dtype=torch.bfloat16)
        gen = Generator(m, max_len=256, prefill_chunk=16)
        runs[dev] = (m, gen)
    ids = prompt_ids(runs["cpu"][0].tokenizer, 40)
    cpu_gen, gpu_gen = runs["cpu"][1], runs["cuda"][1]
    cpu_logits = [cpu_gen.prefill(ids).float()]
    steps = [gpu_gen.prefill(ids).float().cpu()]
    tok = int(torch.argmax(cpu_logits[0]))
    for i in range(8):  # the CPU's greedy tokens drive both sides
        cpu_logits.append(cpu_gen._decode_one(tok, len(ids) + i).float())
        steps.append(gpu_gen._decode_one(tok, len(ids) + i).float().cpu())
        tok = int(torch.argmax(cpu_logits[-1]))
    errs = [nmse(a, b) for a, b in zip(steps, cpu_logits)]
    agree = sum(int(torch.argmax(a)) == int(torch.argmax(b)) for a, b in zip(steps, cpu_logits))
    tol = 1e-3
    res = {"phase": "small_model_gpu_vs_cpu", "ftype": ftype, "shape": SMALL,
           "logits_nmse_max": max(errs), "tolerance": tol, "argmax_agree": f"{agree}/{len(errs)}",
           "finite": all(bool(torch.isfinite(a).all()) for a in steps)}
    emit(res)
    if not res["finite"] or max(errs) > tol:
        fail(f"small-model GPU logits disagree with the CPU plain path: {res}")


def main_path(torch, ftype: str, kernels: dict, want, card: str):
    """Load the TinyLlama-geometry file, warm up, then one generate with the
    launch counters set to 0 just before and read just after; `want(cfg,
    n_steps, n_chunks)` gives the expected counts.  Returns the model and
    the counts."""
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator
    from zllm_torch.testing import TINYLLAMA_SHAPE

    shape = dict(TINYLLAMA_SHAPE)
    path, t_gguf = gguf_file("tinyllama", shape, ftype)
    t0 = time.perf_counter()
    model = Model.load(str(path), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    cfg = model.cfg
    gen = Generator(model, max_len=MAX_LEN, prefill_chunk=CHUNK)
    ids = prompt_ids(model.tokenizer, PROMPT_TOKENS)

    gen.generate(ids[:CHUNK + 8], max_new=4)  # warm-up: both chunk shapes, decode
    gen.reset()
    for fn in kernels.values():
        fn.launches = 0
    res = gen.generate(ids, max_new=NEW_TOKENS)
    counts = {name: fn.launches for name, fn in kernels.items()}
    n_chunks = -(-PROMPT_TOKENS // CHUNK)
    n_steps = len(res.tokens) - 1
    expected = want(cfg, n_steps, n_chunks)
    last_logits = gen._decode_one(res.tokens[-1], PROMPT_TOKENS + n_steps).float()
    torch.cuda.synchronize()
    emit({"phase": "main_path", "model": f"tinyllama-geometry {ftype} (random weights, seed 0)",
          "shape": shape, "dtype": "bfloat16", "prompt_tokens": PROMPT_TOKENS,
          "prefill_chunks": n_chunks, "new_tokens": len(res.tokens),
          "prefill_tok_s": PROMPT_TOKENS / res.t_prefill,
          "decode_tok_s": n_steps / res.t_decode, "t_prefill_s": res.t_prefill,
          "t_decode_s": res.t_decode, "gguf_build_s": t_gguf, "load_s": t_load,
          "launches": counts, "launches_expected": expected, "card": card})
    if n_steps != NEW_TOKENS - 1:
        fail(f"{ftype}: generate stopped after {len(res.tokens)} tokens")
    if counts != expected:
        fail(f"{ftype}: kernel launch counts {counts} != expected {expected}")
    if last_logits.shape != (cfg.vocab_size,) or not bool(torch.isfinite(last_logits).all()):
        fail(f"{ftype}: main-path logits are not finite or have the wrong shape")
    return model, counts


def main():
    if not (REPO / "zllm_torch" / "csrc").is_dir():
        fail("zllm_torch/ is not beside chip_smoke.py: run from the root of a checkout")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CACHE.mkdir(parents=True, exist_ok=True)

    from zllm_torch.gguf.constants import GGMLType
    from zllm_torch.ops import attention as att
    from zllm_torch.ops import cuda
    from zllm_torch.ops import qmatmul as qmm
    from zllm_torch.ops.layers import rope_table
    from zllm_torch.quant import blocks as qb
    from zllm_torch.quant.repack import repack

    t0 = time.perf_counter()
    reports = cuda.build()
    ptxas = [line.strip() for log in reports.values() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "built": sorted(reports), "ptxas": ptxas})

    for ftype in ("Q4_K", "Q4_K_M", "Q8_0"):
        small_model_check(torch, ftype)

    # ---- main paths at TinyLlama geometry -------------------------------
    kernels = {"q4k_matvec": qmm.q4k_matvec, "int8_matvec": qmm.int8_matvec,
               "attn_decode_qkv": att.attn_decode_qkv, "q4k_gemm": qmm.q4k_gemm,
               "dequant_gemm": qmm.dequant_gemm, "flash_attention": att.flash_attention}

    def want_q4k(cfg, n_steps, n_chunks):
        L = cfg.n_layers  # wqkv, wo, gate|up, down a layer + the head
        return {"q4k_matvec": (4 * L + 1) * n_steps, "int8_matvec": 0,
                "attn_decode_qkv": L * n_steps, "q4k_gemm": (4 * L + 1) * n_chunks,
                "dequant_gemm": 0, "flash_attention": L * n_chunks}

    def want_q4km(cfg, n_steps, n_chunks):
        # Q4_K: wq, wk, wo, gate|up a layer + ffn_down of the last L/2;
        # Q6_K: wv a layer + ffn_down of the first L/2 + the head
        L, low = cfg.n_layers, cfg.n_layers // 2
        k1, k4 = 4 * L + (L - low), L + low + 1
        return {"q4k_matvec": k1 * n_steps, "int8_matvec": k4 * n_steps,
                "attn_decode_qkv": L * n_steps, "q4k_gemm": k1 * n_chunks,
                "dequant_gemm": k4 * n_chunks, "flash_attention": L * n_chunks}

    model, counts_q4k = main_path(torch, "Q4_K", kernels, want_q4k, card)
    model_m, counts_q4km = main_path(torch, "Q4_K_M", kernels, want_q4km, card)
    paths = {"Q4_K": counts_q4k, "Q4_K_M": counts_q4km}

    # ---- each kernel at the paths' shapes vs its plain version ----------
    cfg = model.cfg
    per_layer = cfg.n_layers
    layers = model.params["layers"]
    head = model.params["output"]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def randn(*shape_, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape_, generator=g, device="cuda") * scale).to(dtype)

    def by_path(name):
        return {p: c[name] for p, c in paths.items()}

    lines = []

    # K1: one Q4_K decode step's 89 matvecs; and the 99 of a Q4_K_M step
    d_model, n_ff = cfg.n_embd, cfg.n_ff
    layers_m, head_m = model_m.params["layers"], model_m.params["output"]

    def n_real(w):
        # the function's own columns: the head is padded to 32768 for the
        # layout, but only the vocabulary's columns count toward the bound
        return cfg.vocab_size if w is head or w is head_m else w.shape[1]

    x_res = randn(1, d_model, scale=3.0)
    x_att = randn(1, d_model)
    x_gup = randn(1, 2 * n_ff)
    x_h = randn(1, d_model, dtype=torch.bfloat16)  # a normed row in the model dtype
    calls = []
    for layer in layers:
        calls += [(x_res, layer["wqkv"], "norm", layer["attn_norm"]),
                  (x_att, layer["wo"], "q", None),
                  (x_res, layer["ffn_gateup"], "norm", layer["ffn_norm"]),
                  (x_gup, layer["ffn_down"], "glu", None)]
    calls.append((x_res, head, "norm", model.params["out_norm"]))
    calls_m = []
    for layer in layers_m:
        calls_m += [(x_h, layer["wq"], "q", None), (x_h, layer["wk"], "q", None),
                    (x_att, layer["wo"], "q", None),
                    (x_res, layer["ffn_gateup"], "norm", layer["ffn_norm"])]
        if layer["ffn_down"].fmt == GGMLType.Q4_K:
            calls_m.append((x_gup, layer["ffn_down"], "glu", None))
    q4km_k1 = matvec_phase(torch, qmm.q4k_matvec, None, calls_m, n_real,
                           GGUF_BYTES_PER_WEIGHT["Q4_K"], cfg.norm_eps)
    lines.append(dict(name="q4k_matvec", route="cuda", source="zllm_torch/csrc/q4k_matvec.cu",
                      replaces="zllm/ops/qmatmul.py:683", launches=counts_q4k["q4k_matvec"],
                      **matvec_phase(torch, qmm.q4k_matvec, qmm.q4k_matvec_plain, calls, n_real,
                                     GGUF_BYTES_PER_WEIGHT["Q4_K"], cfg.norm_eps,
                                     check=(0, 1, 2, 3, len(calls) - 1)),
                      tolerance=1e-6, launches_by_path=by_path("q4k_matvec"),
                      unit="one Q4_K decode step (89 launches)",
                      shapes="22 x [wqkv norm 2048->2560, wo q 2048->2048, gate|up norm "
                             "2048->11264, down glu 5632->2048] + head norm 2048->32000 "
                             "(launched padded to 32768)",
                      launches_per_step=len(calls),
                      q4km_step=dict(q4km_k1, launches=len(calls_m),
                                     shapes="22 x [wq, wk q 2048->2048/256 (bf16 x), wo q, "
                                            "gate|up norm] + 11 x down glu")))

    # K2: one decode step's 22 attention blocks at the last decode position
    n_steps = NEW_TOKENS - 1
    pos_v = PROMPT_TOKENS + n_steps
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv3 = randn(1, hq + 2 * hkv, hd)
    kcs = [randn(1, hkv, MAX_LEN, hd, dtype=torch.bfloat16) for _ in layers]
    vcs = [randn(1, hkv, MAX_LEN, hd, dtype=torch.bfloat16) for _ in layers]
    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    rope = rope_table(pos, cfg.rope, hd)
    scale = 1.0 / hd ** 0.5
    kk, vk = kcs[0].clone(), vcs[0].clone()
    kp, vp = kcs[0].clone(), vcs[0].clone()
    a = att.attn_decode_qkv(qkv3, kk, vk, pos, rope, scale=scale, eps=cfg.norm_eps)
    b = att.attn_decode_qkv_plain(qkv3, kp, vp, pos, rope, scale=scale, eps=cfg.norm_eps)
    k2_err = nmse(a.float(), b.float())
    k2_abs = float((a.float() - b.float()).abs().max())
    rest = torch.arange(MAX_LEN, device="cuda") != pos_v
    if not (torch.equal(kk[:, :, rest], kcs[0][:, :, rest])
            and torch.equal(vk[:, :, rest], vcs[0][:, :, rest])):
        fail("K2 wrote cache rows other than its position")
    row_err = nmse(kk[:, :, pos_v].float(), kp[:, :, pos_v].float())
    if row_err > 1e-5 or not torch.equal(vk[:, :, pos_v], vp[:, :, pos_v]):
        fail(f"K2's new cache row differs from its plain version (k nmse {row_err})")

    def k2():
        for kc, vc in zip(kcs, vcs):
            att.attn_decode_qkv(qkv3, kc, vc, pos, rope, scale=scale, eps=cfg.norm_eps)

    def k2_plain():
        for kc, vc in zip(kcs, vcs):
            att.attn_decode_qkv_plain(qkv3, kc, vc, pos, rope, scale=scale, eps=cfg.norm_eps)

    nbytes = per_layer * (2 * hkv * (pos_v + 1) * hd * 2 + qkv3.numel() * 4 + hq * hd * 4)
    ops = per_layer * 4 * hq * (pos_v + 1) * hd
    bms, bby = bound_ms(nbytes, ops, "bf16")
    lines.append(dict(name="attn_decode_qkv", route="cuda", source="zllm_torch/csrc/attn_decode.cu",
                      replaces="zllm/ops/attention.py:970", launches=counts_q4k["attn_decode_qkv"],
                      max_abs_err=k2_abs, ms=cuda_ms(k2, 20), plain_ms=cuda_ms(k2_plain, 5),
                      bound_ms=bms, bound_by=bby, library_ms=None, nmse=k2_err, tolerance=1e-5,
                      launches_by_path=by_path("attn_decode_qkv"),
                      unit="one decode step (22 launches)",
                      shapes=f"qkv3 [1,{hq + 2 * hkv},{hd}] f32, cache [1,{hkv},{MAX_LEN},{hd}] "
                             f"bf16, pos {pos_v}", launches_per_step=per_layer))
    del kcs, vcs

    # K3: one Q4_K prefill chunk's 89 GEMMs at M = 256; and the 99 of Q4_K_M
    m_rows = CHUNK
    xs = {d_model: randn(m_rows, d_model), n_ff: randn(m_rows, n_ff)}
    xh_m = randn(m_rows, d_model, dtype=torch.bfloat16)  # normed rows in the model dtype
    gcalls = []
    for layer in layers:
        gcalls += [(xs[d_model], layer["wqkv"]), (xs[d_model], layer["wo"]),
                   (xs[d_model], layer["ffn_gateup"]), (xs[n_ff], layer["ffn_down"])]
    gcalls.append((xs[d_model], head))
    gcalls_m = []
    for layer in layers_m:  # wq, wk, gate|up take normed bf16 rows, wo and down f32
        gcalls_m += [(xh_m, layer["wq"]), (xh_m, layer["wk"]), (xs[d_model], layer["wo"]),
                     (xh_m, layer["ffn_gateup"])]
        if layer["ffn_down"].fmt == GGMLType.Q4_K:
            gcalls_m.append((xs[n_ff], layer["ffn_down"]))
    q4km_k3 = gemm_phase(torch, qmm.q4k_gemm, None, gcalls_m, n_real,
                         GGUF_BYTES_PER_WEIGHT["Q4_K"])
    lines.append(dict(name="q4k_gemm", route="cuda", source="zllm_torch/csrc/q4k_gemm.cu",
                      replaces="zllm/ops/qmatmul.py:1402", launches=counts_q4k["q4k_gemm"],
                      **gemm_phase(torch, qmm.q4k_gemm, qmm.q4k_gemm_plain, gcalls, n_real,
                                   GGUF_BYTES_PER_WEIGHT["Q4_K"],
                                   check=(0, 1, 2, 3, len(gcalls) - 1)),
                      tolerance=1e-6, launches_by_path=by_path("q4k_gemm"),
                      unit="one Q4_K prefill chunk (89 launches)",
                      shapes="M=256 x 22 x [2048->2560, 2048->2048, 2048->11264, 5632->2048] "
                             "+ head 2048->32000 (launched padded to 32768)",
                      launches_per_chunk=len(gcalls),
                      q4km_chunk=dict(q4km_k3, launches=len(gcalls_m))))

    # K6: one prefill chunk's 22 attentions: the second chunk (base 256)
    base = CHUNK
    q = randn(1, CHUNK, hq, hd)
    ks = [randn(1, hkv, MAX_LEN, hd, dtype=torch.bfloat16) for _ in layers]
    vs = [randn(1, hkv, MAX_LEN, hd, dtype=torch.bfloat16) for _ in layers]
    positions = (base + torch.arange(CHUNK, device="cuda", dtype=torch.int32))[None]
    a = att.flash_attention(q, ks[0], vs[0], positions, scale=scale)
    b = att.flash_attention_plain(q, ks[0], vs[0], positions, scale=scale)
    k6_err, k6_abs = nmse(a, b), float((a - b).abs().max())
    qbf = q.to(torch.bfloat16).transpose(1, 2)
    mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
            <= positions[0, :, None]).reshape(1, 1, CHUNK, MAX_LEN)
    import torch.nn.functional as F

    def k6():
        for k_, v_ in zip(ks, vs):
            att.flash_attention(q, k_, v_, positions, scale=scale)

    def k6_plain():
        for k_, v_ in zip(ks, vs):
            att.flash_attention_plain(q, k_, v_, positions, scale=scale)

    def k6_lib():
        for k_, v_ in zip(ks, vs):
            F.scaled_dot_product_attention(qbf, k_, v_, attn_mask=mask, scale=scale,
                                           enable_gqa=True)

    visible = sum(base + t + 1 for t in range(CHUNK))
    nbytes = per_layer * (q.numel() * 4 * 2 + 2 * hkv * (base + CHUNK) * hd * 2)
    ops = per_layer * 4 * hq * hd * visible
    bms, bby = bound_ms(nbytes, ops, "bf16")
    lines.append(dict(name="flash_attention", route="cuda", source="zllm_torch/csrc/flash_attn.cu",
                      replaces="zllm/ops/attention.py:33", launches=counts_q4k["flash_attention"],
                      max_abs_err=k6_abs, ms=cuda_ms(k6, 10), plain_ms=cuda_ms(k6_plain, 2),
                      bound_ms=bms, bound_by=bby, library_ms=cuda_ms(k6_lib, 10), nmse=k6_err,
                      tolerance=1e-5, launches_by_path=by_path("flash_attention"),
                      unit="one prefill chunk (22 launches)",
                      shapes=f"q [1,{CHUNK},{hq},{hd}] f32 at base {base}, k/v "
                             f"[1,{hkv},{MAX_LEN},{hd}] bf16", launches_per_chunk=per_layer))
    del ks, vs

    # K4: one Q4_K_M decode step's 34 Q6_K matvecs, in the model's dtypes:
    # wv takes the bf16 normed row, ffn_down the f32 gate|up row, the head
    # the bf16 residual
    x_resb = randn(1, d_model, dtype=torch.bfloat16, scale=3.0)
    calls4 = []
    for layer in layers_m:
        calls4.append((x_h, layer["wv"], "q", None))
        if layer["ffn_down"].fmt == GGMLType.Q6_K:
            calls4.append((x_gup, layer["ffn_down"], "glu", None))
    calls4.append((x_resb, head_m, "norm", model_m.params["out_norm"]))
    groups = {"wv": [i for i, c in enumerate(calls4) if c[2] == "q"],
              "ffn_down": [i for i, c in enumerate(calls4) if c[2] == "glu"],
              "head": [len(calls4) - 1]}
    lines.append(dict(name="int8_matvec", route="cuda", source="zllm_torch/csrc/int8_matvec.cu",
                      replaces="zllm/ops/qmatmul.py:501", launches=counts_q4km["int8_matvec"],
                      **matvec_phase(torch, qmm.int8_matvec, qmm.int8_matvec_plain, calls4, n_real,
                                     GGUF_BYTES_PER_WEIGHT["Q6_K"], cfg.norm_eps,
                                     check=(0, groups["ffn_down"][0], len(calls4) - 1),
                                     groups=groups),
                      tolerance=1e-6, launches_by_path=by_path("int8_matvec"),
                      unit="one Q4_K_M decode step (34 launches)",
                      shapes="22 x wv q 2048->256 (bf16 x) + 11 x down glu 5632->2048 + head "
                             "norm 2048->32000 (launched padded to 32768), all Q6_K",
                      launches_per_step=len(calls4)))

    # K5: one Q4_K_M prefill chunk's 34 Q6_K GEMMs at M = 256 (wv and the
    # head take bf16 normed rows, ffn_down the f32 SwiGLU rows)
    gcalls5 = [(xh_m if w.shape[0] == d_model else xs[n_ff], w) for _, w, _, _ in calls4]
    lines.append(dict(name="dequant_gemm", route="cuda", source="zllm_torch/csrc/dequant_gemm.cu",
                      replaces="zllm/ops/qmatmul.py:1542", launches=counts_q4km["dequant_gemm"],
                      **gemm_phase(torch, qmm.dequant_gemm, qmm.dequant_gemm_plain, gcalls5,
                                   n_real, GGUF_BYTES_PER_WEIGHT["Q6_K"],
                                   check=(0, groups["ffn_down"][0], len(gcalls5) - 1),
                                   groups=groups),
                      tolerance=1e-6, launches_by_path=by_path("dequant_gemm"),
                      unit="one Q4_K_M prefill chunk (34 launches)",
                      shapes="M=256 x [22 x wv 2048->256 (bf16 x), 11 x down 5632->2048 (f32 x), "
                             "head 2048->32000 (launched padded to 32768)], all Q6_K",
                      launches_per_chunk=len(gcalls5)))

    # K4 and K5 once each on a full-width Q8_0 weight (gate shape 2048->5632)
    rng_w = torch.Generator().manual_seed(1)
    w8 = repack(qb.quantize((torch.randn(n_ff, d_model, generator=rng_w) * 0.05).numpy(),
                            GGMLType.Q8_0), (n_ff, d_model), GGMLType.Q8_0, "cuda")
    x8 = randn(m_rows, d_model)
    mv, mv_plain = (qmm.int8_matvec(x_resb, w8, "norm", layers_m[0]["attn_norm"], cfg.norm_eps),
                    qmm.int8_matvec_plain(x_resb, w8, "norm", layers_m[0]["attn_norm"],
                                          cfg.norm_eps))
    gm, gm_plain = qmm.dequant_gemm(x8, w8), qmm.dequant_gemm_plain(x8, w8)
    w8d, x8b = w8.dequant(torch.bfloat16), x8.to(torch.bfloat16)
    wbytes = d_model * n_ff * GGUF_BYTES_PER_WEIGHT["Q8_0"]
    mv_b = bound_ms(wbytes + 2 * d_model + 4 * d_model + 4 * n_ff, 2 * d_model * n_ff, "int8")
    gm_b = bound_ms(wbytes + 4 * m_rows * (d_model + n_ff), 2 * m_rows * d_model * n_ff, "bf16")
    q8 = {"phase": "kernel_q8_0", "card": card, "shape": f"K={d_model} N={n_ff} Q8_0",
          "int8_matvec": dict(fuse="norm", nmse=nmse(mv, mv_plain), tolerance=1e-6,
                              max_abs_err=float((mv - mv_plain).abs().max()),
                              ms=cuda_ms(lambda: qmm.int8_matvec(
                                  x_resb, w8, "norm", layers_m[0]["attn_norm"], cfg.norm_eps), 50),
                              library_ms=cuda_ms(lambda: torch.matmul(x_resb, w8d), 50),
                              bound_ms=mv_b[0], bound_by=mv_b[1]),
          "dequant_gemm": dict(m=m_rows, nmse=nmse(gm, gm_plain), tolerance=1e-6,
                               max_abs_err=float((gm - gm_plain).abs().max()),
                               ms=cuda_ms(lambda: qmm.dequant_gemm(x8, w8), 20),
                               library_ms=cuda_ms(lambda: torch.matmul(x8b, w8d), 20),
                               bound_ms=gm_b[0], bound_by=gm_b[1])}
    emit(q8)
    bad_q8 = [k for k in ("int8_matvec", "dequant_gemm") if not q8[k]["nmse"] <= 1e-6]

    for line in lines:
        emit({"phase": "kernel", "card": card, **line})
    bad = [ln["name"] for ln in lines if not ln["nmse"] <= ln["tolerance"]]
    if bad or bad_q8:
        fail(f"kernels disagree with their plain versions: {bad} (Q8_0: {bad_q8})")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: ln[k] for k in keys} for ln in lines]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
