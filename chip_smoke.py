#!/usr/bin/env python3
"""Smoke test of the zllm_torch port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final result line):
  1. build the four CUDA kernels from zllm_torch/csrc (nvcc, in parallel);
  2. small-model check: a 2-layer Q4_K llama generated on the GPU (kernels)
     and on the CPU (their plain versions), logits compared step by step;
  3. main path: a TinyLlama-geometry Q4_K GGUF (all 22 layers, random
     weights from a seed, byte-level tokenizer) loaded in bf16 on the GPU,
     Generator(max_len=2048).generate on a ~300-token prompt (two prefill
     chunks) with 32 greedy tokens; the kernels' launch counters must show
     89 K1 + 22 K2 launches per decode step and 89 K3 + 22 K6 per chunk;
  4. each kernel at the main path's shapes against its plain PyTorch
     version on the card (tolerance stated per kernel), timed (device time,
     launches replayed from a CUDA graph) beside the plain version, the
     one-call PyTorch yardstick where there is one, and its bound (bytes
     over 3.35 TB/s or operations over the peak of their type).

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
Q4K_BYTES_PER_WEIGHT = 144 / 256  # a Q4_K super-block: 256 weights in 144 bytes

PROMPT_TOKENS = 300
NEW_TOKENS = 32
MAX_LEN = 2048
CHUNK = 256


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


def prompt_ids(tok, n: int) -> list[int]:
    text = ("The quick brown fox jumps over the lazy dog while the chip counts every "
            "byte it reads. ") * 8
    ids = tok.encode(text, add_special=True, parse_special=True)[:n]
    if len(ids) != n:
        fail(f"prompt tokenized to {len(ids)} ids, wanted {n}")
    return ids


def small_model_check(torch, shape: dict):
    """Kernels on the GPU vs plain versions on the CPU, same model, same
    tokens fed to both (teacher forcing), logits compared each step."""
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator
    from zllm_torch.testing import make_llama_gguf

    path = CACHE / "small_q4k.gguf"
    if not path.exists():
        make_llama_gguf(str(path), **shape, with_tokenizer=True)
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
    res = {"phase": "small_model_gpu_vs_cpu", "shape": shape, "logits_nmse_max": max(errs),
           "tolerance": tol, "argmax_agree": f"{agree}/{len(errs)}",
           "finite": all(bool(torch.isfinite(a).all()) for a in steps)}
    emit(res)
    if not res["finite"] or max(errs) > tol:
        fail(f"small-model GPU logits disagree with the CPU plain path: {res}")


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
    from zllm_torch.models.loader import Model
    from zllm_torch.ops import attention as att
    from zllm_torch.ops import cuda
    from zllm_torch.ops import qmatmul as qmm
    from zllm_torch.ops.layers import rope_table
    from zllm_torch.runtime.generate import Generator
    from zllm_torch.testing import TINYLLAMA_SHAPE, make_llama_gguf

    t0 = time.perf_counter()
    reports = cuda.build()
    ptxas = [line.strip() for log in reports.values() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "built": sorted(reports), "ptxas": ptxas})

    small_model_check(torch, dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512,
                                  vocab_size=512, gtype=GGMLType.Q4_K))

    # ---- main path at TinyLlama geometry --------------------------------
    shape = dict(TINYLLAMA_SHAPE)
    path = CACHE / "tinyllama_q4k.gguf"
    t0 = time.perf_counter()
    if not path.exists():
        make_llama_gguf(str(path), **shape, gtype=GGMLType.Q4_K, seed=0, with_tokenizer=True)
    t_gguf = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = Model.load(str(path), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    cfg = model.cfg
    gen = Generator(model, max_len=MAX_LEN, prefill_chunk=CHUNK)
    ids = prompt_ids(model.tokenizer, PROMPT_TOKENS)

    kernels = {"q4k_matvec": qmm.q4k_matvec, "attn_decode_qkv": att.attn_decode_qkv,
               "q4k_gemm": qmm.q4k_gemm, "flash_attention": att.flash_attention}
    gen.generate(ids[:CHUNK + 8], max_new=4)  # warm-up: both chunk shapes, decode
    gen.reset()
    for fn in kernels.values():
        fn.launches = 0
    res = gen.generate(ids, max_new=NEW_TOKENS)
    counts = {name: fn.launches for name, fn in kernels.items()}
    n_chunks = -(-PROMPT_TOKENS // CHUNK)
    n_steps = len(res.tokens) - 1
    per_layer = cfg.n_layers
    want = {"q4k_matvec": (4 * per_layer + 1) * n_steps, "attn_decode_qkv": per_layer * n_steps,
            "q4k_gemm": (4 * per_layer + 1) * n_chunks, "flash_attention": per_layer * n_chunks}
    last_logits = gen._decode_one(res.tokens[-1], PROMPT_TOKENS + n_steps).float()
    torch.cuda.synchronize()
    summary = {"phase": "main_path", "model": "tinyllama-geometry Q4_K (random weights, seed 0)",
            "shape": shape, "dtype": "bfloat16", "prompt_tokens": PROMPT_TOKENS,
            "prefill_chunks": n_chunks, "new_tokens": len(res.tokens),
            "prefill_tok_s": PROMPT_TOKENS / res.t_prefill,
            "decode_tok_s": n_steps / res.t_decode, "t_prefill_s": res.t_prefill,
            "t_decode_s": res.t_decode, "gguf_build_s": t_gguf, "load_s": t_load,
            "launches": counts, "launches_expected": want, "card": card}
    emit(summary)
    if n_steps != NEW_TOKENS - 1:
        fail(f"generate stopped after {len(res.tokens)} tokens")
    if counts != want:
        fail(f"kernel launch counts {counts} != expected {want}")
    if last_logits.shape != (cfg.vocab_size,) or not bool(torch.isfinite(last_logits).all()):
        fail("main-path logits are not finite or have the wrong shape")

    # ---- each kernel at the path's shapes vs its plain version ----------
    layers = model.params["layers"]
    head = model.params["output"]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def randn(*shape_, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape_, generator=g, device="cuda") * scale).to(dtype)

    lines = []

    # K1: one decode step's 89 matvecs
    d_model, n_ff = cfg.n_embd, cfg.n_ff
    x_res = randn(1, d_model, scale=3.0)
    x_att = randn(1, d_model)
    x_gup = randn(1, 2 * n_ff)
    calls = []
    for layer in layers:
        calls += [(x_res, layer["wqkv"], "norm", layer["attn_norm"]),
                  (x_att, layer["wo"], "q", None),
                  (x_res, layer["ffn_gateup"], "norm", layer["ffn_norm"]),
                  (x_gup, layer["ffn_down"], "glu", None)]
    calls.append((x_res, head, "norm", model.params["out_norm"]))
    # the function's own columns: the head is padded to 32768 for the layout,
    # but only the vocabulary's columns count toward the bound
    n_real = {id(w): w.shape[1] for _, w, _, _ in calls}
    n_real[id(head)] = cfg.vocab_size
    errs, maxabs = [], 0.0
    for x, w, fuse, aux in calls[:4] + calls[-1:]:
        a = qmm.q4k_matvec(x, w, fuse, aux, cfg.norm_eps)
        b = qmm.q4k_matvec_plain(x, w, fuse, aux, cfg.norm_eps)
        errs.append(nmse(a, b))
        maxabs = max(maxabs, float((a - b).abs().max()))
    dense = [w.dequant(torch.bfloat16) for _, w, _, _ in calls]
    xb = {id(x): x.to(torch.bfloat16) for x, _, _, _ in calls}

    def k1():
        for x, w, fuse, aux in calls:
            qmm.q4k_matvec(x, w, fuse, aux, cfg.norm_eps)

    def k1_plain():
        for x, w, fuse, aux in calls:
            qmm.q4k_matvec_plain(x, w, fuse, aux, cfg.norm_eps)

    def k1_lib():
        for (x, _, fuse, _), wd in zip(calls, dense):
            torch.matmul(xb[id(x)][:, : wd.shape[0]], wd)

    nbytes = sum(w.shape[0] * n_real[id(w)] * Q4K_BYTES_PER_WEIGHT
                 + x.numel() * x.element_size() + 4 * n_real[id(w)]
                 + (4 * w.shape[0] if fuse == "norm" else 0) for x, w, fuse, _ in calls)
    ops = sum(2 * w.shape[0] * n_real[id(w)] for _, w, _, _ in calls)
    bms, bby = bound_ms(nbytes, ops, "int8")
    lines.append(dict(name="q4k_matvec", route="cuda", source="zllm_torch/csrc/q4k_matvec.cu",
                      replaces="zllm/ops/qmatmul.py:683", launches=counts["q4k_matvec"],
                      max_abs_err=maxabs, ms=cuda_ms(k1, 20), plain_ms=cuda_ms(k1_plain, 2),
                      bound_ms=bms, bound_by=bby, library_ms=cuda_ms(k1_lib, 20),
                      nmse=max(errs), tolerance=1e-6, unit="one decode step (89 launches)",
                      shapes="22 x [wqkv norm 2048->2560, wo q 2048->2048, gate|up norm "
                             "2048->11264, down glu 5632->2048] + head norm 2048->32000 "
                             "(launched padded to 32768)",
                      launches_per_step=len(calls)))
    del dense

    # K2: one decode step's 22 attention blocks at the last decode position
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
                      replaces="zllm/ops/attention.py:970", launches=counts["attn_decode_qkv"],
                      max_abs_err=k2_abs, ms=cuda_ms(k2, 20), plain_ms=cuda_ms(k2_plain, 5),
                      bound_ms=bms, bound_by=bby, library_ms=None, nmse=k2_err, tolerance=1e-5,
                      unit="one decode step (22 launches)",
                      shapes=f"qkv3 [1,{hq + 2 * hkv},{hd}] f32, cache [1,{hkv},{MAX_LEN},{hd}] "
                             f"bf16, pos {pos_v}", launches_per_step=per_layer))
    del kcs, vcs

    # K3: one prefill chunk's 89 GEMMs at M = 256
    m_rows = CHUNK
    xs = {d_model: randn(m_rows, d_model), n_ff: randn(m_rows, n_ff)}
    gcalls = []
    for layer in layers:
        gcalls += [(xs[d_model], layer["wqkv"]), (xs[d_model], layer["wo"]),
                   (xs[d_model], layer["ffn_gateup"]), (xs[n_ff], layer["ffn_down"])]
    gcalls.append((xs[d_model], head))
    errs, maxabs = [], 0.0
    for x, w in gcalls[:4] + gcalls[-1:]:
        a, b = qmm.q4k_gemm(x, w), qmm.q4k_gemm_plain(x, w)
        errs.append(nmse(a, b))
        maxabs = max(maxabs, float((a - b).abs().max()))
    dense = [w.dequant(torch.bfloat16) for _, w in gcalls]
    xsb = {k: v.to(torch.bfloat16) for k, v in xs.items()}

    def k3():
        for x, w in gcalls:
            qmm.q4k_gemm(x, w)

    def k3_plain():
        for x, w in gcalls:
            qmm.q4k_gemm_plain(x, w)

    def k3_lib():
        for (x, _), wd in zip(gcalls, dense):
            torch.matmul(xsb[x.shape[1]], wd)

    nbytes = sum(w.shape[0] * n_real[id(w)] * Q4K_BYTES_PER_WEIGHT + x.numel() * 4
                 + 4 * m_rows * n_real[id(w)] for x, w in gcalls)
    ops = sum(2 * m_rows * w.shape[0] * n_real[id(w)] for _, w in gcalls)
    bms, bby = bound_ms(nbytes, ops, "bf16")
    lines.append(dict(name="q4k_gemm", route="cuda", source="zllm_torch/csrc/q4k_gemm.cu",
                      replaces="zllm/ops/qmatmul.py:1402", launches=counts["q4k_gemm"],
                      max_abs_err=maxabs, ms=cuda_ms(k3, 5), plain_ms=cuda_ms(k3_plain, 1),
                      bound_ms=bms, bound_by=bby, library_ms=cuda_ms(k3_lib, 5),
                      nmse=max(errs), tolerance=1e-6, unit="one prefill chunk (89 launches)",
                      shapes="M=256 x 22 x [2048->2560, 2048->2048, 2048->11264, 5632->2048] "
                             "+ head 2048->32000 (launched padded to 32768)",
                      launches_per_chunk=len(gcalls)))
    del dense

    # K6: one prefill chunk's 22 attentions: the second chunk (base 256)
    base = CHUNK
    q = randn(1, CHUNK, hq, hd)
    ks = [randn(1, hkv, MAX_LEN, hd, dtype=torch.bfloat16) for _ in layers]
    vs = [randn(1, hkv, MAX_LEN, hd, dtype=torch.bfloat16) for _ in layers]
    positions = (base + torch.arange(CHUNK, device="cuda", dtype=torch.int32))[None]
    a = att.flash_attention(q, ks[0], vs[0], positions, scale=scale)
    b = att.flash_attention_plain(q, ks[0], vs[0], positions, scale=scale)
    k6_err, k6_abs = nmse(a, b), float((a - b).abs().max())
    qb = q.to(torch.bfloat16).transpose(1, 2)
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
            F.scaled_dot_product_attention(qb, k_, v_, attn_mask=mask, scale=scale,
                                           enable_gqa=True)

    visible = sum(base + t + 1 for t in range(CHUNK))
    nbytes = per_layer * (q.numel() * 4 * 2 + 2 * hkv * (base + CHUNK) * hd * 2)
    ops = per_layer * 4 * hq * hd * visible
    bms, bby = bound_ms(nbytes, ops, "bf16")
    lines.append(dict(name="flash_attention", route="cuda", source="zllm_torch/csrc/flash_attn.cu",
                      replaces="zllm/ops/attention.py:33", launches=counts["flash_attention"],
                      max_abs_err=k6_abs, ms=cuda_ms(k6, 10), plain_ms=cuda_ms(k6_plain, 2),
                      bound_ms=bms, bound_by=bby, library_ms=cuda_ms(k6_lib, 10), nmse=k6_err,
                      tolerance=1e-5, unit="one prefill chunk (22 launches)",
                      shapes=f"q [1,{CHUNK},{hq},{hd}] f32 at base {base}, k/v "
                             f"[1,{hkv},{MAX_LEN},{hd}] bf16", launches_per_chunk=per_layer))

    for line in lines:
        emit({"phase": "kernel", "card": card, **line})
    bad = [ln["name"] for ln in lines if not ln["nmse"] <= ln["tolerance"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: ln[k] for k in keys} for ln in lines]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
