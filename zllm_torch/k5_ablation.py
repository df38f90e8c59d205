"""What each part of the sliced GEMM loop (`csrc/gemm_slice.cuh`) costs on
the card: K5 (`csrc/dequant_gemm.cu`) or K3 (`csrc/q4k_gemm.cu`) built as
it is and again with one part of the loop taken out of its source, each
variant timed on the GEMMs of a Q4_K_M TinyLlama step or chunk, random
weight bytes:
  q6_k (K5): its 34 Q6_K weights, 22 wv 2048->256 and the head
    2048->32768 on bf16 rows, 11 ffn_down 5632->2048 on f32 rows;
  q4_k (K3): its 99 Q4_K weights, 22 each of wq 2048->2048, wk 2048->256
    and gate|up 2048->11264 on bf16 rows and wo 2048->2048 on f32 rows,
    and 11 ffn_down 5632->2048 on f32 rows.
The variants compute wrong values; only their times mean anything.

Run on a CUDA host from the root of a checkout:
    python -m zllm_torch.k5_ablation [--fmt q6_k|q4_k] [M ...]
(defaults: q6_k, M 4 256).  Prints one JSON line per M: device ms by
weight role for each variant, the unchanged build timed first and last.
    python -m zllm_torch.k5_ablation --plans [--fmt q6_k|q4_k] [M ...]
(default M 44 256 512: the Generator's chunks of a 300-token prompt and the
engine's mixed step) times the unchanged build instead under every plan
(the row form, and the tile form at each split), one JSON line per role
and M, beside the plan `ops/qmatmul.py::slice_plan` picks, to hold its
cost model against."""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from .ops import cuda
from .ops import qmatmul as qmm
from .quant.repack import Q4KWeight, Q6KWeight, QWeight

OUT = cuda.CACHE.parent / "k5_ablation"

# format -> (kernel library, weight planes its entry point takes, fmt code)
KERNELS = {"q6_k": ("dequant_gemm", 3, 0), "q4_k": ("q4k_gemm", 5, 0)}

# variant -> (file, text, replacement): one part of the loop taken out
VARIANTS = {
    "no_fragments": ("gemm_slice.cuh", "for (int kk = 0; kk < BK; kk += 16) {",
                     "for (int kk = 0; kk < 0; kk += 16) {"),
    "no_mma": ("gemm_slice.cuh", "mma_bf16(acc[mi][ni], af[mi], bf[ni]);",
               "acc[mi][ni][0] += __uint_as_float(af[mi][0] ^ bf[ni][0] ^ af[mi][3]);"),
    "no_barrier": ("gemm_slice.cuh", "    __syncthreads();  // every thread's", "    //"),
    "no_weight_fetch": ("gemm_slice.cuh", "      w.fetch(Rp + st", "      if (0) w.fetch(Rp + st"),
    "no_x_fetch": ("gemm_slice.cuh", "        cp_async16(xs + xswz(r, j)",
                   "        if (0) cp_async16(xs + xswz(r, j)"),
    "no_dequant": ("gemm_slice.cuh", "    w.dequant(Rp + st * W::kPieces * T + tid,",
                   "    v[0] = v[1] = Rp[st * W::kPieces * T + tid];\n    if (0) w.dequant(Rp,"),
    "no_round_launch": ("gemm_slice.cuh", "    round_x_kernel<<<", "    if (0) round_x_kernel<<<"),
    "no_reduce_launch": ("gemm_slice.cuh", "  if (nsplit > 1) {", "  if (0) {"),
}


def build(lib: str, n_planes: int) -> dict[str, ctypes._CFuncPtr]:
    """Each variant's zt_<lib> (K5's zt_dequant_gemm or K3's zt_q4k_gemm),
    built in parallel."""
    procs = {}
    for name in ("base", *VARIANTS):
        d = OUT / lib / name
        d.mkdir(parents=True, exist_ok=True)
        for f in cuda.CSRC.glob("*.cu*"):
            text = f.read_text()
            if name != "base" and f.name == VARIANTS[name][0]:
                _, old, new = VARIANTS[name]
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} not in {f.name}")
                text = text.replace(old, new)
            (d / f.name).write_text(text)
        cmd = [cuda.nvcc(), *cuda.NVCC_FLAGS, "-o", str(d / f"{lib}.so"),
               str(d / cuda.SOURCES[lib])]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        fn = getattr(ctypes.CDLL(str(OUT / lib / name / f"{lib}.so")), f"zt_{lib}")
        fn.argtypes = qmm.slice_argtypes(n_planes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def call(fn, x: torch.Tensor, w: QWeight, code: int, n_planes: int, plan=None) -> torch.Tensor:
    """One call through `fn`, with the wrapper's plan (or `plan`) and
    workspaces."""
    y = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    cuda.check(qmm.slice_call(fn, code, x, w, n_planes, y, plan), "ablation call")
    return y


def graph_ms(fn, reps: int = 10) -> float:
    """Device ms of fn(): captured once in a CUDA graph, replayed `reps`
    times between two events (chip_smoke.py's timing)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def weights(fmt: str, g: torch.Generator):
    """[(weight, x dtype)] in call order, and {role: call indices}."""
    def u8(n, cols, hi=256):
        return torch.randint(0, hi, (n, cols), dtype=torch.uint8, device="cuda", generator=g)

    def half(n, cols, scale):
        return (torch.randn(n, cols, device="cuda", generator=g) * scale).half()

    bf, f32 = torch.bfloat16, torch.float32
    if fmt == "q6_k":
        def q6k(n, k):
            return Q6KWeight((k, n), ql=u8(n, k // 2), qh=u8(n, k // 4), a=half(n, k // 16, 0.01))

        calls = [(q6k(256, 2048), bf) for _ in range(22)] + \
            [(q6k(2048, 5632), f32) for _ in range(11)] + [(q6k(32768, 2048), bf)]
        return calls, {"wv": range(22), "ffn_down": range(22, 33), "head": [33]}

    def q4k(n, k):
        return Q4KWeight((k, n), qs=u8(n, k // 2), sc=u8(n, k // 32, 64), mn=u8(n, k // 32, 64),
                         d=half(n, k // 256, 0.001), dmin=half(n, k // 256, 0.001))

    layer = [("wq", 2048, bf), ("wk", 256, bf), ("wo", 2048, f32), ("gate_up", 11264, bf)]
    calls, roles = [], {}
    for _ in range(22):
        for role, n, dt in layer:
            roles.setdefault(role, []).append(len(calls))
            calls.append((q4k(n, 2048), dt))
    roles["ffn_down"] = list(range(len(calls), len(calls) + 11))
    calls += [(q4k(2048, 5632), f32) for _ in range(11)]
    return calls, roles


def plans(fmt: str, ms, g: torch.Generator):
    """Each role's GEMMs under every plan at each M (see the module note)."""
    lib, n_planes, code = KERNELS[fmt]
    fn = cuda.bind(lib, f"zt_{lib}", qmm.slice_argtypes(n_planes))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wcalls, roles = weights(fmt, g)
    for m in ms:
        for role, idx in roles.items():
            ws = [wcalls[i][0] for i in idx]
            (k, n), dt = ws[0].shape, wcalls[idx[0]][1]
            x = torch.randn(m, k, device="cuda", generator=g).to(dt)
            tk = qmm.slice_width(k)
            s = k // tk
            cands = {"row": (tk, s, 0, 1)}
            if m > qmm.ROW_M:
                cands |= {f"tile_spb{spb}": (tk, s, 1, spb) for spb in range(1, s + 1)}
            t = {name: graph_ms(lambda p=p: [call(fn, x, w, code, n_planes, p) for w in ws])
                 for name, p in cands.items()}
            _, _, form, spb = qmm.slice_plan(m, k, n, sms)
            print(json.dumps({"fmt": fmt, "m": m, "role": role, "k": k, "n": n, "x": str(dt),
                              "calls": len(ws), "ms": t, "fastest": min(t, key=t.get),
                              "picked": f"tile_spb{spb}" if form else "row",
                              "card": torch.cuda.get_device_name(0)}), flush=True)


def main(argv):
    fmt, timing_plans = "q6_k", argv[:1] == ["--plans"]
    argv = argv[timing_plans:]
    if argv[:1] == ["--fmt"]:
        fmt, argv = argv[1], argv[2:]
    if fmt not in KERNELS:
        raise SystemExit(f"--fmt takes {', '.join(KERNELS)}, not {fmt}")
    ms = [int(a) for a in argv] or ([44, 256, 512] if timing_plans else [4, 256])
    if not torch.cuda.is_available():
        raise SystemExit("k5_ablation needs a CUDA GPU")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    if timing_plans:
        return plans(fmt, ms, g)
    lib, n_planes, code = KERNELS[fmt]
    fns = build(lib, n_planes)
    wcalls, roles = weights(fmt, g)
    for m in ms:
        xs = {(k, dt): torch.randn(m, k, device="cuda", generator=g).to(dt)
              for k, dt in {(w.shape[0], dt) for w, dt in wcalls}}
        calls = [(xs[w.shape[0], dt], w) for w, dt in wcalls]
        out = {"fmt": fmt, "m": m, "card": torch.cuda.get_device_name(0)}
        for name in ("base", *VARIANTS, "base_again"):
            fn = fns[name.removesuffix("_again")]
            t = {role: graph_ms(lambda idx=idx: [call(fn, *calls[i], code, n_planes)
                                                 for i in idx])
                 for role, idx in roles.items()}
            out[name] = dict(t, all=sum(t.values()))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
