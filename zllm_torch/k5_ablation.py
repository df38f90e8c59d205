"""What each part of K5's loop costs on the card: K5 (`csrc/dequant_gemm.cu`
on `csrc/gemm_slice.cuh`) built as it is and again with one part taken out
of its source, each variant timed on the 34 Q6_K GEMMs of a Q4_K_M
TinyLlama step or chunk (22 wv 2048->256 and the head 2048->32768 on bf16
rows, 11 ffn_down 5632->2048 on f32 rows; random weight bytes).  The
variants compute wrong values; only their times mean anything.

Run on a CUDA host from the root of a checkout:
    python -m zllm_torch.k5_ablation [M ...]        (default: 4 256)
Prints one JSON line per M: device ms by weight role for each variant,
the unchanged build timed first and last."""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from .ops import cuda
from .ops import qmatmul as qmm
from .quant.repack import Q6KWeight

OUT = cuda.CACHE.parent / "k5_ablation"

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


def build() -> dict[str, ctypes._CFuncPtr]:
    """Each variant's zt_dequant_gemm, built in parallel."""
    procs = {}
    for name in ("base", *VARIANTS):
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in cuda.CSRC.glob("*.cu*"):
            text = f.read_text()
            if name != "base" and f.name == VARIANTS[name][0]:
                _, old, new = VARIANTS[name]
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} not in {f.name}")
                text = text.replace(old, new)
            (d / f.name).write_text(text)
        cmd = [cuda.nvcc(), *cuda.NVCC_FLAGS, "-o", str(d / "k5.so"), str(d / "dequant_gemm.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        fn = ctypes.CDLL(str(OUT / name / "k5.so")).zt_dequant_gemm
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def call(fn, x: torch.Tensor, w: Q6KWeight, sms: int) -> torch.Tensor:
    """One K5 call through `fn`, with the wrapper's plan and workspaces."""
    m, (k, n) = x.shape[0], w.shape
    tk, s, form, spb = qmm.slice_plan(m, k, n, sms)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    xb = torch.empty((m, k), dtype=torch.bfloat16, device=x.device) \
        if x.dtype == torch.float32 else None
    ws = torch.empty((s - spb + 1, m, n), dtype=torch.float32, device=x.device) \
        if spb < s else None
    cuda.check(fn(0, x.data_ptr(), cuda.DTYPE_CODE[x.dtype], cuda.ptr(xb),
                  *qmm._plane_ptrs(w, 3), y.data_ptr(), cuda.ptr(ws), m, k, n, tk, form, spb,
                  cuda.stream()), "k5 variant")
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


def main(ms=(4, 256)):
    if not torch.cuda.is_available():
        raise SystemExit("k5_ablation needs a CUDA GPU")
    fns = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def q6k(n, k):
        return Q6KWeight((k, n), ql=torch.randint(0, 256, (n, k // 2), dtype=torch.uint8,
                                                  device="cuda", generator=g),
                         qh=torch.randint(0, 256, (n, k // 4), dtype=torch.uint8, device="cuda",
                                          generator=g),
                         a=(torch.randn(n, k // 16, device="cuda", generator=g) * 0.01).half())

    weights = [q6k(256, 2048) for _ in range(22)] + [q6k(2048, 5632) for _ in range(11)] + \
        [q6k(32768, 2048)]
    roles = {"wv": range(22), "ffn_down": range(22, 33), "head": [33]}
    for m in ms:
        xs = {2048: torch.randn(m, 2048, device="cuda", generator=g).bfloat16(),
              5632: torch.randn(m, 5632, device="cuda", generator=g)}
        calls = [(xs[w.shape[0]], w) for w in weights]
        out = {"m": int(m), "card": torch.cuda.get_device_name(0)}
        for name in ("base", *VARIANTS, "base_again"):
            fn = fns[name.removesuffix("_again")]
            t = {role: graph_ms(lambda idx=idx: [call(fn, *calls[i], sms) for i in idx])
                 for role, idx in roles.items()}
            out[name] = dict(t, all=sum(t.values()))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or (4, 256))
