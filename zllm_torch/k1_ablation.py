"""What each part of a decode kernel costs on the card: the source built as
it is and again with one part taken out, each build timed by CUDA-graph
replay.  Three kernels (`--kernel`, K1 by default):

k1, the decode matvec of the nibble formats (`csrc/q4k_matvec.cu`), on the
89 matvecs of a TinyLlama-geometry Q4_K decode step (22 x [wqkv norm
2048->2560, wo q 2048->2048, gate|up norm 2048->11264, down glu
5632->2048] + the head norm 2048->32768), random weight bytes from a seed,
f32 activations:
  no_columns:  no output column, so a launch keeps only its fixed part
               (the launch itself and the activation prologue);
  no_prologue: the activations taken as already quantized (no
               `quantize_row`);
  bare:        both, the launch alone;
  serial:      each column's weights fetched just before its dots (the
               second register set not in flight ahead);
  no_pdl:      launched without programmatic stream serialization;
  trigger_late: griddepcontrol.launch_dependents at a block's end, not its
               start;
  one_block:   one block an SM, not two;
  no_cluster:  the glu prologue done by every block alone, not shared by
               a cluster of blocks;
  glu_no_exp:  the glu prologue without its sigmoid (silu(g) * u as g * u);
  no_div:      the prologue's quantization multiplying by dx, not dividing.

k4, the decode matvec of Q6_K and Q8_0 (`csrc/int8_matvec.cu`), on the 34
Q6_K matvecs of a TinyLlama-geometry Q4_K_M decode step (22 x wv q
2048->256 with a bf16 row, 11 x down glu 5632->2048 with an f32 row, the
head norm 2048->32768 with a bf16 row), random weight bytes from a seed:
  no_columns, no_prologue, bare: as for k1;
  serial, no_pdl, trigger_late, one_block, no_cluster: as for k1 (the
               rebuilt form only);
  packed:      narrow N packed sixteen columns a block (wv: 16 blocks),
               not spread over the SMs a few columns a block.

k2, the decode attention block (`csrc/attn_decode.cu`), on the 22 launches
of a TinyLlama decode step (B 1, 32/4 heads of 64, f32 qkv row, bf16
caches of 2048 slots, position 331) and of a TinyLlama contiguous engine
step (B 4, a stripe of 2176 slots, positions 255, 0, 300 and a trash row
at 2176), each layer its own cache:
  launch:      the kernel returns at once (the launch alone);
  insert:      it returns after the split, norms, rope and cache insert;
  scores:      ... and after the scores;
  softmax:     ... and after the softmax statistics;
  no_pdl:      (the rebuilt form only) launched without programmatic
               stream serialization;
  no_pv:       (the rebuilt form only) no P.V (the output from zeros);
  no_out:      (the rebuilt form only) no output store;
  warps8:      (the rebuilt form only) blocks of 8 warps, not 16.

k12, the decode matvec of the nibble formats under ZLLM_QMM_HBM=1
(`csrc/q4k_matvec_hbm.cu`), on the 89 matvecs of the TinyLlama Q4_K step
above, the 65 of an OLMo-2-0425-1B Q4_K decode step (16 x [wqkv
2048->6144, wo 2048->2048, gate|up 2048->16384, down 8192->2048] with
fuse q, the head norm 2048->100352) and the same 65 in Q4_1, random weight
bytes from a seed, f32 activations:
  no_columns, no_prologue, bare: as for k1 (both forms: the earlier one's
               block-wide cp.async ring, the rebuilt one's bulk-copy
               rings);
  no_pdl, one_block, no_cluster, trigger_late: as for k1 (the rebuilt
               form only);
  stages3, stages4: (the rebuilt form only) a ring of 3 or 4 slots a warp,
               not 2;
  chunks16, chunks64: (the rebuilt form only) stages of 16 or 64 chunks
               of 64 weights, not 32;
  no_scales:   (the rebuilt form only) no scale loads (the cost of the
               scales, which come into registers as in K1);
  no_proxy_fence: (the rebuilt form only) a slot refilled without the
               fence.proxy.async before its bulk copy.

k11, the dual-view decode matvec of Q4_0 and Q4_1 under
ZLLM_QMM_DUALDOT=1 (`csrc/w4a8dd_matvec.cu`), on the 64 fuse-q matvecs of
the OLMo-2 Q4_1 step above and the 22 wo matvecs (2048->2048) of a
TinyLlama Q4_0 step, f32 activations:
  no_columns:  as for k1;
  no_prologue: the earlier two-launch form: its quantize launch returns at
               once and the dot copies no row in; the rebuilt form: no
               `quantize_row`;
  bare:        both;
  no_pdl, serial, one_block: as for k1 (the rebuilt form only).
  Besides the builds, `zt_quantize_acts` (the one-block quantize) timed
  alone on the calls' rows, and in the two-launch form the dot launch
  alone on rows quantized beforehand (`apart`).
For k12 and k11 a last line times K1 (`csrc/q4k_matvec.cu`, as built
for the package) on the same calls (`k1_same_calls`).

A variant whose anchor text the source lacks (an older form) is reported
as such.  The variants compute wrong values; only their times mean anything.

Run on a CUDA host from the root of a checkout:
    python -m zllm_torch.k1_ablation [--kernel k1|k4|k2|k12|k11]
Prints one JSON line per build, the unchanged one first and last: the
graph-replay device ms of the whole set of launches, of each role's
launches alone (k1: 22 each, the head 1; k4: wv 22, down 11, head 1; k2:
the step and the engine step; k12: each step, and the Q4_K steps by
role; k11: the two sets), and the registers of the build's kernel
instantiations (`-Xptxas -v`).
    python -m zllm_torch.k1_ablation [--kernel k1|k2] --step
times instead a whole decode step with the builds that compute right
values (k1: as it is, no_pdl, no_cluster, serial, one_block; k2: as it
is, no_pdl): a TinyLlama Q4_K model (random weights, seed 0) prefilled
with 300 tokens, one B = 1 step's forward at position 331 captured in a
CUDA graph and replayed, so the kernel runs beside the others and the
torch ops as a real step interleaves them."""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from typing import NamedTuple

import torch

from .ops import attention as att
from .ops import cuda
from .ops import qmatmul as qmm
from .quant.repack import Q4KWeight, Q6KWeight, Q40Weight, Q41Weight

OUT = cuda.CACHE.parent / "k1_ablation"


class Kernel(NamedTuple):
    lib: str      # library name in ops/cuda.py's SOURCES
    symbol: str   # its C entry point
    entry: str    # the __global__ name -Xptxas reports
    variants: dict
    step_variants: tuple


# variant -> alternatives, each a list of (text, replacement) applied to the
# kernel's source, or (file, text, replacement) to another source; the first
# alternative whose texts all occur is taken (the later ones fit an earlier
# form of the kernel)
K1_NO_COLUMNS = [[("const int nu = ncols * upc;", "const int nu = 0 * ncols * upc;")],
                 [("  if (n0 < N) fetch_col(cr, w, n0, K, 0, lane);",
                   "  if (0) fetch_col(cr, w, n0, K, 0, lane);"),
                  ("for (int j = 0; j < cols_per_warp; ++j) {", "for (int j = 0; j < 0; ++j) {")]]
K1_NO_PROLOGUE = [[("    quantize_row<TX, MODE, 32, kThreads>(x, aux, K, eps, row);\n", ""),
                   ("    quantize_glu_cluster<TX, 32, kThreads>(x, K, row);\n",
                    '    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");\n')],
                  [("    quantize_row<TX, MODE, 32, kThreads>(x, aux, K, eps, row);\n", ""),
                   ("    quantize_glu_cluster<TX>(x, K, row);\n",
                    '    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");\n')],
                  [("  quantize_row<TX, MODE, 32, kThreads>(x, aux, K, eps, row);\n", "")]]
# the launch machinery lives in matvec_common.cuh, shared by K1 and K4
COMMON = "matvec_common.cuh"
NO_PDL = [[(COMMON, "attr[na].val.programmaticStreamSerializationAllowed = 1;",
            "attr[na].val.programmaticStreamSerializationAllowed = 0;")],
          [("attr[na].val.programmaticStreamSerializationAllowed = 1;",
            "attr[na].val.programmaticStreamSerializationAllowed = 0;")]]
NO_CLUSTER = [[("  const int cl = MODE == kGlu ? glu_cluster<32>(K) : 1;", "  const int cl = 1;")],
              [("  const int cl = MODE == kGlu ? glu_cluster(K) : 1;", "  const int cl = 1;")]]
ONE_BLOCK = [[(COMMON, "  return (N + 2 * sms * warps - 1) / (2 * sms * warps);",
               "  return (N + sms * warps - 1) / (sms * warps);")],
             [("  const int cpw = (N + 2 * sms * kWarps - 1) / (2 * sms * kWarps);",
               "  const int cpw = (N + sms * kWarps - 1) / (sms * kWarps);")]]
TRIGGER_LATE = [("  launch_dependents();\n  if (MODE == kGlu)", "  if (MODE == kGlu)"),
                ("    fetch(cb, u + 3);\n  }\n", "    fetch(cb, u + 3);\n  }\n  launch_dependents();\n")]
SERIAL = [("  fetch(cb, 1);\n", ""),
          ("    dots(ca, u);\n    fetch(ca, u + 2);\n    dots(cb, u + 1);\n"
           "    fetch(cb, u + 3);\n",
           "    if (u > 0) fetch(ca, u);\n    dots(ca, u);\n    fetch(cb, u + 1);\n"
           "    dots(cb, u + 1);\n")]
K1_VARIANTS = {
    "no_columns": K1_NO_COLUMNS,
    "no_prologue": K1_NO_PROLOGUE,
    "bare": [a + b for a in K1_NO_COLUMNS[:1] for b in K1_NO_PROLOGUE[:2]]
            + [K1_NO_COLUMNS[1] + K1_NO_PROLOGUE[2]],
    "serial": [SERIAL],
    "no_pdl": NO_PDL,
    "no_cluster": NO_CLUSTER,
    "one_block": ONE_BLOCK,
    "glu_no_exp": [[(COMMON, "return gg * (1.f / (1.f + expf(-gg))) * u;", "return gg * u;")]],
    "no_div": [[(COMMON, "rintf(v[i] / dx)", "rintf(v[i] * dx)")]],
    "trigger_late": [TRIGGER_LATE],
}

K4_NO_COLUMNS = [[("const int nu = ncols * upc;", "const int nu = 0 * ncols * upc;")],
                 [("  if (n0 < N) fetch(n0, 0);", "  if (0) fetch(n0, 0);"),
                  ("for (int j = 0; j < cols_per_warp; ++j) {", "for (int j = 0; j < 0; ++j) {")]]
K4_NO_PROLOGUE = [[("    quantize_row<TX, MODE, F::kGroup, kThreads>(x, aux, K, eps, row);\n", ""),
                   ("    quantize_glu_cluster<TX, F::kGroup, kThreads>(x, K, row);\n",
                    '    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");\n')],
                  [("  quantize_row<TX, MODE, F::kGroup, kThreads>(x, aux, K, eps, row);\n", "")]]
K4_VARIANTS = {
    "no_columns": K4_NO_COLUMNS,
    "no_prologue": K4_NO_PROLOGUE,
    "bare": [K4_NO_COLUMNS[0] + K4_NO_PROLOGUE[0], K4_NO_COLUMNS[1] + K4_NO_PROLOGUE[1]],
    "serial": [SERIAL],
    "no_pdl": NO_PDL[:1],
    "no_cluster": [[("  const int cl = MODE == kGlu ? glu_cluster<F::kGroup>(K) : 1;",
                     "  const int cl = 1;")]],
    "one_block": ONE_BLOCK[:1],
    "trigger_late": [TRIGGER_LATE],
    "packed": [[("  const int wpb = spread_warps(N, cpw, sms, kWarps);",
                 "  const int wpb = kWarps;")]],
}

# K2: the rebuilt form's anchors first, then the earlier form's (one block a
# query head)
K2_RET = "  if (Hq > 0) return;\n"
K2_VARIANTS = {
    "launch": [[("  launch_dependents();\n", "  launch_dependents();\n  if (p.Hq > 0) return;\n")],
               [("  const int hqi = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;\n",
                 "  const int hqi = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;\n" + K2_RET)]],
    "insert": [[("  // ---- scores of the own chunk",
                 "  if (p.Hq > 0) return;\n  // ---- scores of the own chunk")],
               [("  const int hi = pos < S - 1 ? pos : S - 1;\n",
                 K2_RET + "  const int hi = pos < S - 1 ? pos : S - 1;\n")]],
    "scores": [[("  // ---- the own chunk's statistics",
                 "  if (p.Hq > 0) { if (tid == 0 && sc[0] == 12345.f) p.counters[0] = 1; return; }\n"
                 "  // ---- the own chunk's statistics")],
               [("  mx = block_reduce<true>(mx, red);\n",
                 "  mx = block_reduce<true>(mx, red);\n" + K2_RET)]],
    "softmax": [[("  // ---- phase 2:",
                  "  if (p.Hq > 0) { if (tid < RM && wsum[tid] == 12345.f) p.counters[0] = 1; "
                  "return; }\n  // ---- phase 2:")],
                [("  l = block_reduce<false>(l, red);\n",
                  "  l = block_reduce<false>(l, red);\n  if (Hq > 0) { if (tid == 0) srow[0] = l; "
                  "return; }\n")]],
    "no_pdl": [[("attr[0].val.programmaticStreamSerializationAllowed = 1;",
                 "attr[0].val.programmaticStreamSerializationAllowed = 0;")]],
    "no_pv": [[("  for (int i = 0; i < nsp; ++i) {\n    const int ci",
                "  for (int i = 0; i < 0 * nsp; ++i) {\n    const int ci")]],
    "no_out": [[("    out[e] = from_f<TQ>(o);", "    if (o == 12345.f) out[e] = from_f<TQ>(o);")]],
    "warps8": [[("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")]],
}

# K12: the rebuilt form's anchors first (its prologue's are K1's), then the
# earlier form's, whose block owned n_cols columns and quantized with
# quantize_row alone
K12_NO_COLUMNS = [[("  const int nu = ncols * upc;\n  uint64_t",
                    "  const int nu = 0 * ncols * upc;\n  uint64_t")],
                  [("const int n_cols = min(NB, N - n0);",
                    "const int n_cols = 0 * min(NB, N - n0);")]]


def _rebuilt(anchor: str) -> tuple[str, str]:
    """A no-op edit that holds a variant to the sources whose kernel file
    contains `anchor` (the rebuilt forms)."""
    return (anchor, anchor)


K12_NO_PROLOGUE = [K1_NO_PROLOGUE[0], K1_NO_PROLOGUE[2]]
K12_STAGES = "constexpr int kStages = 2;              // ring slots a warp"
K12_CHUNKS = "constexpr int kChunks = 32;             // 64-weight chunks a stage holds"
K12_VARIANTS = {
    "no_columns": K12_NO_COLUMNS,
    "no_prologue": K12_NO_PROLOGUE,
    "bare": [K12_NO_COLUMNS[0] + K12_NO_PROLOGUE[0], K12_NO_COLUMNS[1] + K12_NO_PROLOGUE[1]],
    "no_pdl": [NO_PDL[0] + [_rebuilt("launch_matvec(kern")]],
    "one_block": [ONE_BLOCK[0] + [_rebuilt("wave_cols(N, sms, kWarps)")]],
    "no_cluster": NO_CLUSTER[:1],
    "trigger_late": [[("  launch_dependents();\n  if (MODE == kGlu)", "  if (MODE == kGlu)"),
                      ("      if (u + kStages < nu) fill(si, u + kStages);\n    }\n  }\n",
                       "      if (u + kStages < nu) fill(si, u + kStages);\n    }\n  }\n"
                       "  launch_dependents();\n")]],
    **{f"stages{n}": [[(K12_STAGES, K12_STAGES.replace("= 2;", f"= {n};"))]] for n in (3, 4)},
    **{f"chunks{n}": [[(K12_CHUNKS, K12_CHUNKS.replace("= 32;", f"= {n};"))]] for n in (16, 64)},
    "no_scales": [[("      if (c < nchunk) scales[si][it].load(w, (size_t)n, 2 * c + part, K);",
                    "")]],
    "no_proxy_fence": [[('      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");\n',
                         "")]],
}

# K11: the earlier two-launch form's anchors first (its quantize kernel
# has the rebuilt form's quantize_row line), then the rebuilt form's
K11_COPY_IN = ("  for (int i = threadIdx.x; i < K / 16; i += kThreads)\n"
               "    reinterpret_cast<int4*>(sxq)[i] = reinterpret_cast<const int4*>(xq)[i];\n"
               "  for (int g = threadIdx.x; g < K / 32; g += kThreads) {\n"
               "    sdx[g] = dx[g];\n    se[g] = e[g];\n  }\n")
K11_NO_QUANT_LAUNCH = ("  if (K % 256 != 0) return (int)cudaErrorInvalidValue;\n"
                       "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
                       "  const size_t bytes = QuantRow<32>::bytes(K);")
K11_NO_PROLOGUE = [[(K11_COPY_IN, ""),
                    (K11_NO_QUANT_LAUNCH, K11_NO_QUANT_LAUNCH.replace("K % 256 != 0", "K > 0")
                     .replace("(int)cudaErrorInvalidValue", "0"))],
                   [("  quantize_row<TX, kQ, 32, kThreads>(x, nullptr, K, 0.f, row);\n", "")]]
K11_NO_COLUMNS = [K1_NO_COLUMNS[1], K1_NO_COLUMNS[0]]
K11_VARIANTS = {
    "no_columns": K11_NO_COLUMNS,
    "no_prologue": K11_NO_PROLOGUE,
    "bare": [K11_NO_COLUMNS[0] + K11_NO_PROLOGUE[0], K11_NO_COLUMNS[1] + K11_NO_PROLOGUE[1]],
    "no_pdl": [NO_PDL[0] + [_rebuilt("launch_matvec(w4a8dd_kernel")]],
    "serial": [SERIAL],
    "one_block": [ONE_BLOCK[0] + [_rebuilt("wave_cols(N, sms, kWarps)")]],
}

KERNELS = {
    "k1": Kernel("q4k_matvec", "zt_q4k_matvec", "q4k_matvec_kernel", K1_VARIANTS,
                 ("no_pdl", "no_cluster", "serial", "one_block")),
    "k4": Kernel("int8_matvec", "zt_int8_matvec", "int8_matvec_kernel", K4_VARIANTS, ()),
    "k2": Kernel("attn_decode", "zt_attn_decode_qkv", "attn_decode_qkv_kernel", K2_VARIANTS,
                 ("no_pdl",)),
    "k12": Kernel("q4k_matvec_hbm", "zt_q4k_matvec_hbm", "q4k_matvec_hbm_kernel", K12_VARIANTS,
                  ()),
    "k11": Kernel("w4a8dd_matvec", "zt_w4a8dd_matvec", "w4a8dd_kernel", K11_VARIANTS, ()),
}


def variant_sources(kern: Kernel, name: str) -> dict[str, str] | None:
    """{file: text} of the sources variant `name` changes, or None if no
    alternative fits them."""
    source = cuda.SOURCES[kern.lib]
    for alt in kern.variants[name]:
        edits = [e if len(e) == 3 else (source, *e) for e in alt]
        texts = {f: (cuda.CSRC / f).read_text() for f, _, _ in edits}
        if all(texts[f].count(old) == 1 for f, old, _ in edits):
            for f, old, new in edits:
                texts[f] = texts[f].replace(old, new)
            return texts
    return None


def registers(log: str, entry: str) -> list[int]:
    """The register counts `-Xptxas -v` reports for the kernel's entry points."""
    out, inside = [], False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            inside = entry in m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and inside:
            out.append(int(m.group(1)))
    return out


def build(kern: Kernel, argtypes) -> dict[str, tuple]:
    """Each applicable variant's entry point, built in parallel:
    {name: (fn, registers, library)}."""
    procs = {}
    source = cuda.SOURCES[kern.lib]
    for name in ("as_is", *kern.variants):
        texts = {} if name == "as_is" else variant_sources(kern, name)
        if texts is None:
            continue
        d = OUT / kern.lib / name
        d.mkdir(parents=True, exist_ok=True)
        for f in cuda.CSRC.glob("*.cu*"):
            (d / f.name).write_text(texts.get(f.name) or f.read_text())
        cmd = [cuda.nvcc(), *cuda.NVCC_FLAGS, "-o", str(d / "k.so"), str(d / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(OUT / kern.lib / name / "k.so"))
        fn = getattr(lib, kern.symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = (fn, registers(log, kern.entry), lib)
    return fns


def graph_ms(fn, reps: int = 20) -> float:
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
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _weights(g: torch.Generator):
    def u8(n, cols, hi=256):
        return torch.randint(0, hi, (n, cols), dtype=torch.uint8, device="cuda", generator=g)

    def half(n, cols):
        return (torch.randn(n, cols, device="cuda", generator=g) * 0.001).half()

    def q4k(k, n):
        return Q4KWeight((k, n), qs=u8(n, k // 2), sc=u8(n, k // 32, 64), mn=u8(n, k // 32, 64),
                         d=half(n, k // 256), dmin=half(n, k // 256))

    def q6k(k, n):
        return Q6KWeight((k, n), ql=u8(n, k // 2), qh=u8(n, k // 4), a=half(n, k // 16))

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, device="cuda", generator=g) * scale).to(dtype)

    return q4k, q6k, randn


def _legacy_weights(g: torch.Generator):
    """Random Q4_0 and Q4_1 weights (k, n) -> weight."""
    def u8(n, cols):
        return torch.randint(0, 256, (n, cols), dtype=torch.uint8, device="cuda", generator=g)

    def half(n, cols):
        return (torch.randn(n, cols, device="cuda", generator=g) * 0.001).half()

    return (lambda k, n: Q40Weight((k, n), qs=u8(n, k // 2), d=half(n, k // 32)),
            lambda k, n: Q41Weight((k, n), qs=u8(n, k // 2), a=half(n, k // 32),
                                   b=half(n, k // 32)))


def olmo2_calls(mk, randn):
    """An OLMo-2-0425-1B decode step's 65 matvecs [(x, w, fuse, aux)] with
    weights from `mk(k, n)`: 16 x [wqkv, wo, gate|up, down] (fuse q on the
    raw stream, as its layers take them), then the head with the final
    norm."""
    x_o, x_ff = randn(1, 2048, scale=3.0), randn(1, 8192)
    calls = []
    for _ in range(16):
        calls += [(x_o, mk(2048, 6144), "q", None), (x_o, mk(2048, 2048), "q", None),
                  (x_o, mk(2048, 16384), "q", None), (x_ff, mk(8192, 2048), "q", None)]
    calls.append((x_o, mk(2048, 100352), "norm", randn(2048).abs() + 0.5))
    return calls


def k12_calls(g: torch.Generator):
    """K12's calls: the TinyLlama Q4_K step's 89, the OLMo-2 Q4_K step's 65,
    the OLMo-2 Q4_1 step's 65; roles: each step, and the two Q4_K steps by
    weight role."""
    q4k, _, randn = _weights(g)
    _, q41 = _legacy_weights(g)
    tiny, _ = k1_calls(g)
    o4k, o41 = olmo2_calls(q4k, randn), olmo2_calls(q41, randn)
    calls = tiny + o4k + o41
    a, b = len(tiny), len(tiny) + len(o4k)
    roles = {"tinyllama_q4k": list(range(a)), "olmo2_q4k": list(range(a, b)),
             "olmo2_q4_1": list(range(b, len(calls)))}
    for i, role in enumerate(("wqkv", "wo", "gate_up", "down")):
        roles[f"olmo2_q4k_{role}"] = list(range(a + i, b - 1, 4))
    roles["olmo2_q4k_head"] = [b - 1]
    for i, role in enumerate(("wqkv", "wo", "gate_up", "down")):
        roles[f"tinyllama_{role}"] = list(range(i, a - 1, 4))
    roles["tinyllama_head"] = [a - 1]
    return calls, roles


def k11_calls(g: torch.Generator):
    """K11's calls [(x, w)]: the OLMo-2 Q4_1 step's 64 fuse-q matvecs, then
    the 22 wo matvecs (2048->2048) of a TinyLlama Q4_0 step; and the two
    sets as roles."""
    _, _, randn = _weights(g)
    q40, q41 = _legacy_weights(g)
    calls = [(x, w) for x, w, fuse, _ in olmo2_calls(q41, randn) if fuse == "q"]
    n_o = len(calls)
    x_att = randn(1, 2048)
    calls += [(x_att, q40(2048, 2048)) for _ in range(22)]
    return calls, {"olmo2_q4_1": list(range(n_o)), "q4_0_wo": list(range(n_o, len(calls)))}


def k1_calls(g: torch.Generator):
    """The Q4_K step's 89 calls [(x, w, fuse, aux)] in launch order, and
    their roles."""
    q4k, _, randn = _weights(g)
    x_res, x_att, x_gup = randn(1, 2048, scale=3.0), randn(1, 2048), randn(1, 2 * 5632)
    calls = []
    for _ in range(22):
        calls += [(x_res, q4k(2048, 2560), "norm", randn(2048).abs() + 0.5),
                  (x_att, q4k(2048, 2048), "q", None),
                  (x_res, q4k(2048, 11264), "norm", randn(2048).abs() + 0.5),
                  (x_gup, q4k(5632, 2048), "glu", None)]
    calls.append((x_res, q4k(2048, 32768), "norm", randn(2048).abs() + 0.5))
    roles = {role: list(range(i, len(calls) - 1, 4))
             for i, role in enumerate(("wqkv", "wo", "gate_up", "down"))}
    roles["head"] = [len(calls) - 1]
    return calls, roles


def k4_calls(g: torch.Generator):
    """The Q4_K_M step's 34 Q6_K calls [(x, w, fuse, aux)] in launch order
    (wv a layer, down in the first 11, then the head), and their roles."""
    _, q6k, randn = _weights(g)
    x_h = randn(1, 2048, dtype=torch.bfloat16)
    x_gup, x_res = randn(1, 2 * 5632), randn(1, 2048, scale=3.0, dtype=torch.bfloat16)
    calls = []
    for il in range(22):
        calls.append((x_h, q6k(2048, 256), "q", None))
        if il < 11:
            calls.append((x_gup, q6k(5632, 2048), "glu", None))
    calls.append((x_res, q6k(2048, 32768), "norm", randn(2048).abs() + 0.5))
    roles = {"wv": [i for i, c in enumerate(calls) if c[2] == "q"],
             "down": [i for i, c in enumerate(calls) if c[2] == "glu"],
             "head": [len(calls) - 1]}
    return calls, roles


def k2_calls(g: torch.Generator):
    """The 22 attention blocks of a TinyLlama decode step (B 1, pos 331,
    S 2048) and of a contiguous engine step (B 4, S 2176, a trash row),
    each layer its own caches: [(qkv3, kc, vc, pos, rope)], and the roles."""
    from .ops.layers import RopeParams, rope_table

    _, _, randn = _weights(g)
    calls, roles = [], {"step": [], "engine": []}
    for role, pos_vals, s in (("step", [331], 2048), ("engine", [255, 0, 300, 2176], 2176)):
        b = len(pos_vals)
        pos = torch.tensor(pos_vals, dtype=torch.int32, device="cuda")
        rope = rope_table(pos, RopeParams(dim=64, style="neox"), 64)
        qkv3 = randn(b, 40, 64)
        for _ in range(22):
            roles[role].append(len(calls))
            calls.append((qkv3, randn(b, 4, s, 64, dtype=torch.bfloat16),
                          randn(b, 4, s, 64, dtype=torch.bfloat16), pos, rope))
    return calls, roles


def _swap(kern: Kernel, build_):
    """Route the wrapper's launches to a variant's build `(fn, registers,
    library)`: its entry point, and every other entry point of the kernel's
    library the wrapper has bound (K11's earlier form: its quantize
    launch)."""
    fn, _, lib = build_
    for (name, symbol), real in list(cuda._FNS.items()):
        if name == kern.lib and symbol != kern.symbol:
            other = getattr(lib, symbol)
            other.argtypes, other.restype = real.argtypes, real.restype
            cuda._FNS[(name, symbol)] = other
    cuda._FNS[(kern.lib, kern.symbol)] = fn


def _setup(name: str):
    """(kernel, its calls, their roles, a runner (fn, indices) -> closure,
    the entry point's argtypes), the real library bound once."""
    kern = KERNELS[name]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    if name == "k1":
        calls, roles = k1_calls(g)

        def runner(build_, idx):
            def go():
                for i in idx:
                    cuda.check(qmm.nibble_matvec_call(build_[0], *calls[i], 1e-5)[0],
                               "k1_ablation")
            return go
        return kern, calls, roles, runner, qmm.NIBBLE_MATVEC_ARGTYPES
    if name == "k4":
        calls, roles = k4_calls(g)

        def one(i):
            qmm.int8_matvec(*calls[i], 1e-5)
    elif name == "k12":
        calls, roles = k12_calls(g)

        def one(i):
            qmm.q4k_matvec_hbm(*calls[i], 1e-5)
    elif name == "k11":
        calls, roles = k11_calls(g)

        def one(i):
            qmm.w4a8dd_matvec(*calls[i])
    else:
        calls, roles = k2_calls(g)

        def one(i):
            qkv3, kc, vc, pos, rope = calls[i]
            att.attn_decode_qkv(qkv3, kc, vc, pos, rope, scale=0.125, eps=1e-5)
    one(0)  # builds and binds the real library: its argtypes are the entry point's
    argtypes = cuda._FNS[(kern.lib, kern.symbol)].argtypes

    def runner(build_, idx):
        def go():
            _swap(kern, build_)
            for i in idx:
                one(i)
        return go
    return kern, calls, roles, runner, argtypes


def step_graph(kern: Kernel, fns: dict, card: str):
    """The decode step's graph-replay ms with each right-valued build of the
    kernel (see the module note)."""
    import numpy as np

    from .gguf.constants import GGMLType
    from .models.llama import forward
    from .models.loader import Model
    from .runtime.generate import Generator
    from .testing import TINYLLAMA_SHAPE, make_llama_gguf

    path = OUT / "tinyllama_q4_k.gguf"
    if not path.exists():
        make_llama_gguf(str(path), **TINYLLAMA_SHAPE, gtype=GGMLType.Q4_K, seed=0)
    model = Model.load(str(path), device="cuda", dtype=torch.bfloat16)
    gen = Generator(model, max_len=2048, prefill_chunk=256)
    ids = np.random.default_rng(0).integers(3, model.cfg.vocab_size, 300).tolist()
    gen.prefill(ids)
    tok = torch.tensor([[ids[-1]]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([[331]], dtype=torch.int32, device="cuda")

    def step():
        with torch.inference_mode():
            forward(model.params, model.cfg, tok, pos, gen.kv, logits_for="last")

    for name in ("as_is", *[v for v in kern.step_variants if v in fns], "as_is"):
        _swap(kern, fns[name])
        print(json.dumps({"kernel": kern.lib, "variant": name, "card": card,
                          "step_graph_ms": graph_ms(step)}), flush=True)


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("k1_ablation: needs a CUDA GPU")
    which = argv[argv.index("--kernel") + 1] if "--kernel" in argv else "k1"
    if which not in KERNELS:
        sys.exit(f"k1_ablation: --kernel takes {sorted(KERNELS)}, not {which}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else torch.cuda.get_device_name(0))
    kern, calls, roles, runner, argtypes = _setup(which)
    fns = build(kern, argtypes)
    if "--step" in argv:
        if not kern.step_variants:
            sys.exit(f"k1_ablation: --step times k1 or k2, not {which}")
        return step_graph(kern, fns, card)
    missing = [name for name in kern.variants if name not in fns]
    for name in ("as_is", *[v for v in kern.variants if v in fns], "as_is"):
        regs = fns[name][1]
        total = graph_ms(runner(fns[name], range(len(calls))))
        print(json.dumps({"kernel": kern.lib, "variant": name, "card": card, "step_ms": total,
                          "us_per_launch": total * 1e3 / len(calls),
                          "ms_by_role": {r: graph_ms(runner(fns[name], idx))
                                         for r, idx in roles.items()},
                          "registers": regs, "not_in_this_source": missing}), flush=True)
    _swap(kern, fns["as_is"])
    if which == "k11":
        print(json.dumps({"kernel": kern.lib, "variant": "apart", "card": card,
                          **k11_apart(calls, roles)}), flush=True)
    if which in ("k12", "k11"):
        def k1(idx):
            def go():
                for i in idx:
                    x, w, *rest = calls[i]
                    qmm.q4k_matvec(x, w, *rest, *([1e-5] if rest else []))
            return go
        print(json.dumps({"kernel": "q4k_matvec", "variant": "k1_same_calls", "card": card,
                          "step_ms": graph_ms(k1(range(len(calls)))),
                          "ms_by_role": {r: graph_ms(k1(idx)) for r, idx in roles.items()}}),
              flush=True)


# the earlier K11 dot's C arguments: fmt, xq, dx, e, qs, s0, s1, y, K, N, stream
TWO_LAUNCH_DOT_ARGS = 11


def k11_apart(calls, roles) -> dict:
    """K11's quantize (`zt_quantize_acts`, one block) timed alone on each
    call's row and, where the library's dot takes a row quantized
    beforehand (the earlier two-launch form), the dot alone: graph ms by
    role."""
    xs = [x for x, _ in calls]
    out = {"quantize_launch_ms_by_role": {
        r: graph_ms(lambda idx=idx: [qmm.quantize_acts(xs[i]) for i in idx])
        for r, idx in roles.items()}}
    dot = cuda._FNS[("w4a8dd_matvec", "zt_w4a8dd_matvec")]
    if len(dot.argtypes) != TWO_LAUNCH_DOT_ARGS:
        out["dot_launch_ms_by_role"] = "one launch a call: no dot launch of its own"
        return out
    rows = [qmm.quantize_acts(x) for x in xs]
    ys = [torch.empty((1, w.shape[1]), dtype=torch.float32, device="cuda") for _, w in calls]

    def dots(idx):
        for i in idx:
            (xq, dx, e), (_, w) = rows[i], calls[i]
            k, n = w.shape
            cuda.check(dot(qmm.NIBBLE_FMT_CODE[w.fmt], xq.data_ptr(), dx.data_ptr(),
                           e.data_ptr(), *qmm._plane_ptrs(w, 3), ys[i].data_ptr(), k, n,
                           cuda.stream()), "k11 dot")
    out["dot_launch_ms_by_role"] = {r: graph_ms(lambda idx=idx: dots(idx))
                                    for r, idx in roles.items()}
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
