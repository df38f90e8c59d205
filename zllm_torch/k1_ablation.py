"""What each part of K1, the decode matvec of the nibble formats
(`csrc/q4k_matvec.cu`), costs on the card: the source built as it is and
again with one part taken out, each build timed on the 89 matvecs of a
TinyLlama-geometry Q4_K decode step (22 x [wqkv norm 2048->2560, wo q
2048->2048, gate|up norm 2048->11264, down glu 5632->2048] + the head norm
2048->32768), random weight bytes from a seed, f32 activations:
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
A variant whose anchor text the source lacks (an older K1) is reported as
such.  The variants compute wrong values; only their times mean anything.

Run on a CUDA host from the root of a checkout:
    python -m zllm_torch.k1_ablation
Prints one JSON line per build, the unchanged one first and last: the
graph-replay device ms of the 89-launch step, of each role's launches
alone (22 each, the head 1), and the registers of the build's K1
instantiations (`-Xptxas -v`).
    python -m zllm_torch.k1_ablation --step
times instead a whole decode step with the builds that compute right
values (as it is, no_pdl, no_cluster, serial, one_block): a TinyLlama
Q4_K model (random weights, seed 0) prefilled with 300 tokens, one B = 1
step's forward at position 331 captured in a CUDA graph and replayed, so
K1 runs beside K2 and the torch ops as a real step interleaves them."""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

from .ops import cuda
from .ops import qmatmul as qmm
from .quant.repack import Q4KWeight

OUT = cuda.CACHE.parent / "k1_ablation"
SOURCE = "q4k_matvec.cu"

# variant -> alternatives, each a list of (text, replacement) applied to
# q4k_matvec.cu, or (file, text, replacement) to another source; the first
# alternative whose texts all occur is taken (the later ones fit K1's
# earlier form: 8 warps, one column in flight)
NO_COLUMNS = [[("const int nu = ncols * upc;", "const int nu = 0 * ncols * upc;")],
              [("  if (n0 < N) fetch_col(cr, w, n0, K, 0, lane);",
                "  if (0) fetch_col(cr, w, n0, K, 0, lane);"),
               ("for (int j = 0; j < cols_per_warp; ++j) {", "for (int j = 0; j < 0; ++j) {")]]
NO_PROLOGUE = [[("    quantize_row<TX, MODE, 32, kThreads>(x, aux, K, eps, row);\n", ""),
                ("    quantize_glu_cluster<TX>(x, K, row);\n",
                 '    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");\n')],
               [("  quantize_row<TX, MODE, 32, kThreads>(x, aux, K, eps, row);\n", "")]]
VARIANTS = {
    "no_columns": NO_COLUMNS,
    "no_prologue": NO_PROLOGUE,
    "bare": [a + b for a in NO_COLUMNS for b in NO_PROLOGUE],
    "serial": [[("  fetch(cb, 1);\n", ""),
                ("    dots(ca, u);\n    fetch(ca, u + 2);\n    dots(cb, u + 1);\n"
                 "    fetch(cb, u + 3);\n",
                 "    if (u > 0) fetch(ca, u);\n    dots(ca, u);\n    fetch(cb, u + 1);\n"
                 "    dots(cb, u + 1);\n")]],
    "no_pdl": [[("attr[na].val.programmaticStreamSerializationAllowed = 1;",
                 "attr[na].val.programmaticStreamSerializationAllowed = 0;")]],
    "no_cluster": [[("  const int cl = MODE == kGlu ? glu_cluster(K) : 1;",
                     "  const int cl = 1;")]],
    "one_block": [[("  const int cpw = (N + 2 * sms * kWarps - 1) / (2 * sms * kWarps);",
                    "  const int cpw = (N + sms * kWarps - 1) / (sms * kWarps);")]],
    "glu_no_exp": [[("matvec_common.cuh", "return gg * (1.f / (1.f + expf(-gg))) * u;",
                     "return gg * u;")]],
    "no_div": [[("matvec_common.cuh", "rintf(v[i] / dx)", "rintf(v[i] * dx)")]],
    "trigger_late": [[("  launch_dependents();\n  if (MODE == kGlu)", "  if (MODE == kGlu)"),
                      ("    fetch(cb, u + 3);\n  }\n", "    fetch(cb, u + 3);\n  }\n  launch_dependents();\n")]],
}
ROLES = ("wqkv", "wo", "gate_up", "down")
STEP_VARIANTS = ("no_pdl", "no_cluster", "serial", "one_block")


def variant_sources(name: str) -> dict[str, str] | None:
    """{file: text} of the sources variant `name` changes, or None if no
    alternative fits them."""
    for alt in VARIANTS[name]:
        edits = [e if len(e) == 3 else (SOURCE, *e) for e in alt]
        texts = {f: (cuda.CSRC / f).read_text() for f, _, _ in edits}
        if all(texts[f].count(old) == 1 for f, old, _ in edits):
            for f, old, new in edits:
                texts[f] = texts[f].replace(old, new)
            return texts
    return None


def registers(log: str) -> list[int]:
    """The register counts `-Xptxas -v` reports for the K1 entry points."""
    out, in_k1 = [], False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            in_k1 = "q4k_matvec_kernel" in m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and in_k1:
            out.append(int(m.group(1)))
    return out


def build() -> dict[str, tuple]:
    """Each applicable variant's zt_q4k_matvec, built in parallel:
    {name: (fn, registers)}."""
    procs = {}
    for name in ("as_is", *VARIANTS):
        texts = {} if name == "as_is" else variant_sources(name)
        if texts is None:
            continue
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in cuda.CSRC.glob("*.cu*"):
            (d / f.name).write_text(texts.get(f.name) or f.read_text())
        cmd = [cuda.nvcc(), *cuda.NVCC_FLAGS, "-o", str(d / "k1.so"), str(d / SOURCE)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        fn = ctypes.CDLL(str(OUT / name / "k1.so")).zt_q4k_matvec
        fn.argtypes = qmm.NIBBLE_MATVEC_ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = (fn, registers(log))
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


def step_calls(g: torch.Generator):
    """The step's 89 calls [(x, w, fuse, aux)] in launch order."""
    def u8(n, cols, hi=256):
        return torch.randint(0, hi, (n, cols), dtype=torch.uint8, device="cuda", generator=g)

    def half(n, cols):
        return (torch.randn(n, cols, device="cuda", generator=g) * 0.001).half()

    def q4k(k, n):
        return Q4KWeight((k, n), qs=u8(n, k // 2), sc=u8(n, k // 32, 64), mn=u8(n, k // 32, 64),
                         d=half(n, k // 256), dmin=half(n, k // 256))

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    x_res, x_att, x_gup = randn(1, 2048, scale=3.0), randn(1, 2048), randn(1, 2 * 5632)
    calls = []
    for _ in range(22):
        calls += [(x_res, q4k(2048, 2560), "norm", randn(2048).abs() + 0.5),
                  (x_att, q4k(2048, 2048), "q", None),
                  (x_res, q4k(2048, 11264), "norm", randn(2048).abs() + 0.5),
                  (x_gup, q4k(5632, 2048), "glu", None)]
    calls.append((x_res, q4k(2048, 32768), "norm", randn(2048).abs() + 0.5))
    return calls


def step_graph(fns: dict, card: str):
    """The decode step's graph-replay ms with each right-valued build's K1
    (see the module note)."""
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

    for name in ("as_is", *[v for v in STEP_VARIANTS if v in fns], "as_is"):
        cuda._FNS[("q4k_matvec", "zt_q4k_matvec")] = fns[name][0]
        print(json.dumps({"variant": name, "card": card,
                          "step_graph_ms": graph_ms(step)}), flush=True)


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("k1_ablation: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else torch.cuda.get_device_name(0))
    fns = build()
    if "--step" in argv:
        return step_graph(fns, card)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    calls = step_calls(g)
    roles = {role: list(range(i, len(calls) - 1, 4)) for i, role in enumerate(ROLES)}
    roles["head"] = [len(calls) - 1]

    def run(fn, idx):
        def go():
            for i in idx:
                cuda.check(qmm.nibble_matvec_call(fn, *calls[i], 1e-5)[0], "k1_ablation")
        return go

    missing = [name for name in VARIANTS if name not in fns]
    for name in ("as_is", *[v for v in VARIANTS if v in fns], "as_is"):
        fn, regs = fns[name]
        step = graph_ms(run(fn, range(len(calls))))
        print(json.dumps({"variant": name, "card": card, "step_ms": step,
                          "us_per_launch": step * 1e3 / len(calls),
                          "ms_by_role": {r: graph_ms(run(fn, idx)) for r, idx in roles.items()},
                          "registers": regs,
                          "not_in_this_source": missing}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
