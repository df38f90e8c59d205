"""Where the time of the one-launch cluster decode step
(`csrc/decode_cluster.cuh`) goes on the card, at the serving path's decode
shapes: K7's split form over the q8 cache (int8 codes, f32 scales) and over
bf16 K/V, and K9 over bf16 pools, 22 layers each, 4 rows at positions 255,
0, 300 and the trash row 2048 (K7: S 2176; K9: 16 pages of 128, scrambled),
32/4 heads of 64, f32 q, random data from a seed; and K8 at its two
chip_smoke.py shapes: an OLMo-2 decode step (16 layers, B 1, 16/16 heads of
128, a bf16 cache of 2048 slots, pos 331) and a TinyLlama-geometry
contiguous engine step (22 layers, the rows above, S 2176, bf16 cache).

    python -m zllm_torch.decode_cluster_ablation
builds the header as it is and again with one part taken out of its source
(`no_chunk`: every block gets no chunk, so the launch keeps only its fixed
part -- the prologue's loads, the three cluster barriers, the DSMEM reads;
`no_score_mma`, `no_pv_mma`: phase 1's or phase 2's tensor-core products
left out), and prints one JSON line of graph-replay device ms a step for
each, the unchanged build first and last.  The variants compute wrong
values; only their times mean anything.

    python -m zllm_torch.decode_cluster_ablation --timeline
builds a copy that stamps %globaltimer at each phase and prints, for one
eager K7 call (int8, then bf16), the ns from each block's start to the end
of each phase for the trash row's cluster (kv head 0).

    python -m zllm_torch.decode_cluster_ablation --against OTHER/zllm_torch/csrc
builds K9 (`paged_decode.cu`) from this checkout's sources and from
another checkout's (say the parent commit, unpacked with `git archive`)
and times K9's f16 form (f32 q, f16 pools; the serve step above at head_dim
64, and 16 layers of 16/16 heads of 128) and its bf16 form (the control:
the same work in both trees) in the order this, other, other, this, ROUNDS
times: one JSON line a run, then each tree's per-run ms and their spread.

    python -m zllm_torch.decode_cluster_ablation --k9-shared-q
the same, `other` a copy of this checkout's sources whose K9 f16 form
keeps q's fragments in shared memory as K8's f16 form does (K9_SHARED_Q),
where the header keeps them in registers."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from .ops import attention as att
from .ops import cuda

OUT = cuda.CACHE.parent / "decode_cluster_ablation"
CSRC = cuda.CSRC  # the checkout's sources, copied for each variant
HEADER = "decode_cluster.cuh"

# variant -> (text, replacement)
VARIANTS = {
    "no_chunk": ("const int m = max(0, min(per, n - my0));",
                 "const int m = 0 * max(0, min(per, n - my0));"),
    "no_score_mma": ("            Tc<TT>::mma(cp[pt], a, qb[ks][pt]);",
                     "            if (0) Tc<TT>::mma(cp[pt], a, qb[ks][pt]);"),
    "no_pv_mma": ("          Tc<TT>::mma(tacc[mt], av, pb[0]);\n          if constexpr (NP > 1) {",
                  "          if (0) Tc<TT>::mma(tacc[mt], av, pb[0]);\n          if constexpr (0) {"),
}
ROUNDS = 3  # of this, other, other, this in --against
# the header with K9's f16 form on K8's shared-memory q fragments
K9_SHARED_Q = (("constexpr bool kQsm = kF16 && KV::kRound == kRoundNorm;",
                "constexpr bool kQsm = kF16;"),
               ("+ (zt_mma::IsF16<TKV>::value && ROUND == kRoundNorm",
                "+ (zt_mma::IsF16<TKV>::value"))

PHASES = ("prologue", "phase1", "barrier1", "exchange", "phase2", "reduce", "barrier2", "end")


def timeline_source(src: str) -> str:
    """The header with a %globaltimer stamp after each phase; block 0's
    output replaced by each block's stamps (16 floats a block of the row's
    kv head 0, ns from the block's start) and its chunk count."""
    def stamp(text, anchor, k, after=False):
        assert text.count(anchor) == 1, anchor
        line = f"  if (tid == 0) tstamp[{k}] = gtime();\n"
        return text.replace(anchor, anchor + line if after else line + anchor)

    src = src.replace("namespace zt_dc {\n", "namespace zt_dc {\n__device__ __forceinline__ "
                      "unsigned long long gtime() {\n  unsigned long long t;\n  asm volatile("
                      "\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n  return t;\n}\n", 1)
    src = stamp(src, "  cg::cluster_group cluster = cg::this_cluster();\n", 0)
    src = src.replace("  if (tid == 0) tstamp[0] = gtime();\n",
                      "  unsigned long long tstamp[9];\n  if (threadIdx.x == 0) tstamp[0] = gtime();\n")
    src = stamp(src, "  // ---- phase 1: scores and chunk statistics", 1)
    src = stamp(src, "  cluster.sync();\n\n  // ---- the row's max", 2)
    src = stamp(src, "  // ---- the row's max", 3)
    src = stamp(src, "  // ---- phase 2: probabilities, then P.V", 4)
    src = stamp(src, "  cp_async_wait<0>();\n  __syncthreads();  // every warp", 5)
    src = stamp(src, "  cluster.sync();\n\n  // ---- block 0:", 6)
    src = stamp(src, "  // ---- block 0:", 7)
    out = "      static_cast<TQ*>(p.out)[(((size_t)b * p.T + r / G) * p.Hq + h * G + g) * D + e % D] =\n" \
          "          from_f<TQ>(l > 0.f ? o / l : 0.f);"
    assert src.count(out) == 1
    src = src.replace(out, "      (void)o;\n      (void)l;")
    end = "  cluster.sync();  // the peers' shared memory lives until block 0 has read it\n"
    assert src.count(end) == 1
    return src.replace(end, end + """  if (tid == 0) {
    tstamp[8] = gtime();
    float* o = static_cast<float*>(p.out) + ((size_t)b * p.Hq + h * G) * D + rank * 16;
    for (int k = 1; k < 9; ++k) o[k - 1] = (float)(tstamp[k] - tstamp[0]);
    o[8] = (float)m;
  }
""")


def use_build(name: str, src: str):
    """Point ops/cuda.py at a copy of csrc/ whose header is `src`, built."""
    tree = OUT / name / "csrc"
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(CSRC, tree)
    (tree / HEADER).write_text(src)
    cuda.CSRC, cuda.CACHE = tree, OUT / name / "kernels"
    cuda._LIBS.clear()
    cuda._FNS.clear()
    cuda.build(["attn_blockwise", "paged_decode", "attn_decode_update"])


def use_tree(name: str, csrc: Path):
    """Point ops/cuda.py at the sources in `csrc`, K9 built into a cache of
    its own (once: a later call loads the built library again)."""
    cuda.CSRC, cuda.CACHE = csrc, OUT / name / "kernels"
    cuda._LIBS.clear()
    cuda._FNS.clear()
    cuda.build(["paged_decode"])


def k9_f16_inputs():
    """K9's serve-step inputs over f16 pools: (q, k/v_new, positions, table,
    pools of each layer, page size) at head_dim 64 (22 layers, 32/4 heads)
    and 128 (16 layers, 16/16 heads), 4 rows at 255, 0, 300 and the trash
    row 2048, 16 pages of 128 a row, scrambled; random data from a seed."""
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    b, ps, lp = 4, 128, 16
    n_pages = b * lp + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(2)) + 1
    table = torch.zeros((b, lp + 1), dtype=torch.int32)
    table[:, :lp] = perm.reshape(b, lp).to(torch.int32)
    pos = torch.tensor([[255], [0], [300], [2048]], dtype=torch.int32, device="cuda")
    out = {}
    for d, hq, hkv, layers in ((64, 32, 4, 22), (128, 16, 16, 16)):
        def randn(*shape, dtype=torch.float32):
            return torch.randn(*shape, generator=g, device="cuda").to(dtype)

        pools = [(randn(hkv, n_pages * ps, d, dtype=torch.float16),
                  randn(hkv, n_pages * ps, d, dtype=torch.float16)) for _ in range(layers)]
        out[d] = (randn(b, 1, hq, d), randn(b, 1, hkv, d), pos, table.to("cuda"), pools, ps)
    return out


def against(other: Path, card: str, bf16_step):
    """K9's f16 form built from this checkout's sources and from `other`'s,
    timed in the order this, other, other, this, ROUNDS times (see the
    module's docstring); `bf16_step` times K9's bf16 form, the control."""
    inputs = k9_f16_inputs()

    def k9_f16(d):
        q, kn, pos, table, pools, ps = inputs[d]

        def go():
            for kp, vp in pools:
                att.paged_attn_decode_update(q, kn, kn, kp, vp, table, pos, page_size=ps,
                                             scale=d ** -0.5)
        return go

    trees = {"this": CSRC, "other": other}
    runs = {name: [] for name in trees}
    for name in ("this", "other", "other", "this") * ROUNDS:
        use_tree(name, trees[name])
        run = {"k9_f16_d64_step_ms": graph_ms(k9_f16(64)),
               "k9_f16_d128_step_ms": graph_ms(k9_f16(128)),
               "k9_bf16_step_ms": graph_ms(bf16_step)}
        runs[name].append(run)
        print(json.dumps({"tree": name, "csrc": str(trees[name]), "card": card, **run}),
              flush=True)
    summary = {}
    for key in runs["this"][0]:
        per = {name: [r[key] for r in rs] for name, rs in runs.items()}
        summary[key] = {**per, "this_over_other": min(per["this"]) / min(per["other"]),
                        "spread_this": max(per["this"]) / min(per["this"]) - 1,
                        "spread_other": max(per["other"]) / min(per["other"]) - 1}
    print(json.dumps({"against": str(other), "card": card, "rounds": ROUNDS, **summary}),
          flush=True)


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms of fn(): captured once in a CUDA graph, replayed `reps`
    times between two events."""
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


def inputs(layers: int = 22):
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    b, hq, hkv, d, s, ps, lp = 4, 32, 4, 64, 2176, 128, 16

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    def codes():
        return torch.randint(-127, 128, (b, hkv, s, d), generator=g, device="cuda",
                             dtype=torch.int8)

    q = randn(b, 1, hq, d)
    pos = torch.tensor([[255], [0], [300], [2048]], dtype=torch.int32, device="cuda")
    int8 = [(codes(), codes(), randn(b, hkv, s, 1).abs() * 0.01 + 1e-3,
             randn(b, hkv, s, 1).abs() * 0.01 + 1e-3) for _ in range(layers)]
    bf16 = [(randn(b, hkv, s, d, dtype=torch.bfloat16), randn(b, hkv, s, d, dtype=torch.bfloat16),
             None, None) for _ in range(layers)]
    n_pages = b * lp + 1
    pools = [(randn(hkv, n_pages * ps, d, dtype=torch.bfloat16),
              randn(hkv, n_pages * ps, d, dtype=torch.bfloat16)) for _ in range(layers)]
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(2)) + 1
    table = torch.zeros((b, lp + 1), dtype=torch.int32)
    table[:, :lp] = perm.reshape(b, lp).to(torch.int32)
    kn = randn(b, 1, hkv, d)
    # K8: (q, k/v_new, positions, caches of each layer)
    k8 = {"olmo2": (randn(1, 1, 16, 128), randn(1, 1, 16, 128),
                    torch.tensor([[331]], dtype=torch.int32, device="cuda"),
                    [(randn(1, 16, 2048, 128, dtype=torch.bfloat16),
                      randn(1, 16, 2048, 128, dtype=torch.bfloat16)) for _ in range(16)]),
          "engine": (q, kn, pos, [(randn(b, hkv, s, d, dtype=torch.bfloat16),
                                   randn(b, hkv, s, d, dtype=torch.bfloat16))
                                  for _ in range(layers)])}
    return q, pos, int8, bf16, pools, table.to("cuda"), kn, ps, k8


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("decode_cluster_ablation: needs a CUDA GPU")
    q, pos, int8, bf16, pools, table, kn, ps, k8_inputs = inputs()
    src = (CSRC / HEADER).read_text()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else torch.cuda.get_device_name(0))

    def k7(kvs):
        def go():
            for k, v, ks, vs in kvs:
                att.flash_attention_blockwise(q, k, v, pos, scale=0.125, ks=ks, vs=vs)
        return go

    def k9():
        for kp, vp in pools:
            att.paged_attn_decode_update(q, kn, kn, kp, vp, table, pos, page_size=ps, scale=0.125)

    def k8(shape):
        q8, kn8, pos8, caches = k8_inputs[shape]
        scale = q8.shape[-1] ** -0.5

        def go():
            for kc, vc in caches:
                att.attn_decode_update(q8, kn8, kn8, kc, vc, pos8, scale=scale)
        return go

    if "--against" in argv:
        against(Path(argv[argv.index("--against") + 1]).resolve(), card, k9)
        return
    if "--k9-shared-q" in argv:
        text = src
        for old, new in K9_SHARED_Q:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        tree = OUT / "k9_shared_q" / "csrc"
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(CSRC, tree)
        (tree / HEADER).write_text(text)
        against(tree, card, k9)
        return
    if "--timeline" in argv:
        use_build("timeline", timeline_source(src))
        for name, kvs in (("int8", int8), ("bf16", bf16)):
            k, v, ks, vs = kvs[0]
            for _ in range(5):
                out = att.flash_attention_blockwise(q, k, v, pos, scale=0.125, ks=ks, vs=vs)
            torch.cuda.synchronize()
            row = out.reshape(4, 4, -1)[3, 0].cpu()  # the trash row, kv head 0
            blocks = [dict(rank=r, chunks=int(row[r * 16 + 8]),
                           **{ph: float(row[r * 16 + i]) for i, ph in enumerate(PHASES)})
                      for r in range(8)]
            print(json.dumps({"timeline": f"K7 {name}, one eager call", "card": card,
                              "ns_from_block_start": blocks}), flush=True)
        return
    names = ["as_is", *VARIANTS, "as_is"]
    for name in names:
        text = src
        if name in VARIANTS:
            old, new = VARIANTS[name]
            assert text.count(old) == 1, name
            text = text.replace(old, new)
        use_build(name, text)
        print(json.dumps({"variant": name, "card": card,
                          "k7_int8_step_ms": graph_ms(k7(int8)),
                          "k7_bf16_step_ms": graph_ms(k7(bf16)),
                          "k9_step_ms": graph_ms(k9),
                          "k8_olmo2_step_ms": graph_ms(k8("olmo2")),
                          "k8_engine_step_ms": graph_ms(k8("engine"))}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
