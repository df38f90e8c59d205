"""The Q4_0/Q4_1 slice on the CPU, against zllm.

  * codecs: the port's Q4_0/Q4_1 decoders are bit-exact and its encoders
    byte-identical to `zllm.quant.blocks`;
  * weights: a loaded `Q40Weight`/`Q41Weight` dequantizes to zllm's decoded
    blocks exactly, and zllm's QTensors carried across by `params_from_jax`
    (npack and split-fold) hold the very same planes;
  * kernels (plain versions, f32) against zllm's Pallas kernels run with
    interpret=True on the same weight (K = N = 512): K1 (`_qmm_w4a8np_call`,
    "q", "norm", "glu"), K12 (`_qmm_w4a8np_hbm_call`), K3 (`_qmm_np_call`)
    on zllm's npack layout, and K11 (`_qmm_w4a8dd_call`, called directly
    on the split-fold QTensor with `xq2` built as zllm's qmatmul_w4a8 builds
    it, so the oracle surely runs the Pallas kernel).  All at nmse < 1e-8:
    the group dots are exact integers on both sides (K11's dual-view dots
    included) and the f32 epilogues are the same expressions, so only the
    f32 sum order differs (plus an ulp of rsqrt in "norm"); K3 rounds x and
    w to bf16 on both sides.  K11's quantize step equals zllm's
    `_quant_acts` bit for bit;
  * the dispatch of `matvec` under ZLLM_QMM_HBM and ZLLM_QMM_DUALDOT;
  * whole models: 2-layer llama and OLMo-2 files from the port's factory
    in Q4_0 and Q4_1, zllm with its kernels installed in interpret mode (K1
    for the decode matvecs, K3 for the prefill GEMMs), prefill logits and
    16 teacher-forced decode-step logits (f32 caches) and free-running
    greedy tokens, with ZLLM_QMM_DUALDOT unset and set (the port's "q"
    matvecs then take K11, whose values differ from K1's in the sum order
    only).  Logits held to nmse <= 2e-4 for llama and <= 1e-3 for OLMo-2,
    the tolerances of the Q4_K slice tests: an ulp of sum order can move one
    bf16 or int8 rounding, which then stays in the f32 cache and which
    OLMo-2's q/k norms carry on (measured up to 1.1e-4 for llama and 6.7e-4
    for OLMo-2 here).  The llama files' greedy tokens are identical to
    zllm's.  On OLMo-2's random weights two logits can lie within that
    error of each other (the Q4_1 file's step 14: a gap of 5.7e-4), so
    there the tokens must be identical up to the first step whose top two
    zllm logits lie closer than twice the step's largest logit difference;
  * the port's Engine gives zllm's tokens, counters and logits (nmse
    <= 1e-4) on a Q4_0 file in the paged, contiguous and q8 layouts (q8:
    the tokens may part once at a near tie, see test_engine_matches_zllm)."""

import time

import numpy as np
import pytest
import torch
from test_torch_oracle import SMALL_LLAMA, nibble_qtensor, nmse, qtensor_numpy, to_np

from zllm.gguf.constants import GGMLType

from zllm_torch.models.loader import params_from_jax
from zllm_torch.ops import qmatmul as tq

FMTS = [GGMLType.Q4_0, GGMLType.Q4_1]
K = N = 512


def _carried(qt):
    return params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")["output"]


@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("case", ["gauss", "zeros", "const", "wide"])
def test_codecs_match_zllm(fmt, case):
    from zllm.quant import blocks as zqb
    from zllm_torch.quant import blocks as tqb

    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    if case == "zeros":
        x[::2] = 0.0
    elif case == "const":
        x[:, :32] = -1.5  # a constant block: max == min
    elif case == "wide":
        x *= np.float32(1e3) * (rng.random((64, 1)) > 0.5)
    enc = tqb.quantize(x, fmt)
    assert np.array_equal(enc, zqb.quantize(x, fmt))
    dec = tqb.dequantize(enc, fmt)
    assert dec.dtype == np.float32 and np.array_equal(dec, zqb.dequantize(enc, fmt))


@pytest.fixture(scope="module", params=FMTS, ids=lambda t: t.name)
def weights(request):
    """(npack QTensor, split-fold QTensor, the port's loaded weight) of one
    random weight."""
    from zllm_torch.quant.repack import repack

    fmt = request.param
    qn, raw = nibble_qtensor(fmt, N, K, seed=13, npack=True)
    qf, _ = nibble_qtensor(fmt, N, K, seed=13, npack=False)
    return qn, qf, repack(raw, (N, K), fmt, "cpu")


def test_loaded_and_carried_weights_match_zllm(weights):
    import jax.numpy as jnp

    from zllm.quant import blocks as zqb

    qn, qf, w = weights
    raw = nibble_qtensor(qn.fmt, N, K, seed=13, npack=False)[1]
    assert torch.equal(w.dequant_nk(), torch.from_numpy(zqb.dequantize(raw, qn.fmt)))
    for qt in (qn, qf):
        c = _carried(qt)
        assert type(c) is type(w) and c.shape == w.shape
        assert all(torch.equal(p, w.planes()[name]) for name, p in c.planes().items())
        assert np.array_equal(to_np(c.dequant()), np.asarray(qt.dequant(jnp.float32)))


def test_layout_operations_keep_values(weights):
    """permute_n, concat_n and pad_n move whole columns (the rope
    permutation of wq/wk, the qkv/gate|up fusion and the head padding)."""
    from zllm_torch.quant.repack import concat_n, pad_n

    _, _, w = weights
    dense = w.dequant()
    perm = np.random.default_rng(1).permutation(N)
    assert torch.equal(w.permute_n(perm).dequant(), dense[:, perm])
    assert torch.equal(concat_n([w, w]).dequant(), torch.cat([dense, dense], dim=1))
    padded = pad_n(w, 1024)
    assert padded.shape == (K, 1024) and torch.equal(padded.dequant()[:, :N], dense)
    assert not padded.dequant()[:, N:].any()


def _x(fuse, seed):
    rng = np.random.default_rng(seed)
    if fuse == "norm":
        x = (rng.standard_normal((1, K)) * 3.0).astype(np.float32)
        return x, (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    return rng.standard_normal((1, 2 * K if fuse == "glu" else K)).astype(np.float32), None


@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_k1_plain_matches_pallas(weights, fuse):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qn, _, w = weights
    x, wn = _x(fuse, 5)
    if fuse == "norm":
        want = qmm.qmatvec_norm(jnp.asarray(x), jnp.asarray(wn), 1e-5, qn, interpret=True)
        got = tq.q4k_matvec(torch.from_numpy(x), w, "norm", torch.from_numpy(wn), 1e-5)
    elif fuse == "glu":
        want = qmm.qmatvec_glu(jnp.asarray(x), qn, interpret=True)
        got = tq.q4k_matvec(torch.from_numpy(x), w, "glu")
    else:
        want = qmm.qmatmul_w4a8(jnp.asarray(x), qn, interpret=True)
        got = tq.q4k_matvec(torch.from_numpy(x), w)
    assert tuple(got.shape) == (1, N) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) < 1e-8


@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_k12_matches_pallas_hbm_kernel(weights, fuse):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qn, _, w = weights
    x, wn = _x(fuse, 6)
    names = qmm._plane_names(qn)
    pt = tuple(qmm._plane_view(qn, nm) for nm in names)
    kw = dict(fmt=qn.fmt, fold=qn.fold, k=K, n=N, tn=256, tk=256, fuse=fuse, interpret=True)
    if fuse == "norm":
        want = qmm._qmm_w4a8np_hbm_call(jnp.asarray(x), jnp.asarray(wn.reshape(1, K)), pt,
                                        eps=1e-5, **kw)
        got = tq.q4k_matvec_hbm(torch.from_numpy(x), w, "norm", torch.from_numpy(wn), 1e-5)
    else:
        want = qmm._qmm_w4a8np_hbm_call(jnp.asarray(x), None, pt, **kw)
        got = tq.q4k_matvec_hbm(torch.from_numpy(x), w, fuse)
    assert nmse(to_np(got), to_np(want)) < 1e-8


@pytest.mark.parametrize("m", [2, 8])
def test_k3_plain_matches_pallas(weights, m):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qn, _, w = weights
    x = np.random.default_rng(m).standard_normal((m, K)).astype(np.float32)
    want = qmm.qmatmul(jnp.asarray(x), qn, interpret=True)
    got = tq.q4k_gemm(torch.from_numpy(x), w)
    assert tuple(got.shape) == (m, N) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) < 1e-8


@pytest.mark.parametrize("seed", [0, 1])
def test_k11_plain_matches_pallas(weights, seed):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    _, qf, w = weights
    x = np.random.default_rng(seed).standard_normal((1, K)).astype(np.float32)
    xq, dx, e = qmm._quant_acts(jnp.asarray(x), 32)
    # lo/hi-ordered activation codes, as zllm's qmatmul_w4a8 builds them
    xq2 = xq.reshape(K // qf.fold, 2, qf.fold // 2).transpose(1, 0, 2).reshape(2, K // 2)
    pt = tuple(qmm._plane_view(qf, nm) for nm in qmm._PLANE_ORDER[qf.fmt])
    want = qmm._qmm_w4a8dd_call(xq2, dx, e, pt, fmt=qf.fmt, fold=qf.fold, k=K, n=N, tn=256,
                                interpret=True)
    txq, tdx, te = tq.quantize_acts(torch.from_numpy(x))
    assert txq.dtype == torch.int8 and np.array_equal(txq.numpy(), np.asarray(xq)[0])
    assert np.array_equal(tdx.numpy(), np.asarray(dx)[:, 0])
    assert np.array_equal(te.numpy(), np.asarray(e)[:, 0])
    got = tq.w4a8dd_matvec_plain(txq, tdx, te, w)
    assert nmse(to_np(got), to_np(want)) < 1e-8
    assert torch.equal(tq.w4a8dd_matvec(torch.from_numpy(x), w), got)


@pytest.mark.parametrize("hbm,dualdot", [(None, None), ("1", None), (None, "1"), ("1", "1"),
                                         ("0", "0")])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_dispatch_under_the_switches(weights, monkeypatch, hbm, dualdot, fuse):
    """Default: K1.  ZLLM_QMM_HBM=1: K12 for every prologue.
    ZLLM_QMM_DUALDOT=1: K11 for fuse="q" only.  Both: K12.  The values do
    not depend on the route (K11 within the sum order)."""
    for name, val in (("ZLLM_QMM_HBM", hbm), ("ZLLM_QMM_DUALDOT", dualdot)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    calls = []
    for name in ("q4k_matvec", "q4k_matvec_hbm", "w4a8dd_matvec", "int8_matvec"):
        real = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda *a, _n=name, _r=real, **kw: (calls.append(_n),
                                                                          _r(*a, **kw))[1])
    _, _, w = weights
    x, wn = _x(fuse, 7)
    aux = None if wn is None else torch.from_numpy(wn)
    got = tq.matvec(torch.from_numpy(x), w, fuse, aux, 1e-5)
    want = ("q4k_matvec_hbm" if hbm == "1"
            else "w4a8dd_matvec" if dualdot == "1" and fuse == "q" else "q4k_matvec")
    assert calls == [want]
    ref = tq.q4k_matvec_plain(torch.from_numpy(x), w, fuse, aux, 1e-5)
    assert nmse(to_np(got), to_np(ref)) < 1e-12


def test_k11_wrapper_checks(weights):
    """K11 takes a Q4_0/Q4_1 weight and one row of K; no launch on CPU
    tensors; other devices raise."""
    from zllm_torch.quant.repack import repack
    from zllm_torch.quant import blocks as tqb

    _, _, w = weights
    before = tq.w4a8dd_matvec.launches
    x = torch.ones(1, K)
    tq.w4a8dd_matvec(x, w)
    assert tq.w4a8dd_matvec.launches == before
    with pytest.raises(ValueError, match="one row"):
        tq.w4a8dd_matvec(torch.ones(1, 2 * K), w)
    with pytest.raises(ValueError):
        tq.w4a8dd_matvec(torch.ones(1, K + 1), w)
    with pytest.raises(ValueError, match="no kernel"):
        tq.quantize_acts(x.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tq.w4a8dd_matvec(x.to("meta"), w)
    w4k = repack(tqb.quantize(np.ones((N, K), np.float32), GGMLType.Q4_K), (N, K),
                 GGMLType.Q4_K, "cpu")
    with pytest.raises(NotImplementedError, match="K11"):
        tq.w4a8dd_matvec(x, w4k)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k11_is_one_launch_a_call(weights, monkeypatch, xdtype):
    """The wrapper's card path, with the device checks and the library
    stubbed: each call binds the one entry point zt_w4a8dd_matvec and calls
    it once, on the raw row (its pointer and dtype code), the weight's
    planes, y, K and N; `quantize_acts` is not called, and `.launches`
    counts one a call."""
    from zllm_torch.ops import cuda

    _, _, w = weights
    seen = []

    def fake_bind(lib, symbol, argtypes):
        def fn(*args):
            seen.append((lib, symbol, list(argtypes), args))
            return 0
        return fn

    def no_quantize(*_):
        raise AssertionError("K11 quantizes inside its own launch")

    monkeypatch.setattr(tq, "_check_cuda_x", lambda *a: None)
    monkeypatch.setattr(tq, "_check_qweight", lambda *a: None)
    monkeypatch.setattr(tq, "quantize_acts", no_quantize)
    monkeypatch.setattr(cuda, "require_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(cuda, "bind", fake_bind)
    monkeypatch.setattr(cuda, "stream", lambda: 7)
    x = torch.ones(1, K, dtype=xdtype).to("meta")
    before = tq.w4a8dd_matvec.launches
    for _ in range(2):
        y = tq.w4a8dd_matvec(x, w)
        assert tuple(y.shape) == (1, N) and y.dtype == torch.float32
    assert tq.w4a8dd_matvec.launches == before + 2
    assert len(seen) == 2
    lib, symbol, argtypes, args = seen[0]
    assert (lib, symbol, argtypes) == ("w4a8dd_matvec", "zt_w4a8dd_matvec", tq.W4A8DD_ARGTYPES)
    planes = [p.data_ptr() for p in w.planes().values()]
    assert args == (tq.NIBBLE_FMT_CODE[w.fmt], x.data_ptr(), cuda.DTYPE_CODE[xdtype],
                    *planes, *[None] * (3 - len(planes)), 0, K, N, 7)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

SHAPE = {k: v for k, v in SMALL_LLAMA.items() if k != "gtype"}
ARCH_KW = {"llama": {}, "olmo2": dict(arch="olmo2", n_kv_heads=4, norm_eps=1e-6,
                                      rope_base=500000.0)}
TOL = {"llama": 2e-4, "olmo2": 1e-3}
PROMPT = [1] + list(range(40, 59))  # 20 tokens: two 16-token prefill chunks
N_DECODE = 16


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from zllm_torch.testing import make_llama_gguf

    folder = tmp_path_factory.mktemp("q4legacy")
    return {(arch, fmt.name): make_llama_gguf(str(folder / f"{arch}_{fmt.name}.gguf"),
                                              **dict(SHAPE, **ARCH_KW[arch]), gtype=fmt,
                                              with_tokenizer=True)
            for arch in ARCH_KW for fmt in FMTS}


@pytest.fixture(scope="module")
def zllm_runs(files):
    """zllm's prefill and teacher-forced decode logits (f32 cache, its own
    greedy tokens), with its kernels installed in interpret mode."""
    import jax.numpy as jnp

    from zllm.models.loader import Model
    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.runtime.generate import Generator

    out = {}
    qmatmul.install(interpret=True)
    try:
        for key, path in files.items():
            gen = Generator(Model.load(path, dtype=jnp.float32), max_len=256, prefill_chunk=16,
                            kv_dtype=jnp.float32)
            logits = [to_np(gen.prefill(PROMPT))]
            toks = [int(np.argmax(logits[0]))]
            for i in range(N_DECODE):
                tok = jnp.full((1, 1), toks[-1], jnp.int32)
                pos = jnp.full((1, 1), len(PROMPT) + i, jnp.int32)
                lg, gen.kv = gen._step(tok, pos, gen.kv, logits_for="last")
                logits.append(to_np(lg[0, -1]))
                toks.append(int(np.argmax(logits[-1])))
            out[key] = logits, toks
    finally:
        linmod.set_fused_matmul(None)
        linmod.set_fused_decode(None, None)
    return out


def _sure_steps(tlog: list, zlog: list) -> int:
    """The sampled steps before the first whose zllm top-two logits lie
    within twice the step's largest port-vs-zllm logit difference (the
    steps whose argmax no rounding of that size can move)."""
    return next((i for i, (a, b) in enumerate(zip(tlog, zlog))
                 if np.diff(np.sort(b)[-2:])[0] <= 2 * np.abs(a - b).max()), len(zlog))


@pytest.mark.parametrize("dualdot", ["0", "1"])
@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("arch", list(ARCH_KW))
def test_model_matches_zllm(files, zllm_runs, monkeypatch, arch, fmt, dualdot):
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    monkeypatch.setenv("ZLLM_QMM_DUALDOT", dualdot)
    calls = {"w4a8dd_matvec": 0}
    real = tq.w4a8dd_matvec

    def spy(*a, **kw):
        calls["w4a8dd_matvec"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tq, "w4a8dd_matvec", spy)
    zlog, ztoks = zllm_runs[(arch, fmt.name)]
    m = Model.load(files[(arch, fmt.name)], device="cpu", dtype=torch.float32)
    gen = Generator(m, max_len=256, prefill_chunk=16, kv_dtype=torch.float32)
    tlog = [to_np(gen.prefill(PROMPT))]
    toks = [int(np.argmax(tlog[0]))]
    for i in range(N_DECODE):  # fed zllm's tokens; the port's own greedy picks recorded
        tlog.append(to_np(gen._decode_one(ztoks[i], len(PROMPT) + i)))
        toks.append(int(np.argmax(tlog[-1])))
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (SHAPE["vocab_size"],)
        assert nmse(a, b) <= TOL[arch], f"step {step}: nmse {nmse(a, b)}"
    # "q" matvecs a decode step: wo (llama); wqkv, wo, gate|up, down (OLMo-2)
    per_step = m.cfg.n_layers * (1 if arch == "llama" else 4)
    assert calls["w4a8dd_matvec"] == (per_step * N_DECODE if dualdot == "1" else 0)
    sure = _sure_steps(tlog, zlog) if arch == "olmo2" else len(zlog)
    assert toks[:sure] == ztoks[:sure]
    gen.reset()
    free = gen.generate(PROMPT, max_new=N_DECODE + 1)
    assert free.tokens[:sure] == ztoks[:sure] and len(free.tokens) == N_DECODE + 1


# a sampled logits row of the engine, the port against zllm (measured ~1e-5)
ENGINE_NMSE = 1e-4
COUNTERS = ("tokens_generated_total", "tokens_prefilled_total", "tokens_prefix_reused_total",
            "decode_steps_total", "prefill_steps_total", "context_shifts_total",
            "pages_cow_unshared_total", "engine_errors_total")


def _engine_script(engine, make_request):
    r = np.random.default_rng(3)

    def toks(n):
        return [int(x) for x in r.integers(3, 500, size=n)]

    long = toks(140)  # crosses the first 128-token page
    waves = [[dict(prompt_tokens=toks(37), max_new=6), dict(prompt_tokens=long, max_new=6)],
             [dict(prompt_tokens=long[:130] + [7], max_new=4)]]
    before = dict(engine.metrics)
    got = []
    for wave in waves:
        # submitted from the engine thread between two steps, so both
        # engines admit a wave at the same step
        reqs = engine.run_in_loop(lambda wave=wave: [engine.submit(make_request(**kw))
                                                     for kw in wave])
        deadline = time.time() + 300
        while not all(q.done for q in reqs):
            assert time.time() < deadline, "engine timed out"
            time.sleep(0.005)
        got += [(tuple(q.prompt_tokens), list(q.out_tokens), q.finish_reason, q.n_prompt_reused,
                 q.error) for q in reqs]
    return got, {k: engine.metrics[k] - before[k] for k in COUNTERS}


@pytest.mark.parametrize("layout", ["paged", "contiguous", "q8"])
def test_engine_matches_zllm(files, layout, monkeypatch):
    """zllm's engine with its kernels in interpret mode (K3 for every step's
    GEMMs) against the port's (K3's plain version) on the Q4_0 llama file.

    Finish reasons, reused prompt tokens and step counters must be equal,
    and every sampled logits row made from the same tokens on both sides
    within ENGINE_NMSE of zllm's.  With the f32 caches the logits differ by
    f32 sum order and the tokens must be identical.  The q8 cache turns
    such a difference into a flipped int8 code now and then (a change of up
    to 1/127 of the vector's largest element), and the logits then differ
    by up to ~5e-3 (nmse ~1e-5, for Q4_K files too), which on this random
    model can exceed the gap of a step (the long prompt's fifth token: a
    gap of 1.3e-3).  So in that layout a request's tokens may part at one
    sampled step after its first, where the port takes zllm's second token
    and zllm's top-two gap is at most twice that row's logit difference."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request

    logits = {"zllm": {}, "port": {}}  # side -> prompt -> the sampled logits rows
    for side, cls in (("zllm", ZEngine), ("port", Engine)):
        real = cls._sample_and_emit

        def record(self, lg, cols, slots, _real=real, _rec=logits[side]):
            rows = to_np(lg)
            for s in slots:
                _rec.setdefault(tuple(s.req.prompt_tokens), []).append(rows[s.idx, int(cols[s.idx])])
            return _real(self, lg, cols, slots)

        monkeypatch.setattr(cls, "_sample_and_emit", record)

    path = files[("llama", "Q4_0")]
    zkw, tkw = {"paged": (dict(kv_dtype=jnp.float32), dict(kv_dtype=torch.float32)),
                "contiguous": (dict(kv_layout="contiguous", kv_dtype=jnp.float32),
                               dict(kv_layout="contiguous", kv_dtype=torch.float32)),
                "q8": (dict(kv_dtype="q8"), dict(kv_dtype="q8"))}[layout]
    out = {}
    qmatmul.install(interpret=True)
    try:
        for side, make_engine, make_request in (
                ("zllm", lambda: ZEngine(ZModel.load(path, dtype=jnp.float32), n_slots=2,
                                         max_len=256, prefill_chunk=16, **zkw),
                 lambda **kw: ZRequest(temp=0.0, **kw)),
                ("port", lambda: Engine(Model.load(path, device="cpu", dtype=torch.float32),
                                        n_slots=2, max_len=256, prefill_chunk=16, **tkw),
                 lambda **kw: Request(temp=0.0, **kw))):
            eng = make_engine()
            eng.start()
            try:
                out[side] = _engine_script(eng, make_request)
            finally:
                eng.stop()
    finally:
        linmod.set_fused_matmul(None)
        linmod.set_fused_decode(None, None)
    (tgot, tcount), (zgot, zcount) = out["port"], out["zllm"]
    assert all(err == "" for *_, err in tgot), tgot
    drop_tokens = [(r[0], *r[2:]) for r in tgot]
    assert drop_tokens == [(r[0], *r[2:]) for r in zgot] and tcount == zcount
    for (prompt, ttoks, *_), (_, ztoks, *_) in zip(tgot, zgot):
        trows, zrows = logits["port"][prompt], logits["zllm"][prompt]
        assert len(trows) == len(ttoks) and len(zrows) == len(ztoks)
        part = next((i for i, (a, b) in enumerate(zip(ttoks, ztoks)) if a != b), None)
        shared = len(zrows) if part is None else part + 1  # rows made from the same tokens
        for step, (a, b) in enumerate(zip(trows[:shared], zrows[:shared])):
            assert nmse(a, b) <= ENGINE_NMSE, (layout, step, nmse(a, b))
        if part is not None:
            second, first = np.argsort(zrows[part])[-2:]
            gap = zrows[part][first] - zrows[part][second]
            assert layout == "q8" and part >= 1 and ttoks[part] == second, (layout, part)
            assert gap <= 2 * np.abs(trows[part] - zrows[part]).max(), (layout, part, gap)
    assert tcount["decode_steps_total"] > 0 and tgot[2][3] >= 128
