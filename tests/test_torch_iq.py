"""The IQ grid slice (IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, IQ1_M)
on the CPU, against zllm.

  * decoders: the port's are bit-exact to `zllm.quant.blocks` on random
    bytes (every grid row, sign and scale bit; IQ1_M's d assembled from
    the top nibbles of its four scale words);
  * weights: a loaded `IQ2XXSWeight` ... `IQ1MWeight` (grid rows and signs
    folded into value indexes in torch) dequantizes exactly to zllm's
    repacked weight (`QTensor.dequant()`, the scale products rounded to
    fp16 on both sides; ggml's decoder keeps them in f32), and zllm's
    QTensors carried across by `params_from_jax` hold the very same planes;
  * kernels (plain versions, f32) against zllm's Pallas kernels run with
    interpret=True on the same weight (K = N = 512): K4 against
    `qmatmul_w4a8` / `qmatvec_norm` / `qmatvec_glu` for the six formats
    zllm's `_INT_FMT` holds, and K5 against `qmatmul` for all seven at M =
    4 and 40, and at M = 1 the port's `matvec` against zllm's `qmatmul`
    (K4's route, IQ1_M's K5), nmse < 1e-8; K5's rows at M = 4 match the
    rows of an M = 512 call;
  * dispatch: `matvec` sends the six to K4 under every switch and IQ1_M to
    K5 (fuse="q" alone: the fused norm and SwiGLU hooks decline it), `gemm`
    all seven to K5; K1, K3, K12 and K11 refuse them, K4 refuses IQ1_M; the
    card paths hand the C entry points the format's code and its planes;
  * the factory's preset files (`make_llama_gguf(ftype=...)`): each
    tensor's type is `tools/quantize.py`'s `pick_type`'s, the same seed
    writes the same bytes, the IQ tensors' RMS is near the factory's 0.02,
    and zllm reads them;
  * whole models: 2-layer IQ3_XXS, IQ1_S and IQ1_M files, zllm with its
    kernels installed in interpret mode: prefill logits and 16
    teacher-forced decode-step logits (f32 caches) within nmse 2e-4 and the
    free-running greedy tokens identical to zllm's; the port's Engine on
    the IQ3_XXS file (paged KV) gives zllm's tokens, counters and logits
    (nmse <= 1e-4)."""

import time

import numpy as np
import pytest
import torch
from test_torch_oracle import SMALL_LLAMA, nmse, qtensor_numpy, to_np

from zllm.gguf.constants import GGML_BLOCK_SIZES, GGMLType

from zllm_torch.models.loader import params_from_jax
from zllm_torch.ops import qmatmul as tq

FMTS = [GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ3_XXS, GGMLType.IQ3_S,
        GGMLType.IQ1_S, GGMLType.IQ1_M]
K4_FMTS = FMTS[:-1]
K = N = 512


def _random_blocks(fmt, n_blocks, seed):
    """Random blocks [n_blocks, bytes]: every bit random, each block's d a
    finite fp16 (|d| < 0.05; IQ1_M's in its scale words' top nibbles)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n_blocks, GGML_BLOCK_SIZES[fmt][1]), dtype=np.uint8)
    d = rng.uniform(-0.05, 0.05, n_blocks).astype(np.float16).view(np.uint16)
    if fmt == GGMLType.IQ1_M:
        words = raw[:, 48:56].copy().view("<u2")
        for i in range(4):
            words[:, i] = (words[:, i] & 0x0FFF) | (((d >> (4 * i)) & 0xF) << 12)
        raw[:, 48:56] = words.view(np.uint8)
    else:
        raw[:, :2] = d.view(np.uint8).reshape(-1, 2)
    return raw


@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
def test_decoders_random_bytes_bit_exact(fmt):
    from zllm.quant import blocks as zqb
    from zllm_torch.quant import blocks as tqb

    raw = _random_blocks(fmt, 64, int(fmt))
    got = tqb.dequantize(raw, fmt)
    assert got.dtype == np.float32 and got.shape == (64, 256)
    assert np.array_equal(got, zqb.dequantize(raw, fmt))


def test_iq1m_d_from_the_scale_words():
    """IQ1_M's d: nibble i of the fp16 is the top nibble of scale word i."""
    from zllm_torch.quant import blocks as tqb

    sraw = np.array([[0x1ABC, 0x2DEF, 0x3123, 0x4456]], dtype=np.uint16)
    assert tqb.iq1m_d(sraw)[0] == np.array([0x4321], np.uint16).view(np.float16)[0]


@pytest.fixture(scope="module", params=FMTS, ids=lambda t: t.name)
def weights(request):
    """(zllm's QTensor, its GGUF rows, the port's loaded weight) of one
    random weight (random GGUF bytes, repacked by each package)."""
    from zllm.quant import repack as zrp
    from zllm_torch.quant.repack import repack

    fmt = request.param
    raw = _random_blocks(fmt, N * K // 256, 17 + int(fmt)).reshape(N, -1)
    return zrp.repack(raw, (N, K), fmt), raw, repack(raw, (N, K), fmt, "cpu")


def test_loaded_and_carried_weights_match_zllm(weights):
    import jax.numpy as jnp

    from zllm.quant import blocks as zqb

    qt, raw, w = weights
    assert w.fmt == qt.fmt
    dense = w.dequant_nk()
    assert np.array_equal(to_np(w.dequant()), np.asarray(qt.dequant(jnp.float32)))
    # zllm's repack rounds the group scale products to fp16; ggml does not
    ggml = torch.from_numpy(zqb.dequantize(raw, qt.fmt).reshape(N, K))
    assert not torch.equal(dense, ggml) and nmse(dense, ggml) < 1e-5
    c = params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")["output"]
    assert type(c) is type(w) and c.shape == w.shape
    assert all(torch.equal(p, w.planes()[name]) for name, p in c.planes().items())


def test_value_indexes_are_the_grid_values(weights):
    """The folded int codes lie in the format's value set (grid value times
    sign): IQ2's unused table entries 3 and 7 (value 0) never occur."""
    from zllm_torch.quant import repack as trp

    _, _, w = weights
    codes = w.int_codes()
    allowed = {trp.IQ2XXSWeight: trp.IQ2_VALUES[[0, 1, 2, 4, 5, 6]],
               trp.IQ2XSWeight: trp.IQ2_VALUES[[0, 1, 2, 4, 5, 6]],
               trp.IQ2SWeight: trp.IQ2_VALUES[[0, 1, 2, 4, 5, 6]],
               trp.IQ3XXSWeight: trp.IQ3XXS_VALUES, trp.IQ3SWeight: trp.IQ3S_VALUES,
               trp.IQ1SWeight: np.array([-1, 0, 1]), trp.IQ1MWeight: np.array([-1, 0, 1])}
    assert set(codes.unique().tolist()) <= set(allowed[type(w)].tolist())


def test_layout_operations_keep_values(weights):
    """permute_n, concat_n and pad_n move whole columns."""
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
def test_k4_plain_matches_pallas(weights, fuse):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qt, _, w = weights
    if w.fmt not in K4_FMTS:
        with pytest.raises(KeyError):  # zllm's _INT_FMT leaves IQ1_M out
            qmm.qmatmul_w4a8(jnp.ones((1, K), jnp.float32), qt, interpret=True)
        with pytest.raises(NotImplementedError, match="K4 takes .* not IQ1_M"):
            tq.int8_matvec(torch.ones(1, K), w)
        return
    x, wn = _x(fuse, 5)
    if fuse == "norm":
        want = qmm.qmatvec_norm(jnp.asarray(x), jnp.asarray(wn), 1e-5, qt, interpret=True)
        got = tq.int8_matvec(torch.from_numpy(x), w, "norm", torch.from_numpy(wn), 1e-5)
    elif fuse == "glu":
        want = qmm.qmatvec_glu(jnp.asarray(x), qt, interpret=True)
        got = tq.int8_matvec(torch.from_numpy(x), w, "glu")
    else:
        want = qmm.qmatmul_w4a8(jnp.asarray(x), qt, interpret=True)
        got = tq.int8_matvec(torch.from_numpy(x), w)
    assert tuple(got.shape) == (1, N) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) < 1e-8


@pytest.mark.parametrize("m", [4, 40])
def test_k5_plain_matches_pallas(weights, m):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qt, _, w = weights
    x = np.random.default_rng(m).standard_normal((m, K)).astype(np.float32)
    want = qmm.qmatmul(jnp.asarray(x), qt, interpret=True)
    got = tq.dequant_gemm(torch.from_numpy(x), w)
    assert tuple(got.shape) == (m, N) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) < 1e-8


def test_m1_takes_zllms_route(weights):
    """At M = 1 zllm's `qmatmul` takes its int8 path (K4's) for the six
    `_INT_FMT` formats and the dequant tile (K5's) for IQ1_M; the port's
    `matvec` takes the same routes, within nmse 1e-8."""
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qt, _, w = weights
    x = np.random.default_rng(1).standard_normal((1, K)).astype(np.float32)
    want = qmm.qmatmul(jnp.asarray(x), qt, interpret=True)
    got = tq.matvec(torch.from_numpy(x), w)
    plain = tq.int8_matvec_plain if w.fmt in K4_FMTS else tq.dequant_gemm_plain
    assert torch.equal(got, plain(torch.from_numpy(x), w))
    assert nmse(to_np(got), to_np(want)) < 1e-8


def test_k5_rows_at_m4_match_rows_at_m512(weights):
    """The plain version sums every row slice by slice, as the kernel does
    (the kernel's rows are equal bit for bit on the card)."""
    _, _, w = weights
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((512, K)).astype(np.float32))
    full = tq.dequant_gemm(x, w)
    for rows in (slice(0, 4), slice(508, 512)):
        assert nmse(tq.dequant_gemm(x[rows], w), full[rows]) < 1e-13


@pytest.mark.parametrize("hbm,dualdot", [(None, None), ("1", None), (None, "1")])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_dispatch_routes_to_k4_and_k5(weights, monkeypatch, hbm, dualdot, fuse):
    """Every prologue of the six K4 formats goes to K4, and a GEMM to K5,
    whatever the switches say; IQ1_M's matvec goes to K5 with fuse="q",
    and the fused hooks decline it."""
    from zllm_torch.ops import linear as tl

    for name, val in (("ZLLM_QMM_HBM", hbm), ("ZLLM_QMM_DUALDOT", dualdot)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    calls = []
    for name in ("q4k_matvec", "q4k_matvec_hbm", "w4a8dd_matvec", "int8_matvec", "q4k_gemm",
                 "dequant_gemm"):
        real = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda *a, _n=name, _r=real, **kw: (calls.append(_n),
                                                                          _r(*a, **kw))[1])
    _, _, w = weights
    x, wn = _x(fuse, 7)
    aux = None if wn is None else torch.from_numpy(wn)
    xt = torch.from_numpy(x)
    xg = torch.from_numpy(x[:, :K].copy()).repeat(3, 1)
    assert torch.equal(tq.gemm(xg, w), tq.dequant_gemm_plain(xg, w))
    if w.fmt in K4_FMTS:
        got = tq.matvec(xt, w, fuse, aux, 1e-5)
        assert torch.equal(got, tq.int8_matvec_plain(xt, w, fuse, aux, 1e-5))
        assert calls == ["dequant_gemm", "int8_matvec"] and tq.fuses(w)
        return
    assert not tq.fuses(w)
    if fuse == "q":
        assert torch.equal(tq.matvec(xt, w), tq.dequant_gemm_plain(xt, w))
        assert torch.equal(tl.linear(xt, w), tq.dequant_gemm_plain(xt, w))
        assert calls == ["dequant_gemm"] * 3
    else:
        with pytest.raises(NotImplementedError, match=f"no fused '{fuse}'"):
            tq.matvec(xt, w, fuse, aux, 1e-5)
        hook = (tl.fused_norm_linear(xt, aux, 1e-5, w) if fuse == "norm"
                else tl.fused_glu_linear(xt, w))
        assert hook is None and calls == ["dequant_gemm"]


def test_k1_k3_k12_k11_refuse(weights):
    _, _, w = weights
    x = torch.ones(1, K)
    for fn, who in ((tq.q4k_matvec, "K1/K3"), (tq.q4k_gemm, "K1/K3"), (tq.q4k_matvec_hbm, "K12"),
                    (tq.w4a8dd_matvec, "K11")):
        with pytest.raises(NotImplementedError, match=f"{who} take .* not {w.fmt.name}"):
            fn(x, w)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4_k5_get_code_and_planes(weights, monkeypatch, xdtype):
    """The wrappers' card paths, with the device checks and the library
    stubbed: K4 and K5 get the format's code and its planes in PLANES
    order (qs, a, and IQ1's b), padded with None to three."""
    from zllm_torch.ops import cuda

    _, _, w = weights
    seen = []

    def fake_bind(lib, symbol, argtypes):
        def fn(*args):
            seen.append((symbol, args))
            return 0
        return fn

    monkeypatch.setattr(tq, "_check_cuda_x", lambda *a: None)
    monkeypatch.setattr(tq, "_check_qweight", lambda *a: None)
    monkeypatch.setattr(tq, "_gemm_cuda_x", lambda x, w_: torch.empty(x.shape[0], w_.shape[1]))
    monkeypatch.setattr(tq, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda, "require_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(cuda, "bind", fake_bind)
    monkeypatch.setattr(cuda, "stream", lambda: 7)
    want = [p.data_ptr() for p in w.planes().values()]
    want += [None] * (3 - len(want))
    code = {f: 7 + i for i, f in enumerate(FMTS)}[w.fmt]
    tq.dequant_gemm(torch.ones(4, K, dtype=xdtype).to("meta"), w)
    tq.matvec(torch.ones(1, K, dtype=xdtype).to("meta"), w)
    (s1, a1), (s2, a2) = seen
    assert s1 == "zt_dequant_gemm" and a1[0] == tq.INT8_FMT_CODE[w.fmt] == code
    assert list(a1[4:7]) == want
    if w.fmt in K4_FMTS:
        assert s2 == "zt_int8_matvec" and a2[0] == code and list(a2[4:7]) == want
    else:  # IQ1_M's matvec: K5 at M = 1
        assert s2 == "zt_dequant_gemm" and a2[0] == code and a2[9] == 1  # M


# ---------------------------------------------------------------------------
# the factory's preset files
# ---------------------------------------------------------------------------

SHAPE = {k: v for k, v in SMALL_LLAMA.items() if k != "gtype"}


@pytest.mark.parametrize("ftype", ["IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S",
                                   "IQ1_M", "Q4_K_M"])
def test_preset_files_follow_pick_type(tmp_path, ftype):
    """make_llama_gguf(ftype=...) writes each tensor in the type zllm's
    tools/quantize.py picks for its role (Q4_K_M: the first half of
    ffn_down bumped), the same bytes for the same seed, other bytes for
    another, IQ tensors of RMS within 15% of the factory's 0.02, and zllm
    reads every tensor of it."""
    from tools.quantize import FTYPES, pick_type
    from zllm.gguf.reader import read_gguf as zread
    from zllm_torch.testing import make_llama_gguf

    kw = dict(SHAPE, n_layers=4, with_tokenizer=True, ftype=ftype)
    a = make_llama_gguf(str(tmp_path / "a.gguf"), **kw, seed=2)
    b = make_llama_gguf(str(tmp_path / "b.gguf"), **kw, seed=2)
    c = make_llama_gguf(str(tmp_path / "c.gguf"), **kw, seed=3)
    assert open(a, "rb").read() == open(b, "rb").read() != open(c, "rb").read()
    seen = set()
    with zread(a) as f:
        for name, meta in f.tensors.items():
            il = int(name.split(".")[1]) if name.startswith("blk.") else 0
            assert meta.gtype == pick_type(name, meta.shape, il, 4, FTYPES[ftype]), name
            seen.add(meta.gtype)
            x = f.tensor_f32(name)
            assert np.isfinite(x).all()
            if meta.gtype.name.startswith("IQ"):
                assert abs(float(np.sqrt(np.mean(x ** 2))) / 0.02 - 1) < 0.15, name
    assert FTYPES[ftype]["default"] in seen


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

PROMPT = [1] + list(range(40, 59))  # 20 tokens: two 16-token prefill chunks
N_DECODE = 16
MODEL_FTYPES = ["IQ3_XXS", "IQ1_S", "IQ1_M"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """2-layer files of the three presets from the factory."""
    from zllm_torch.testing import make_llama_gguf

    folder = tmp_path_factory.mktemp("iq")
    return {ftype: make_llama_gguf(str(folder / f"{ftype}.gguf"), **SHAPE, ftype=ftype, seed=4,
                                   with_tokenizer=True) for ftype in MODEL_FTYPES}


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
        for ftype, path in files.items():
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
            out[ftype] = logits, toks
    finally:
        linmod.set_fused_matmul(None)
        linmod.set_fused_decode(None, None)
    return out


@pytest.mark.parametrize("ftype", MODEL_FTYPES)
def test_model_matches_zllm(files, zllm_runs, monkeypatch, ftype):
    """wq, wk, wo, gate|up and down in the preset's type (wq, wk and wv
    apart: wv is Q4_K), the head Q5_K; the decode matvecs of the IQ
    weights on K4, IQ1_M's on K5."""
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    launched = {"int8_matvec": 0, "dequant_gemm": 0}
    for name in launched:
        real = getattr(tq, name)

        def spy(*a, _n=name, _r=real, **kw):
            launched[_n] += 1
            return _r(*a, **kw)

        monkeypatch.setattr(tq, name, spy)
    zlog, ztoks = zllm_runs[ftype]
    m = Model.load(files[ftype], device="cpu", dtype=torch.float32)
    layer = m.params["layers"][0]
    assert {layer[r].fmt.name for r in ("wq", "wk", "wo", "ffn_gateup", "ffn_down")} == {ftype}
    assert layer["wv"].fmt == GGMLType.Q4_K and m.params["output"].fmt == GGMLType.Q5_K
    gen = Generator(m, max_len=256, prefill_chunk=16, kv_dtype=torch.float32)
    tlog = [to_np(gen.prefill(PROMPT))]
    after_prefill = dict(launched)
    toks = [int(np.argmax(tlog[0]))]
    for i in range(N_DECODE):  # fed zllm's tokens; the port's own greedy picks recorded
        tlog.append(to_np(gen._decode_one(ztoks[i], len(PROMPT) + i)))
        toks.append(int(np.argmax(tlog[-1])))
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (SHAPE["vocab_size"],)
        assert nmse(a, b) <= 2e-4, f"step {step}: nmse {nmse(a, b)}"
    steps = {k: launched[k] - after_prefill[k] for k in launched}
    per_step = 5 * SHAPE["n_layers"] * N_DECODE
    if ftype == "IQ1_M":
        assert steps == {"int8_matvec": 0, "dequant_gemm": per_step}
    else:
        assert steps == {"int8_matvec": per_step, "dequant_gemm": 0}
    assert toks == ztoks
    gen.reset()
    free = gen.generate(PROMPT, max_new=N_DECODE + 1)
    assert free.tokens == ztoks


def test_engine_matches_zllm(files, monkeypatch):
    """zllm's engine with its kernels in interpret mode against the port's
    (K4's and K5's plain versions for the IQ3_XXS weights) on the IQ3_XXS
    file, paged f32 KV: the same tokens, finish reasons, reuse and step
    counters, and every sampled logits row within 1e-4 of zllm's."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request

    counters = ("tokens_generated_total", "tokens_prefilled_total", "tokens_prefix_reused_total",
                "decode_steps_total", "prefill_steps_total", "engine_errors_total")
    logits = {"zllm": {}, "port": {}}
    for side, cls in (("zllm", ZEngine), ("port", Engine)):
        real = cls._sample_and_emit

        def record(self, lg, cols, slots, _real=real, _rec=logits[side]):
            rows = to_np(lg)
            for s in slots:
                _rec.setdefault(tuple(s.req.prompt_tokens), []).append(
                    rows[s.idx, int(cols[s.idx])])
            return _real(self, lg, cols, slots)

        monkeypatch.setattr(cls, "_sample_and_emit", record)
    r = np.random.default_rng(5)
    long = [int(t) for t in r.integers(3, 500, size=140)]  # crosses the first 128-token page
    waves = [[dict(prompt_tokens=[int(t) for t in r.integers(3, 500, size=37)], max_new=6),
              dict(prompt_tokens=long, max_new=6)],
             [dict(prompt_tokens=long[:130] + [7], max_new=4)]]
    path = files["IQ3_XXS"]
    out = {}
    qmatmul.install(interpret=True)
    try:
        for side, eng, make_request in (
                ("zllm", ZEngine(ZModel.load(path, dtype=jnp.float32), n_slots=2, max_len=256,
                                 prefill_chunk=16, kv_dtype=jnp.float32),
                 lambda **kw: ZRequest(temp=0.0, **kw)),
                ("port", Engine(Model.load(path, device="cpu", dtype=torch.float32), n_slots=2,
                                max_len=256, prefill_chunk=16, kv_dtype=torch.float32),
                 lambda **kw: Request(temp=0.0, **kw))):
            eng.start()
            try:
                before, got = dict(eng.metrics), []
                for wave in waves:
                    # submitted from the engine thread between two steps, so
                    # both engines admit a wave at the same step
                    reqs = eng.run_in_loop(lambda wave=wave: [eng.submit(make_request(**kw))
                                                              for kw in wave])
                    deadline = time.time() + 300
                    while not all(q.done for q in reqs):
                        assert time.time() < deadline, "engine timed out"
                        time.sleep(0.005)
                    got += [(tuple(q.prompt_tokens), list(q.out_tokens), q.finish_reason,
                             q.n_prompt_reused, q.error) for q in reqs]
                out[side] = got, {k: eng.metrics[k] - before[k] for k in counters}
            finally:
                eng.stop()
    finally:
        linmod.set_fused_matmul(None)
        linmod.set_fused_decode(None, None)
    (tgot, tcount), (zgot, zcount) = out["port"], out["zllm"]
    assert all(err == "" for *_, err in tgot), tgot
    assert tgot == zgot and tcount == zcount
    for prompt, toks, *_ in tgot:
        trows, zrows = logits["port"][prompt], logits["zllm"][prompt]
        assert len(trows) == len(zrows) == len(toks)
        for step, (a, b) in enumerate(zip(trows, zrows)):
            assert nmse(a, b) <= 1e-4, (step, nmse(a, b))
    assert tcount["decode_steps_total"] > 0 and tgot[2][3] >= 128
