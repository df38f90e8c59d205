"""The Q2_K / Q3_K / IQ4_NL / IQ4_XS / MXFP4 slice on the CPU, against zllm.

  * codecs: the port's decoders are bit-exact and its encoders
    byte-identical to `zllm.quant.blocks`, on Gaussian rows and on edge rows
    (zeros, a constant block, wide rows), and the decoders on random bytes;
    the factory writes zllm's bytes in each of the five types;
  * weights: a loaded `Q2KWeight`/`Q3KWeight`/`IQ4NLWeight`/`IQ4XSWeight`/
    `MXFP4Weight` dequantizes exactly to zllm's repacked weight
    (`QTensor.dequant()`: Q2_K's, Q3_K's and IQ4_XS's fp16-rounded scales on
    both sides), also on random GGUF bytes, and zllm's QTensors carried
    across by `params_from_jax` hold the very same planes; the crumb and
    third-bit planes' order holds on random codes;
  * kernels (plain versions, f32) against zllm's Pallas kernels run with
    interpret=True on the same weight (K = N = 512): K4 against
    `qmatmul_w4a8` / `qmatvec_norm` / `qmatvec_glu` (zllm's `_qmm_w4a8_call`)
    and K5 against `qmatmul` (`_qmm_call`, M = 4 and 40), all at nmse <
    1e-8: the group dots are exact integers on both sides and the f32
    epilogues the same expressions, so only the f32 sum order differs;
    K5's rows at M = 4 match the same rows of an M = 512 call (bit for bit
    on the card; here up to the CPU matmul's sum order);
  * dispatch: `matvec` and `gemm` send the five formats to K4 and K5 under
    every switch; K1, K3, K12 and K11 refuse them; the card paths hand the
    C entry points the format's code and its planes;
  * whole models: 2-layer llama files by `zllm_torch.quantize` from an F16
    one in Q3_K_M (wq, wk, wo, gate, up, down Q3_K on K4/K5; wv Q5_K on
    K1/K3; the head Q6_K) and IQ4_XS (every matmul IQ4_XS, so wq|wk|wv and
    gate|up fuse; the head Q6_K), zllm with its kernels installed in
    interpret mode: prefill logits and 16 teacher-forced decode-step logits
    (f32 caches) within nmse 2e-4 and the free-running greedy tokens
    identical to zllm's; the port's Engine on the Q3_K_M file (paged KV)
    gives zllm's tokens, counters and logits (nmse <= 1e-4); the 2-layer
    MXFP4 factory file's logits move when any one weight's scales double."""

import time

import numpy as np
import pytest
import torch
from test_torch_oracle import (SMALL_LLAMA, f16_llama_gguf, nmse, quant_qtensor, qtensor_numpy,
                               to_np)

from zllm.gguf.constants import GGMLType

from zllm_torch.models.loader import params_from_jax
from zllm_torch.ops import qmatmul as tq

FMTS = [GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.MXFP4]
K = N = 512
# GGUF block bytes and the offsets of the fp16 scales: Q2_K scales, codes,
# d at 80, dmin at 82; Q3_K hmask, codes, scales, d at 108; IQ4_NL d at 0
# and 16 bytes of indexes; IQ4_XS d at 0, 6 scale bytes, 128 of indexes;
# MXFP4 one exponent byte at 0 and 16 bytes of indexes
BLOCKS = {GGMLType.Q2_K: (84, (80, 82)), GGMLType.Q3_K: (110, (108,)),
          GGMLType.IQ4_NL: (18, (0,)), GGMLType.IQ4_XS: (136, (0,)), GGMLType.MXFP4: (17, ())}


def _carried(qt):
    return params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")["output"]


def _random_gguf(fmt, n, k, seed):
    """Random GGUF rows [N, row bytes]: every code bit random, the fp16
    scales finite (|s| < 0.05), MXFP4's exponents in [2, 250] (normal
    values: zllm's dequant runs on XLA's CPU, which flushes subnormals)."""
    size, scales = BLOCKS[fmt]
    per = 256 if size in (84, 110, 136) else 32
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n * k // per, size), dtype=np.uint8)
    for off in scales:
        raw[:, off:off + 2] = rng.uniform(-0.05, 0.05, raw.shape[0]).astype(np.float16).view(
            np.uint8).reshape(-1, 2)
    if fmt == GGMLType.MXFP4:
        raw[:, 0] = rng.integers(2, 251, raw.shape[0])
    return raw.reshape(n, -1)


@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("case", ["gauss", "zeros", "const", "wide"])
def test_codecs_match_zllm(fmt, case):
    from zllm.quant import blocks as zqb
    from zllm_torch.quant import blocks as tqb

    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 512)).astype(np.float32)
    if case == "zeros":
        x[::2] = 0.0
    elif case == "const":
        x[:, :32] = -1.5  # a constant block
        x[1::2, :256] = 0.25  # a constant superblock
    elif case == "wide":
        x *= np.float32(1e3) * (rng.random((64, 1)) > 0.5)
    enc = tqb.quantize(x, fmt)
    assert np.array_equal(enc, zqb.quantize(x, fmt))
    dec = tqb.dequantize(enc, fmt)
    assert dec.dtype == np.float32 and np.array_equal(dec, zqb.dequantize(enc, fmt))


@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
def test_decoders_random_bytes_bit_exact(fmt):
    """Every byte random, MXFP4's exponents too (0, 1: subnormal scales;
    255: inf), the fp16 scales finite."""
    from zllm.quant import blocks as zqb
    from zllm_torch.quant import blocks as tqb

    size, scales = BLOCKS[fmt]
    rng = np.random.default_rng(size)
    raw = rng.integers(0, 256, size=(64, size), dtype=np.uint8)
    for off in scales:
        raw[:, off:off + 2] = rng.uniform(-0.05, 0.05, 64).astype(np.float16).view(
            np.uint8).reshape(-1, 2)
    if fmt == GGMLType.MXFP4:
        raw[:3, 0] = (0, 1, 255)
    with np.errstate(over="ignore"):  # 2^127 times 12
        assert np.array_equal(tqb.dequantize(raw, fmt), zqb.dequantize(raw, fmt))


@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
def test_factory_writes_zllms_bytes(tmp_path, fmt):
    """make_llama_gguf(gtype=...) in each of the five types writes zllm's
    bytes (the embedding and the head in that type too)."""
    from zllm.testing import make_llama_gguf as zmake
    from zllm_torch.testing import make_llama_gguf

    a, b = str(tmp_path / "z.gguf"), str(tmp_path / "t.gguf")
    kw = dict(SMALL_LLAMA, gtype=fmt, seed=6, with_tokenizer=True)
    zmake(a, **kw)
    make_llama_gguf(b, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.fixture(scope="module", params=FMTS, ids=lambda t: t.name)
def weights(request):
    """(zllm's QTensor, its GGUF rows, the port's loaded weight) of one
    random weight."""
    from zllm_torch.quant.repack import repack

    fmt = request.param
    qt, raw = quant_qtensor(fmt, N, K, seed=17)
    return qt, raw, repack(raw, (N, K), fmt, "cpu")


def test_loaded_and_carried_weights_match_zllm(weights):
    import jax.numpy as jnp

    from zllm.quant import blocks as zqb

    qt, raw, w = weights
    dense = w.dequant_nk()
    assert np.array_equal(to_np(w.dequant()), np.asarray(qt.dequant(jnp.float32)))
    ggml = torch.from_numpy(zqb.dequantize(raw, qt.fmt).reshape(N, K))
    if qt.fmt in (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.IQ4_XS):
        # zllm's repack rounds d * sc (and dmin * mn) to fp16; ggml does not
        assert not torch.equal(dense, ggml) and nmse(dense, ggml) < 1e-5
    else:
        assert torch.equal(dense, ggml)
    c = _carried(qt)
    assert type(c) is type(w) and c.shape == w.shape
    assert all(torch.equal(p, w.planes()[name]) for name, p in c.planes().items())


@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
def test_random_bytes_load_as_zllm_repacks(fmt):
    """Random GGUF bytes (every code, bit and index): the loaded weight is
    zllm's repacked one; MXFP4's subnormal scales (exponents 0 and 1) are
    ggml's decoder's values, which zllm's dequant on XLA's CPU flushes to
    zero."""
    import jax.numpy as jnp

    from zllm.quant import blocks as zqb
    from zllm.quant import repack as zrp
    from zllm_torch.quant.repack import repack

    raw = _random_gguf(fmt, 256, K, seed=int(fmt))
    w = repack(raw, (256, K), fmt, "cpu")
    assert np.array_equal(to_np(w.dequant()), np.asarray(zrp.repack(raw, (256, K), fmt).dequant(
        jnp.float32)))
    if fmt == GGMLType.MXFP4:
        raw[:, ::17] = (np.arange(raw.shape[1] // 17) % 2).astype(np.uint8)  # e 0, 1
        w = repack(raw, (256, K), fmt, "cpu")
        assert np.array_equal(w.dequant_nk().numpy(), zqb.dequantize(raw, fmt).reshape(256, K))
        assert (w.group_scale() < 2.0 ** -126).any()


def test_crumb_and_third_bit_order_round_trips():
    """Random codes 0..7 -> Q3_K planes -> codes; element e of 16-group g
    in byte 4g + e % 4 at bits 2(e // 4), its third bit at bit e % 8 of qh
    byte 2g + e // 8."""
    from zllm_torch.quant.repack import Q3KWeight, from_planes, pack_crumbs

    codes = np.random.default_rng(2).integers(0, 8, size=(8, 512), dtype=np.uint8)
    planes = {"qs": pack_crumbs(codes & 3), "qh": Q3KWeight.pack_high(codes >> 2),
              "a": np.ones((8, 32), "<f2")}
    w = from_planes(planes, (512, 8), GGMLType.Q3_K, "cpu")
    assert np.array_equal(w.int_codes().numpy(), codes.astype(np.int16) - 4)
    g, e = 13, 9
    assert (planes["qs"][3, 4 * g + e % 4] >> (2 * (e // 4))) & 3 == codes[3, 16 * g + e] & 3
    assert (planes["qh"][3, 2 * g + e // 8] >> (e % 8)) & 1 == codes[3, 16 * g + e] >> 2
    word = planes["qs"].view("<u4")[3, g]  # the u32 word a kernel shifts by 2i
    i = 2
    assert [(int(word) >> (2 * i + 8 * b)) & 3 for b in range(4)] == list(
        codes[3, 16 * g + 4 * i:16 * g + 4 * i + 4] & 3)


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


def test_k5_rows_at_m4_match_rows_at_m512(weights):
    """The plain version sums every row slice by slice, as the kernel does
    (the kernel's rows are equal bit for bit: `tests/test_torch_cuda.py::
    test_k3_k5_rows_do_not_depend_on_m`, on the card)."""
    _, _, w = weights
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((512, K)).astype(np.float32))
    full = tq.dequant_gemm(x, w)
    for rows in (slice(0, 4), slice(508, 512)):
        assert nmse(tq.dequant_gemm(x[rows], w), full[rows]) < 1e-13


@pytest.mark.parametrize("hbm,dualdot", [(None, None), ("1", None), (None, "1")])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_dispatch_routes_to_k4_and_k5(weights, monkeypatch, hbm, dualdot, fuse):
    """Every prologue of the five formats goes to K4, and a GEMM to K5,
    whatever the switches say."""
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
    got = tq.matvec(torch.from_numpy(x), w, fuse, aux, 1e-5)
    assert torch.equal(got, tq.int8_matvec_plain(torch.from_numpy(x), w, fuse, aux, 1e-5))
    xg = torch.from_numpy(x[:, :K].copy()).repeat(3, 1)
    assert torch.equal(tq.gemm(xg, w), tq.dequant_gemm_plain(xg, w))
    assert calls == ["int8_matvec", "dequant_gemm"]


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
    order, padded with None to three."""
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
    tq.int8_matvec(torch.ones(1, K, dtype=xdtype).to("meta"), w)
    tq.dequant_gemm(torch.ones(4, K, dtype=xdtype).to("meta"), w)
    (s1, a1), (s2, a2) = seen
    assert (s1, s2) == ("zt_int8_matvec", "zt_dequant_gemm")
    assert a1[0] == a2[0] == tq.INT8_FMT_CODE[w.fmt] == {
        GGMLType.Q2_K: 2, GGMLType.Q3_K: 3, GGMLType.IQ4_NL: 4, GGMLType.IQ4_XS: 5,
        GGMLType.MXFP4: 6}[w.fmt]
    assert list(a1[4:7]) == want and list(a2[4:7]) == want


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

SHAPE = {k: v for k, v in SMALL_LLAMA.items() if k != "gtype"}
PROMPT = [1] + list(range(40, 59))  # 20 tokens: two 16-token prefill chunks
N_DECODE = 16
MODEL_FTYPES = ["Q3_K_M", "IQ4_XS"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Q3_K_M and IQ4_XS by zllm_torch.quantize from one F16 file."""
    from zllm_torch.quantize import quantize_file

    folder = tmp_path_factory.mktemp("lowbit")
    src = f16_llama_gguf(str(folder / "f16.gguf"), seed=1)
    out = {}
    for ftype in MODEL_FTYPES:
        out[ftype] = str(folder / f"{ftype}.gguf")
        types = quantize_file(src, out[ftype], ftype, quiet=True)
        assert types["output.weight"][1] == "Q6_K"
    assert types["blk.1.attn_v.weight"][1] == "IQ4_XS"
    return out


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
    from zllm_torch.models.loader import Model
    from zllm_torch.quant.repack import IQ4XSWeight, Q3KWeight
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
    if ftype == "Q3_K_M":
        assert isinstance(layer["wk"], Q3KWeight) and layer["wv"].fmt == GGMLType.Q5_K
    else:
        assert isinstance(layer["wqkv"], IQ4XSWeight) and isinstance(layer["ffn_gateup"],
                                                                     IQ4XSWeight)
    gen = Generator(m, max_len=256, prefill_chunk=16, kv_dtype=torch.float32)
    tlog = [to_np(gen.prefill(PROMPT))]
    toks = [int(np.argmax(tlog[0]))]
    for i in range(N_DECODE):  # fed zllm's tokens; the port's own greedy picks recorded
        tlog.append(to_np(gen._decode_one(ztoks[i], len(PROMPT) + i)))
        toks.append(int(np.argmax(tlog[-1])))
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (SHAPE["vocab_size"],)
        assert nmse(a, b) <= 2e-4, f"step {step}: nmse {nmse(a, b)}"
    assert launched["int8_matvec"] > 0 and launched["dequant_gemm"] > 0
    assert toks == ztoks
    gen.reset()
    free = gen.generate(PROMPT, max_new=N_DECODE + 1)
    assert free.tokens == ztoks


def test_engine_matches_zllm(files, monkeypatch):
    """zllm's engine with its kernels in interpret mode against the port's
    (K4's and K5's plain versions for the Q3_K weights) on the Q3_K_M file,
    paged f32 KV: the same tokens, finish reasons, reuse and step counters,
    and every sampled logits row within 1e-4 of zllm's."""
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
    path = files["Q3_K_M"]
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


@pytest.mark.parametrize("role", ["wqkv", "wo", "ffn_gateup", "ffn_down"])
def test_mxfp4_model_logits_follow_its_weights(tmp_path, role):
    """The 2-layer MXFP4 factory file (every matmul MXFP4: the card's
    GPU-vs-CPU check of that form) is no degenerate model: doubling one
    MXFP4 weight's scales (e + 1) in either layer moves the prefill logits
    by nmse > 1e-2, so the logits depend on what K4's and K5's MXFP4 forms
    compute."""
    from zllm_torch.models.loader import Model
    from zllm_torch.quant.repack import MXFP4Weight
    from zllm_torch.runtime.generate import Generator
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "m.gguf"), **SHAPE, gtype=GGMLType.MXFP4, seed=0)
    m = Model.load(path, device="cpu", dtype=torch.bfloat16)

    def prefill():
        return to_np(Generator(m, max_len=256, prefill_chunk=16).prefill(PROMPT))

    base = prefill()
    for layer in m.params["layers"]:
        w = layer[role]
        assert isinstance(w, MXFP4Weight) and int(w.e.max()) < 255
        w.e += 1
        moved = nmse(prefill(), base)
        w.e -= 1
        assert moved > 1e-2, moved
    np.testing.assert_array_equal(prefill(), base)
