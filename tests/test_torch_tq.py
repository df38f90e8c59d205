"""The TQ1_0 / TQ2_0 / BF16 slice on the CPU, against zllm.

  * codecs: the port's TQ1_0, TQ2_0 and BF16 encoders are byte-identical to
    `zllm.quant.blocks`'s (TQ1_0's unweighted form) on Gaussian rows and on
    edge rows (zeros, a constant block, wide rows), and its decoders
    (TQ1_0, TQ2_0, BF16, F64, I8-I64) bit-exact on encoded blocks and on
    random bytes; the factory writes zllm's bytes in TQ1_0, TQ2_0 and BF16;
  * weights: a loaded `TQ10Weight`/`TQ20Weight` dequantizes exactly to
    zllm's repacked weight (`_dq_ternary`: the per-256 d repeated for each
    32-group, exact, so also equal to ggml's decoder), also on random GGUF
    bytes (every base-3 byte value), and zllm's QTensors carried across by
    `params_from_jax` hold the very same planes;
  * kernels (plain versions, f32) against zllm's Pallas kernels run with
    interpret=True on the same weight (K = N = 512): K4 against
    `qmatmul_w4a8` / `qmatvec_norm` / `qmatvec_glu` and K5 against
    `qmatmul` (M = 4 and 40), nmse < 1e-8 (exact integer group dots, the
    same f32 epilogue, another f32 sum order); K5's rows at M = 4 match an
    M = 512 call's;
  * dispatch: `matvec` and `gemm` send TQ to K4 and K5 under every switch,
    as zllm does (its `_hbm_np_ok` refuses TQ); K1, K3, K12 and K11 refuse
    them; the card paths hand the C entry points codes 14 and 15 and the
    planes qs, a;
  * files: `python -m zllm_torch.quantize ... TQ1_0|TQ2_0|BF16` writes the
    bytes of `tools/quantize.py` from the same F16 file;
  * whole models: 2-layer TQ2_0 and TQ1_0 files (wq|wk|wv and gate|up
    fused, the head Q6_K, the embedding Q4_K) against zllm with its kernels
    in interpret mode: prefill logits and 16 teacher-forced decode-step
    logits (f32 caches) within nmse 2e-4 and the free-running greedy
    tokens identical; the 2-layer BF16 file (every matmul a dense BF16
    weight, `torch.matmul`) within nmse 1e-5 (f32 sum order) and identical
    tokens."""

import os

import numpy as np
import pytest
import torch
from test_torch_oracle import (SMALL_LLAMA, f16_llama_gguf, nmse, quant_qtensor, qtensor_numpy,
                               to_np)

from zllm.gguf.constants import GGMLType

from zllm_torch.models.loader import params_from_jax
from zllm_torch.ops import qmatmul as tq

FMTS = [GGMLType.TQ1_0, GGMLType.TQ2_0]
CODEC_FMTS = FMTS + [GGMLType.BF16]
K = N = 512
# GGUF block bytes and the offset of the fp16 d: TQ1_0 48 + 4 base-3 bytes,
# d at 52; TQ2_0 64 crumb bytes, d at 64
BLOCKS = {GGMLType.TQ1_0: (54, 52), GGMLType.TQ2_0: (66, 64)}


def _carried(qt):
    return params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")["output"]


def _random_gguf(fmt, n, k, seed):
    """Random GGUF rows [N, row bytes]: every code byte random (TQ1_0: any
    base-3 byte, its five digits as ggml decodes them), d finite."""
    size, off = BLOCKS[fmt]
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n * k // 256, size), dtype=np.uint8)
    raw[:, off:off + 2] = rng.uniform(-0.05, 0.05, raw.shape[0]).astype(np.float16).view(
        np.uint8).reshape(-1, 2)
    return raw.reshape(n, -1)


@pytest.mark.parametrize("fmt", CODEC_FMTS, ids=lambda t: t.name)
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


def test_bf16_encoder_rounds_and_keeps_specials():
    """Round to nearest even into the top 16 bits, NaNs quieted, infinities
    and signed zeros kept, as zllm's encoder does."""
    from zllm.quant import blocks as zqb
    from zllm_torch.quant import blocks as tqb

    u = np.array([0x3F808000, 0x3F818000, 0x7F800001, 0xFF800000, 0x80000000, 0x7F7FFFFF,
                  0x00000001, 0x3F80FFFF], np.uint32)
    x = u.view(np.float32).reshape(1, -1)
    enc = tqb.quantize(x, GGMLType.BF16)
    assert np.array_equal(enc, zqb.quantize(x, GGMLType.BF16))
    assert list(enc.view("<u2")[0]) == [0x3F80, 0x3F82, 0x7FC0, 0xFF80, 0x8000, 0x7F80, 0x0000,
                                        0x3F81]


@pytest.mark.parametrize("fmt", [GGMLType.TQ1_0, GGMLType.TQ2_0, GGMLType.BF16, GGMLType.F64,
                                 GGMLType.I8, GGMLType.I16, GGMLType.I32, GGMLType.I64],
                         ids=lambda t: t.name)
def test_decoders_random_bytes_bit_exact(fmt):
    """Every byte random (the TQ formats' d finite; BF16's NaNs compared by
    their bits; F64 outside f32's range becomes inf, as in zllm)."""
    from zllm.quant import blocks as zqb
    from zllm_torch.quant import blocks as tqb

    rng = np.random.default_rng(int(fmt))
    if fmt in BLOCKS:
        raw = _random_gguf(fmt, 32, 512, int(fmt))
    else:
        raw = rng.integers(0, 256, size=(16, 256 * tqb.GGML_BLOCK_SIZES[fmt][1]), dtype=np.uint8)
    with np.errstate(over="ignore", invalid="ignore"):
        got, want = tqb.dequantize(raw, fmt), zqb.dequantize(raw, fmt)
    assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fmt", CODEC_FMTS, ids=lambda t: t.name)
def test_factory_writes_zllms_bytes(tmp_path, fmt):
    """make_llama_gguf(gtype=...) in TQ1_0, TQ2_0 and BF16 writes zllm's
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
    """The repeated d is exact, so the loaded weight equals both zllm's
    repacked one and ggml's decoder."""
    import jax.numpy as jnp

    from zllm.quant import blocks as zqb
    from zllm_torch.quant.repack import TernaryWeight

    qt, raw, w = weights
    assert isinstance(w, TernaryWeight) and w.fmt == qt.fmt
    assert np.array_equal(to_np(w.dequant()), np.asarray(qt.dequant(jnp.float32)))
    assert torch.equal(w.dequant_nk(), torch.from_numpy(zqb.dequantize(raw, qt.fmt).reshape(N, K)))
    assert set(w.int_codes().unique().tolist()) == {-1, 0, 1}
    c = _carried(qt)
    assert type(c) is type(w) and c.shape == w.shape
    assert all(torch.equal(p, w.planes()[name]) for name, p in c.planes().items())


@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
def test_random_bytes_load_as_zllm_repacks(fmt):
    """Random GGUF bytes: the loaded weight is zllm's repacked one (TQ1_0's
    base-3 digits decoded with uint8 wrap-around on both sides; TQ2_0's
    crumb 3, which no encoder writes, is the value 2 on both)."""
    import jax.numpy as jnp

    from zllm.quant import repack as zrp
    from zllm_torch.quant.repack import repack

    raw = _random_gguf(fmt, 256, K, seed=int(fmt))
    w = repack(raw, (256, K), fmt, "cpu")
    assert np.array_equal(to_np(w.dequant()), np.asarray(zrp.repack(raw, (256, K), fmt).dequant(
        jnp.float32)))


def test_tq1_0_digits_wrap_in_uint8():
    """Byte 0xFF's five digits: (255 * 3^j mod 256) * 3 >> 8, the product
    wrapped in uint8 (255, 253, 247, 229, 175 -> 2, 2, 2, 2, 2); without the
    wrap the digits would not be 0..2."""
    from zllm_torch.quant.blocks import tq1_0_codes

    qs = np.full((1, 48), 0xFF, np.uint8)
    qh = np.full((1, 4), 0xFF, np.uint8)
    codes = tq1_0_codes(qs, qh)
    assert codes.shape == (1, 256) and (codes == 2).all()
    qs[0, 0] = 0x55  # 85: 85, 255, 253, 247, 229 -> 0, 2, 2, 2, 2
    assert [int(codes_j) for codes_j in tq1_0_codes(qs, qh)[0, 0:160:32]] == [0, 2, 2, 2, 2]


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
    (bit for bit on the card: `tests/test_torch_cuda.py::
    test_k3_k5_rows_do_not_depend_on_m`)."""
    _, _, w = weights
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((512, K)).astype(np.float32))
    full = tq.dequant_gemm(x, w)
    for rows in (slice(0, 4), slice(508, 512)):
        assert nmse(tq.dequant_gemm(x[rows], w), full[rows]) < 1e-13


@pytest.mark.parametrize("hbm,dualdot", [(None, None), ("1", None), (None, "1"), ("1", "1")])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_dispatch_routes_to_k4_and_k5(weights, monkeypatch, hbm, dualdot, fuse):
    """Every prologue of TQ1_0 and TQ2_0 goes to K4, and a GEMM to K5,
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
    assert tq.fuses(w)


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
    stubbed: K4 and K5 get the format's code (TQ1_0 14, TQ2_0 15) and the
    planes qs, a, then None."""
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
    want = [w.qs.data_ptr(), w.a.data_ptr(), None]
    tq.int8_matvec(torch.ones(1, K, dtype=xdtype).to("meta"), w)
    tq.dequant_gemm(torch.ones(4, K, dtype=xdtype).to("meta"), w)
    (s1, a1), (s2, a2) = seen
    assert (s1, s2) == ("zt_int8_matvec", "zt_dequant_gemm")
    assert a1[0] == a2[0] == tq.INT8_FMT_CODE[w.fmt] == {GGMLType.TQ1_0: 14,
                                                          GGMLType.TQ2_0: 15}[w.fmt]
    assert list(a1[4:7]) == want and list(a2[4:7]) == want


# ---------------------------------------------------------------------------
# files and whole models
# ---------------------------------------------------------------------------

SHAPE = {k: v for k, v in SMALL_LLAMA.items() if k != "gtype"}
PROMPT = [1] + list(range(40, 59))  # 20 tokens: two 16-token prefill chunks
N_DECODE = 16
MODEL_FTYPES = ["TQ2_0", "TQ1_0", "BF16"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """TQ2_0, TQ1_0 and BF16 by zllm_torch.quantize from one F16 file, and
    the same presets by tools/quantize.py."""
    from tools.quantize import quantize_file as zquantize_file
    from zllm_torch.quantize import quantize_file

    folder = tmp_path_factory.mktemp("tq")
    src = f16_llama_gguf(str(folder / "f16.gguf"), seed=1)
    out = {}
    for ftype in MODEL_FTYPES:
        out[ftype] = str(folder / f"{ftype}.gguf")
        types = quantize_file(src, out[ftype], ftype, quiet=True)
        zquantize_file(src, str(folder / f"{ftype}.zllm.gguf"), ftype, quiet=True)
        if ftype == "BF16":
            assert {t for _, t, _ in types.values()} == {"BF16", "F32"}
        else:
            assert types["output.weight"][1] == "Q6_K"
            assert types["token_embd.weight"][1] == "Q4_K"
            assert types["blk.1.attn_v.weight"][1] == ftype
    return out


@pytest.mark.parametrize("ftype", MODEL_FTYPES)
def test_quantize_writes_tools_bytes(files, ftype):
    ours = files[ftype]
    theirs = ours.replace(".gguf", ".zllm.gguf")
    assert os.path.getsize(ours) == os.path.getsize(theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


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
    """TQ: K4's and K5's plain versions for the ternary weights (fused
    wqkv and gate|up), tolerance 2e-4 (the W4A8 path's int8 activation
    rounding, as for the other K4 formats); BF16: dense BF16 weights in
    the model dtype, no quantized kernel, tolerance 1e-5."""
    from zllm_torch.models.loader import Model
    from zllm_torch.quant.repack import TernaryWeight
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
    if ftype == "BF16":
        for key in ("wqkv", "wo", "ffn_gateup", "ffn_down"):
            assert isinstance(layer[key], torch.Tensor) and layer[key].dtype == torch.float32
        assert isinstance(m.params["output"], torch.Tensor)
        tol = 1e-5
    else:
        assert isinstance(layer["wqkv"], TernaryWeight) and layer["wqkv"].fmt.name == ftype
        assert isinstance(layer["ffn_gateup"], TernaryWeight)
        tol = 2e-4
    gen = Generator(m, max_len=256, prefill_chunk=16, kv_dtype=torch.float32)
    tlog = [to_np(gen.prefill(PROMPT))]
    toks = [int(np.argmax(tlog[0]))]
    for i in range(N_DECODE):  # fed zllm's tokens; the port's own greedy picks recorded
        tlog.append(to_np(gen._decode_one(ztoks[i], len(PROMPT) + i)))
        toks.append(int(np.argmax(tlog[-1])))
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (SHAPE["vocab_size"],)
        assert nmse(a, b) <= tol, f"step {step}: nmse {nmse(a, b)}"
    if ftype == "BF16":
        assert launched == {"int8_matvec": 0, "dequant_gemm": 0}
    else:
        assert launched["int8_matvec"] > 0 and launched["dequant_gemm"] > 0
    assert toks == ztoks
    gen.reset()
    free = gen.generate(PROMPT, max_new=N_DECODE + 1)
    assert free.tokens == ztoks


def test_bf16_weights_load_dense_in_the_model_dtype(files):
    """A BF16 matmul weight is decoded to f32 and kept dense [K, N] in the
    model dtype, as zllm keeps it (bf16 model: the file's values exactly);
    the embedding likewise."""
    from zllm_torch.gguf.reader import read_gguf
    from zllm_torch.models.loader import Model

    m = Model.load(files["BF16"], device="cpu", dtype=torch.bfloat16)
    with read_gguf(files["BF16"]) as f:
        wo = torch.from_numpy(np.ascontiguousarray(f.tensor_f32("blk.0.attn_output.weight").T))
        emb = torch.from_numpy(f.tensor_f32("token_embd.weight"))
    got = m.params["layers"][0]["wo"]
    assert got.dtype == torch.bfloat16 and got.shape == wo.shape
    assert torch.equal(got.float(), wo)  # BF16 values are bf16 values
    assert m.params["tok_emb"].dtype == torch.bfloat16 and torch.equal(
        m.params["tok_emb"].float(), emb)


@pytest.mark.parametrize("ftype", MODEL_FTYPES)
def test_factory_ftype_writes_the_presets_types(tmp_path, ftype):
    """make_llama_gguf(ftype=...) writes each tensor in `pick_type`'s type
    for its role (TQ: the embedding Q4_K, the head Q6_K, every other matmul
    in the type; BF16: every matrix), encoded as the port encodes it."""
    from zllm_torch.gguf.reader import read_gguf
    from zllm_torch.quantize import FTYPES, pick_type
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "m.gguf"), **SHAPE, ftype=ftype, seed=3)
    with read_gguf(path) as f:
        for name, meta in f.tensors.items():
            il = int(name.split(".")[1]) if name.startswith("blk.") else 0
            assert meta.gtype == pick_type(name, meta.shape, il, SHAPE["n_layers"],
                                           FTYPES[ftype]), name
        types = {meta.gtype.name for meta in f.tensors.values()}
    assert types == ({"BF16", "F32"} if ftype == "BF16" else {ftype, "Q4_K", "Q6_K", "F32"})
