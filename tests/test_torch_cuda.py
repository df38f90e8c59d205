"""The port's CUDA kernels against their plain PyTorch versions, on the
card, over the variants the main path does not reach (dtypes, formats,
head dims, batch rows, sinks, windows, softcap, ragged M and N, the padded
head, trash rows).

Marked `cuda`: skipped where no CUDA device is visible.  Run on a GPU host
(which needs no JAX) with:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: K1/K4 nmse < 1e-6 (exact integer dots; only f32 sum order, and
an ulp of rsqrt/exp may move one int8 code), K3/K5 < 1e-6 (bf16 operands,
f32 sum order; both on one sliced loop, their rows equal bit for bit
whatever M and form), K2/K6 <
1e-5 (f32 sum order, then one bf16 rounding of a probability may move by
an ulp), K9/K10 < 1e-6, K7 and K8 < 1e-6 (1e-5
with a bf16 q, whose output rounds to bf16), and K12 equal to K1's kernel
bit for bit (each lane does K1's arithmetic in K1's order) and < 1e-6
against the plain version; K1/K3/K12 hold the same tolerances in their
Q4_0/Q4_1 forms, K11 < 1e-6 (exact integer dots, f32 sum order) against
its plain version and equal to K1's kernel bit for bit (K1's lane order
and epilogue), and `quantize_acts` is bit-equal to `quantize_groups`
(rintf and torch.round both round half to even); K1 and K3 hold the same
tolerances in their Q5_0/Q5_1/Q5_K forms (the fifth bits from the qh
plane), and 2-layer Q5 files run on the card within nmse 1e-3 of the CPU
(f32 model and caches); K4 and K5 hold theirs in the Q2_K, Q3_K, IQ4_NL,
IQ4_XS and MXFP4 forms (table lookups by byte permutes, MXFP4's E8M0
scale from its bits) and in the IQ grid forms (IQ2_XXS, IQ2_XS, IQ2_S,
IQ3_XXS, IQ3_S and IQ1_S on both, IQ1_M on K5 alone; weights of random
code bytes) and the ternary TQ1_0 and TQ2_0 forms, and 2-layer files in
those formats (and a BF16 one, dense) run on the card within nmse 1e-3 of
the CPU; K8 holds its tolerance over f16 caches too (its f16 form).
The IQ grid fit on the card (`quant/iq_encode.py`) keeps at least 99 % of
the CPU fit's 256-blocks and its weighted error within 0.1 %, and the
imatrix collection on the card (K5, K6) keeps each tensor's sums within
nmse 1e-6 of the plain versions' (f32 model).  The q8 cache's quantize on
the card gives the CPU's codes and scales bit for bit, and so does a slot
file requantized into a card cache.  A speculative verify step's columns
(the T=1 kernel once a column: K2, K8, K9, K7's split form) equal the
decode steps at their positions bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from zllm_torch.gguf.constants import GGMLType
from zllm_torch.ops import attention as ta
from zllm_torch.ops import layers as tl
from zllm_torch.ops import qmatmul as tq
from zllm_torch.quant import blocks as qb
from zllm_torch.quant.repack import pad_n, repack
from zllm_torch.testing import IQ_GRID_TYPES, random_iq_blocks

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _nmse(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean() / ((b ** 2).mean() + 1e-30))


@functools.lru_cache(maxsize=16)
def _qweight_raw(n: int, k: int, seed: int, fmt) -> np.ndarray:
    """The GGUF rows of `_qweight`'s and `_int_weight`'s weights (quantized
    once a module; an IQ grid format, which the port cannot encode, as
    random code bytes of that RMS)."""
    rng = np.random.default_rng(seed)
    if fmt in IQ_GRID_TYPES:
        return random_iq_blocks(fmt, n * k // 256, rng, 0.05).reshape(n, -1)
    return qb.quantize(rng.standard_normal((n, k)).astype(np.float32) * 0.05, fmt)


def _qweight(n: int, k: int, seed: int, dev, fmt=GGMLType.Q4_K, n_pad: int = 0):
    """A random weight of a nibble format (Q4_K, Q4_0, Q4_1, Q5_0, Q5_1,
    Q5_K); `n_pad` > n zero-pads it as the loader pads the head."""
    w = repack(_qweight_raw(n, k, seed, fmt), (n, k), fmt, dev)
    return pad_n(w, n_pad) if n_pad else w


def _randn(shape, seed, dev, dtype=torch.float32, scale=1.0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
@pytest.mark.parametrize("k,n", [(256, 40), (2048, 2560), (5632, 2048), (8960, 1536)])
def test_k1_matches_plain(dev, k, n, fuse, xdtype):
    w = _qweight(n, k, k + n, dev)
    x = _randn((1, 2 * k if fuse == "glu" else k), 1, dev, xdtype, scale=2.0)
    aux = _randn((k,), 2, dev, scale=0.1) + 1.0 if fuse == "norm" else None
    before = tq.q4k_matvec.launches
    got = tq.q4k_matvec(x, w, fuse, aux, 1e-5)
    torch.cuda.synchronize()
    assert tq.q4k_matvec.launches == before + 1
    assert _nmse(got, tq.q4k_matvec_plain(x, w, fuse, aux, 1e-5)) < 1e-6


# K3's cases (m, k, n, n_pad): ragged N, K5's M range (4, 16, 17, 37, 128,
# 300, 512: both forms, split and not) and the models' shapes (wk 2048->256,
# gate|up 2048->11264, ffn_down 5632->2048 and OLMo-2's 8192->2048, the head
# 2048->32000 padded to 32768)
K3_CASES = [(1, 256, 64, 0), (7, 512, 200, 0), (64, 2048, 2560, 0), (256, 5632, 2048, 0),
            (256, 2048, 32768, 0), (37, 512, 200, 0), (300, 2048, 200, 0),
            (4, 2048, 256, 0), (4, 2048, 2048, 0), (4, 2048, 11264, 0), (4, 5632, 2048, 0),
            (4, 8192, 2048, 0), (4, 2048, 32000, 32768), (16, 2048, 256, 0),
            (17, 768, 256, 0), (37, 5632, 2048, 0), (128, 5632, 2048, 0),
            (256, 2048, 11264, 0), (256, 8192, 2048, 0), (300, 2048, 32000, 32768),
            (512, 768, 384, 0), (512, 2048, 256, 0), (512, 2048, 2560, 0),
            (3, 1024, 202, 0),  # M*N not a multiple of 4, split slices
            (4, 8960, 1536, 0), (256, 8960, 1536, 0)]  # Qwen2.5-1.5B's ffn_down


def _k3_case(dev, m, k, n, n_pad, xdtype, fmt):
    w = _qweight(n, k, m + k + n, dev, fmt, n_pad)
    x = _randn((m, k), 3, dev, xdtype)
    before = tq.q4k_gemm.launches
    got = tq.q4k_gemm(x, w)
    torch.cuda.synchronize()
    assert tq.q4k_gemm.launches == before + 1 and got.shape == (m, w.shape[1])
    assert _nmse(got, tq.q4k_gemm_plain(x, w)) < 1e-6
    if n_pad:
        assert not got[:, n:].any()


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n,n_pad", K3_CASES)
def test_k3_matches_plain(dev, m, k, n, n_pad, xdtype):
    _k3_case(dev, m, k, n, n_pad, xdtype, GGMLType.Q4_K)


def test_k3_refuses_odd_n(dev):
    """The sliced loop stores column pairs: an odd N raises before any
    launch (the CPU's plain version takes it)."""
    w = _qweight(65, 256, 7, dev)
    before = tq.q4k_gemm.launches
    with pytest.raises(ValueError, match="even N"):
        tq.q4k_gemm(_randn((4, 256), 3, dev), w)
    assert tq.q4k_gemm.launches == before


INT_FMTS = [GGMLType.Q6_K, GGMLType.Q8_0]
LOWBIT_FMTS = [GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.MXFP4]
IQ_FMTS = list(IQ_GRID_TYPES)  # IQ1_M (last) on K5 alone
TQ_FMTS = [GGMLType.TQ1_0, GGMLType.TQ2_0]
K5_FMTS = [*INT_FMTS, *LOWBIT_FMTS, *IQ_FMTS, *TQ_FMTS]
K4_FMTS = [f for f in K5_FMTS if f != GGMLType.IQ1_M]


def _int_weight(fmt, n: int, k: int, seed: int, dev, n_pad: int = 0):
    """A random weight of a K4/K5 format (Q6_K, Q8_0, Q2_K, Q3_K, IQ4_NL,
    IQ4_XS, MXFP4, the IQ grid formats, TQ1_0, TQ2_0); `n_pad` > n
    zero-pads it as the loader pads the head."""
    w = repack(_qweight_raw(n, k, seed, fmt), (n, k), fmt, dev)
    return pad_n(w, n_pad) if n_pad else w


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
@pytest.mark.parametrize("fmt", K4_FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("k,n,n_pad", [(256, 128, 0), (2048, 256, 0), (2048, 2048, 0),
                                       (5632, 2048, 0), (2048, 32000, 32768), (8960, 1536, 0)])
def test_k4_matches_plain(dev, k, n, n_pad, fmt, fuse, xdtype):
    w = _int_weight(fmt, n, k, k + n, dev, n_pad)
    x = _randn((1, 2 * k if fuse == "glu" else k), 1, dev, xdtype, scale=2.0)
    aux = _randn((k,), 2, dev, scale=0.1) + 1.0 if fuse == "norm" else None
    before = tq.int8_matvec.launches
    got = tq.int8_matvec(x, w, fuse, aux, 1e-5)
    torch.cuda.synchronize()
    assert tq.int8_matvec.launches == before + 1
    assert _nmse(got, tq.int8_matvec_plain(x, w, fuse, aux, 1e-5)) < 1e-6
    if n_pad:
        assert not got[:, n:].any()


K5_CASES = [(1, 256, 128, 0), (7, 512, 384, 0), (64, 2048, 256, 0), (256, 5632, 2048, 0),
            (256, 2048, 32000, 32768), (4, 768, 384, 0), (4, 2048, 256, 0), (4, 5632, 2048, 0),
            (4, 2048, 32000, 32768), (16, 2048, 256, 0), (17, 768, 256, 0), (128, 5632, 2048, 0),
            (256, 2048, 256, 0), (512, 768, 384, 0), (512, 2048, 256, 0), (37, 5632, 2048, 0),
            (300, 2048, 32000, 32768), (4, 8960, 1536, 0), (256, 8960, 1536, 0)]
# the low-bit formats on nine of them (their numpy encoders are slower)
LOWBIT_K5_CASES = [(1, 256, 128, 0), (4, 2048, 256, 0), (4, 5632, 2048, 0), (7, 512, 384, 0),
                   (64, 2048, 256, 0), (256, 5632, 2048, 0), (256, 2048, 32000, 32768),
                   (37, 5632, 2048, 0), (512, 768, 384, 0)]


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n,n_pad,fmt",
                         [(*c, f) for f in INT_FMTS for c in K5_CASES]
                         + [(*c, f) for f in LOWBIT_FMTS + IQ_FMTS + TQ_FMTS
                            for c in LOWBIT_K5_CASES],
                         ids=lambda v: v.name if isinstance(v, GGMLType) else None)
def test_k5_matches_plain(dev, m, k, n, n_pad, fmt, xdtype):
    w = _int_weight(fmt, n, k, m + k + n, dev, n_pad)
    x = _randn((m, k), 3, dev, xdtype)
    before = tq.dequant_gemm.launches
    got = tq.dequant_gemm(x, w)
    torch.cuda.synchronize()
    assert tq.dequant_gemm.launches == before + 1
    assert got.shape == (m, w.shape[1])
    assert _nmse(got, tq.dequant_gemm_plain(x, w)) < 1e-6
    if n_pad:
        assert not got[:, n:].any()


Q5_FMTS = [GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q5_K]
SLICE_FMTS = [GGMLType.Q4_K, GGMLType.Q4_0, GGMLType.Q4_1, *Q5_FMTS, *K5_FMTS]


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", SLICE_FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("k,n", [(2048, 256), (5632, 2048), (768, 384)])
def test_k3_k5_rows_do_not_depend_on_m(dev, k, n, fmt, xdtype):
    """K3 (Q4_K, Q4_0, Q4_1, Q5_0, Q5_1, Q5_K) and K5 (Q6_K, Q8_0, Q2_K,
    Q3_K, IQ4_NL, IQ4_XS, MXFP4, the IQ grid formats, TQ1_0, TQ2_0) sum every row slice
    by slice in zllm's
    order, so its bits do not depend on M or on the form (row form M <= 16,
    tile form above, the slices split over blocks or not), and repeated
    calls agree."""
    w = (_int_weight(fmt, n, k, k + n, dev) if fmt in K5_FMTS
         else _qweight(n, k, k + n, dev, fmt))
    x = _randn((512, k), 6, dev, xdtype)
    full = tq.gemm(x, w)
    assert torch.equal(tq.gemm(x[:4], w), full[:4])
    assert torch.equal(tq.gemm(x[508:], w), full[508:])
    assert torch.equal(tq.gemm(x[:16], w), tq.gemm(x[:17], w)[:16])
    assert torch.equal(tq.gemm(x[:37], w), full[:37])
    assert torch.equal(tq.gemm(x, w), full)
    torch.cuda.synchronize()


# GGUF block bytes of the nibble formats: (block bytes, offsets of the fp16
# scales) -- Q4_K d, dmin then 12 scale bytes and 128 of codes; Q4_0 d then
# 16 of codes; Q4_1 d, m then 16 of codes; Q5_0 d, 4 bytes of fifth bits,
# 16 of codes; Q5_1 d, m, 4 + 16; Q5_K d, dmin, 12 scale bytes, 32 of fifth
# bits and 128 of codes
NIBBLE_BLOCKS = {GGMLType.Q4_K: (144, (0, 2)), GGMLType.Q4_0: (18, (0,)),
                 GGMLType.Q4_1: (20, (0, 2)), GGMLType.Q5_0: (22, (0,)),
                 GGMLType.Q5_1: (24, (0, 2)), GGMLType.Q5_K: (176, (0, 2))}


@pytest.mark.parametrize("m,n", [(4, 200), (32, 256), (256, 4096)])
@pytest.mark.parametrize("fmt", list(NIBBLE_BLOCKS), ids=lambda t: t.name)
def test_k3_random_blocks(dev, fmt, m, n):
    """Random bytes in every code, fifth-bit and 6-bit scale position (the K
    formats' 12 packed scale bytes too), fp16 scales drawn from a finite
    range, held column by column: a nibble, fifth-bit, slot or scale-word
    slip shows in the columns it hits.  M = 4 and 32 run the row form, 256 x
    4096 the tile form."""
    k = 2048
    size, scales = NIBBLE_BLOCKS[fmt]
    rng = np.random.default_rng(9 + size)
    per_block = 256 if fmt in (GGMLType.Q4_K, GGMLType.Q5_K) else 32
    raw = rng.integers(0, 256, size=(n * k // per_block, size), dtype=np.uint8)
    for off in scales:
        vals = rng.uniform(0.002, 0.02, size=raw.shape[0]).astype(np.float16)
        raw[:, off:off + 2] = vals.view(np.uint8).reshape(-1, 2)
    w = repack(raw.reshape(n, -1), (n, k), fmt, dev)
    x = _randn((m, k), 5, dev)
    got, want = tq.q4k_gemm(x, w), tq.q4k_gemm_plain(x, w)
    col_err = ((got - want) ** 2).sum(0) / ((want ** 2).sum(0) + 1e-30)
    assert float(col_err.max()) < 1e-6


def test_k4_k5_q6k_random_blocks(dev):
    """Random Q6_K bytes (every nibble and crumb position, signed scales),
    held column by column: a bit-order slip shows in the columns it hits."""
    n, k = 256, 2048
    raw = np.random.default_rng(8).integers(0, 256, size=(n * k // 256, 210), dtype=np.uint8)
    raw[:, 208:210] = np.frombuffer(np.float16(0.01).tobytes(), np.uint8)
    w = repack(raw.reshape(n, -1), (n, k), GGMLType.Q6_K, dev)
    x = _randn((1, k), 4, dev)
    got, want = tq.int8_matvec(x, w), tq.int8_matvec_plain(x, w)
    # exact integer dots: only the f32 sum order differs in any column
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    xm = _randn((32, k), 5, dev)
    got, want = tq.dequant_gemm(xm, w), tq.dequant_gemm_plain(xm, w)
    col_err = ((got - want) ** 2).sum(0) / ((want ** 2).sum(0) + 1e-30)
    assert float(col_err.max()) < 1e-6


@pytest.mark.parametrize("cdtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32c", "bf16c", "f16c"])
@pytest.mark.parametrize("case", ["plain", "qknorm", "softcap", "window", "b2", "d128",
                                  "norm_style", "partial", "trash", "pos0", "bf16q", "qwen3",
                                  "g6_d128", "partial_neox", "partial_neox_d64", "g12_d128"])
def test_k2_matches_plain(dev, case, cdtype):
    """`qwen3`: Qwen3-1.7B's block (16 / 8 heads of 128, per-head q/k
    norms, neox rope); `g6_d128`: Qwen2.5-1.5B's (12 / 2 heads of 128: a
    group of 6 leaves 2 of a block's 8 query rows idle); `partial_neox`:
    Pythia-1.4B's (16 / 16 heads of 128, neox rope over 32 dims, the other
    96 passed through); `partial_neox_d64`: StableLM-2-1.6B's (32 / 32
    heads of 64, neox rope over 16); `g12_d128`: StarCoder2-3B's (24 / 2
    heads of 128: a group of 12 fills one block of 8 query rows and 4 of a
    second)."""
    b = 2 if case == "b2" else 1
    d = 128 if case in ("d128", "qwen3", "g6_d128", "partial_neox", "g12_d128") else 64
    hq, hkv, s = {"qwen3": (16, 8), "g6_d128": (12, 2), "partial_neox": (16, 16),
                  "partial_neox_d64": (32, 32), "g12_d128": (24, 2)}.get(case, (32, 4)) + (512,)
    style = "norm" if case in ("norm_style", "partial") else "neox"
    rot = {"partial": 32, "partial_neox": 32, "partial_neox_d64": 16}.get(case, d)
    rope = tl.RopeParams(dim=rot, style=style)
    pos_vals = {"trash": [s], "pos0": [0], "b2": [5, 400]}.get(case, [331])
    qdtype = torch.bfloat16 if case == "bf16q" else torch.float32
    qkv3 = _randn((b, hq + 2 * hkv, d), 4, dev, qdtype)
    kc = _randn((b, hkv, s, d), 5, dev, cdtype)
    vc = _randn((b, hkv, s, d), 6, dev, cdtype)
    qw = _randn((d,), 7, dev) if case in ("qknorm", "qwen3") else None
    kw = _randn((d,), 8, dev) if case in ("qknorm", "qwen3") else None
    pos = torch.tensor(pos_vals, dtype=torch.int32, device=dev)
    rt = tl.rope_table(pos, rope, d)
    kw_args = dict(scale=d ** -0.5, softcap=30.0 if case == "softcap" else 0.0,
                   window=48 if case == "window" else 0, eps=1e-5)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before_f16 = ta.attn_decode_qkv.f16_launches
    got = ta.attn_decode_qkv(qkv3, k1, v1, pos, rt, qw, kw, **kw_args)
    want = ta.attn_decode_qkv_plain(qkv3, k2, v2, pos, rt, qw, kw, **kw_args)
    torch.cuda.synchronize()
    assert ta.attn_decode_qkv.f16_launches == before_f16 + (cdtype == torch.float16)
    assert got.dtype == qdtype and got.shape == (b, 1, hq, d)
    assert _nmse(got.float(), want.float()) < 1e-5
    assert torch.equal(v1, v2)
    assert _nmse(k1.float(), k2.float()) < 1e-9


@pytest.mark.parametrize("cdtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32c", "bf16c", "f16c"])
@pytest.mark.parametrize("style", ["norm", "neox", "neox_r16"])
def test_k2_rope_equals_apply_rope(dev, style, cdtype):
    """K2's in-kernel rope of the new k row gives apply_rope's bits (cast to
    the cache dtype), so a mixed step's re-insert of slot pos0 through K2
    (models/llama.py) leaves a prompt row's slot as kv.update wrote it;
    `neox_r16`: neox rope over 16 of the 64 dims (StableLM-2's), the other
    48 inserted as they came."""
    b, hq, hkv, d, s = 4, 32, 4, 64, 2176
    qkv3 = _randn((b, hq + 2 * hkv, d), 13, dev, scale=3.0)
    kc = _randn((b, hkv, s, d), 14, dev, cdtype)
    vc = _randn((b, hkv, s, d), 15, dev, cdtype)
    pos = torch.tensor([0, 256, 300, 2048], dtype=torch.int32, device=dev)
    rope = tl.RopeParams(dim=16 if style == "neox_r16" else d, style=style[:4])
    ta.attn_decode_qkv(qkv3, kc, vc, pos, tl.rope_table(pos, rope, d), scale=d ** -0.5)
    want = tl.apply_rope(qkv3[:, None, hq:hq + hkv], pos[:, None], rope).to(cdtype)
    torch.cuda.synchronize()
    rows = torch.arange(b, device=dev)
    assert torch.equal(kc[rows, :, pos.long()], want[:, 0])


K6_SHAPES = {"tinyllama": (32, 4, 64), "olmo2": (16, 16, 128),  # Hq, Hkv, D
             "qwen25": (12, 2, 128), "qwen3": (16, 8, 128), "starcoder2": (24, 2, 128)}


@pytest.mark.parametrize("kvdtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32kv", "bf16kv", "f16kv"])
@pytest.mark.parametrize("case", ["plain", "sinks", "softcap", "window", "base0", "b2",
                                  "d128", "ragged", "bf16q", "olmo2", "qwen25", "qwen3",
                                  "starcoder2"])
def test_k6_matches_plain(dev, case, kvdtype):
    b = 2 if case == "b2" else 1
    d = 128 if case == "d128" else 64
    t = 37 if case == "ragged" else 256
    hq, hkv, s = 32, 4, 1024
    if case in K6_SHAPES:  # OLMo-2-0425-1B: G = 1; Qwen2.5: G = 6; StarCoder2-3B: G = 12
        hq, hkv, d = K6_SHAPES[case]
    base = 0 if case == "base0" else 256
    qdtype = torch.bfloat16 if case == "bf16q" else torch.float32
    q = _randn((b, t, hq, d), 9, dev, qdtype)
    k = _randn((b, hkv, s, d), 10, dev, kvdtype)
    v = _randn((b, hkv, s, d), 11, dev, kvdtype)
    positions = (base + torch.arange(t, device=dev, dtype=torch.int32))[None].repeat(b, 1)
    if case == "b2":
        positions[1] += 300
    kw_args = dict(scale=d ** -0.5, softcap=30.0 if case == "softcap" else 0.0,
                   window=100 if case == "window" else 0,
                   sinks=_randn((hq,), 12, dev) if case == "sinks" else None)
    got = ta.flash_attention(q, k, v, positions, **kw_args)
    want = ta.flash_attention_plain(q, k, v, positions, **kw_args)
    torch.cuda.synchronize()
    assert got.dtype == qdtype and got.shape == q.shape
    assert _nmse(got.float(), want.float()) < 1e-5


def _k6_inputs(dev, shape, b, t, s, qdtype, kvdtype, seed):
    hq, hkv, d = K6_SHAPES[shape]
    return (_randn((b, t, hq, d), seed, dev, qdtype),
            _randn((b, hkv, s, d), seed + 1, dev, kvdtype),
            _randn((b, hkv, s, d), seed + 2, dev, kvdtype), d ** -0.5)


@pytest.mark.parametrize("kvdtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32kv", "bf16kv", "f16kv"])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16], ids=["f32q", "bf16q"])
@pytest.mark.parametrize("shape", list(K6_SHAPES))
@pytest.mark.parametrize("window", [0, 100])
def test_k6_rows_do_not_depend_on_t_or_b(dev, window, shape, qdtype, kvdtype):
    """A row's bits depend on its q, its position and the cache only: the
    rows of a T = 44 call equal the first 44 rows of a T = 128 call from the
    same pos0, and row b of a B = 4 call (rows from 0, 256, 300 and an idle
    row at 2048) equals a B = 1 call on that row, bit for bit."""
    s = 2176
    q, k, v, scale = _k6_inputs(dev, shape, 4, 128, s, qdtype, kvdtype, 20)
    starts = torch.tensor([0, 256, 300, 2048], dtype=torch.int32, device=dev)
    pos = starts[:, None] + torch.arange(128, dtype=torch.int32, device=dev)[None]
    kw = dict(scale=scale, window=window)
    full = ta.flash_attention(q, k, v, pos, **kw)
    short = ta.flash_attention(q[:, :44].contiguous(), k, v, pos[:, :44], **kw)
    torch.cuda.synchronize()
    assert torch.equal(short, full[:, :44])
    for r in range(4):
        one = ta.flash_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1], pos[r:r + 1], **kw)
        torch.cuda.synchronize()
        assert torch.equal(one[0], full[r])


@pytest.mark.parametrize("kvdtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32kv", "bf16kv", "f16kv"])
def test_k6_counts_tensor_core_launches(dev, kvdtype):
    """bf16 and f16 K/V take the tensor-core form and count in
    `.mma_launches`; f32 K/V take the tile loop and do not."""
    q, k, v, scale = _k6_inputs(dev, "tinyllama", 1, 64, 512, torch.float32, kvdtype, 30)
    pos = torch.arange(64, dtype=torch.int32, device=dev)[None]
    before = (ta.flash_attention.launches, ta.flash_attention.mma_launches,
              ta.flash_attention.f16_launches)
    ta.flash_attention(q, k, v, pos, scale=scale)
    torch.cuda.synchronize()
    mma = int(kvdtype != torch.float32)
    assert (ta.flash_attention.launches, ta.flash_attention.mma_launches,
            ta.flash_attention.f16_launches) == (before[0] + 1, before[1] + mma,
                                                  before[2] + (kvdtype == torch.float16))


def _paged_inputs(b, hkv, d, lp, ps, pdtype, dev, seed):
    """Random pools [Hkv, P*ps, D] and a table whose pages are scrambled
    (physical != logical), with the trash page 0 pinned in the last column."""
    n_pages = b * lp + 1
    k_pool = _randn((hkv, n_pages * ps, d), seed, dev, pdtype)
    v_pool = _randn((hkv, n_pages * ps, d), seed + 1, dev, pdtype)
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    table = np.zeros((b, lp + 1), np.int32)
    table[:, :lp] = perm.reshape(b, lp)
    return k_pool, v_pool, torch.from_numpy(table).to(dev)


@pytest.mark.parametrize("qdtype,pdtype", [(torch.float32, torch.float32),
                                           (torch.float32, torch.bfloat16),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.float16),
                                           (torch.bfloat16, torch.float16)],
                         ids=["f32-f32", "f32-bf16", "bf16-bf16", "f32-f16", "bf16-f16"])
@pytest.mark.parametrize("case", ["chunk", "t1", "window", "softcap", "d128", "ragged",
                                  "g1", "trash_row", "ps64", "ps256", "g16", "idle_first",
                                  "gen_row", "g6_d128", "g12_d128"])
def test_k10_matches_plain(dev, case, qdtype, pdtype):
    """Horizon 1024 slots (ps 64, 128 or 256); bf16 and f16 pools take the
    tensor-core loop, f32 pools the tile loop.  `idle_first`: the engine's
    idle row (pos0 = horizon) is row 0; `gen_row`: a mixed step's generating
    row, its one real token in column 0 and trash positions after it."""
    b, hq, hkv = 3, 32, 4
    ps = {"ps64": 64, "ps256": 256}.get(case, 128)
    lp = 1024 // ps
    d = 128 if case in ("d128", "g6_d128", "g12_d128") else 64
    if case == "g1":
        hq = hkv
    if case == "g6_d128":  # Qwen2.5-1.5B: 12 / 2 heads of 128
        hq, hkv = 12, 2
    if case == "g12_d128":  # StarCoder2-3B: 24 / 2 heads of 128
        hq, hkv = 24, 2
    if case == "g16":
        hq = 16 * hkv
    t = {"t1": 1, "ragged": 37}.get(case, 128)
    q = _randn((b, t, hq, d), 20, dev, qdtype)
    k_pool, v_pool, table = _paged_inputs(b, hkv, d, lp, ps, pdtype, dev, 21)
    starts = torch.tensor([0, 300, 1000], dtype=torch.int32, device=dev)
    if case == "trash_row":
        starts[2] = lp * ps  # the engine's idle row
    if case == "idle_first":
        starts[0] = lp * ps
    if case == "gen_row":
        starts[1] = 777
    positions = starts[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None]
    kw = dict(page_size=ps, scale=d ** -0.5, softcap=30.0 if case == "softcap" else 0.0,
              window=200 if case == "window" else 0)
    before = ta.paged_attention.launches
    before_mma = ta.paged_attention.mma_launches
    before_f16 = ta.paged_attention.f16_launches
    got = ta.paged_attention(q, k_pool, v_pool, table, positions, **kw)
    want = ta.paged_attention_plain(q, k_pool, v_pool, table, positions, **kw)
    torch.cuda.synchronize()
    assert ta.paged_attention.launches == before + 1
    assert ta.paged_attention.f16_launches == before_f16 + (pdtype == torch.float16)
    assert ta.paged_attention.mma_launches == before_mma + (pdtype != torch.float32)
    assert got.dtype == qdtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    live = (starts < lp * ps).cpu()
    assert _nmse(got[live].float(), want[live].float()) < 1e-6
    if case == "gen_row":
        assert _nmse(got[1, 0].float(), want[1, 0].float()) < 1e-6


@pytest.mark.parametrize("qdtype,pdtype", [(torch.float32, torch.float32),
                                           (torch.float32, torch.bfloat16),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.float16),
                                           (torch.bfloat16, torch.float16)],
                         ids=["f32-f32", "f32-bf16", "bf16-bf16", "f32-f16", "bf16-f16"])
@pytest.mark.parametrize("case", ["serve", "page_edge", "start", "window", "softcap", "d128",
                                  "g4", "g16", "long", "ps64_window_softcap", "s8320",
                                  "window_mid", "s20480", "g6_d128", "g12_d128"])
def test_k9_matches_plain(dev, case, qdtype, pdtype):
    """Positions include a page edge, 0, a mid-page one and a trash row; the
    pools must come out bit-identical outside the trash page 0.  With bf16
    pools the plain version rounds exp(s - running max) a page at a time.
    The cluster's cases: 65 pages a row (s8320: a row at 8000 spans more
    pages than the 8 blocks share evenly), a window whose span starts
    mid-page, and 160 pages (s20480: more scores than a block keeps, so the
    later pages' scores are recomputed).  With G = 16 two clusters share a
    (row, kv head) and only query group 0's writes the pool: the pools must
    hold the one rounded row the plain version writes."""
    b, hq, hkv, lp, ps = 4, 32, 4, 16, 128
    if case == "ps64_window_softcap":
        lp, ps = 32, 64
    if case == "s8320":
        lp = 65
    if case == "s20480":
        lp = 160
    d = 128 if case in ("d128", "g6_d128", "g12_d128") else 64
    if case == "g4":
        hq = 16
    if case == "g6_d128":  # Qwen2.5-1.5B: 12 / 2 heads of 128
        hq, hkv = 12, 2
    if case == "g12_d128":  # StarCoder2-3B: 24 / 2 heads (a group of 12: two chunks of 8)
        hq, hkv = 24, 2
    if case == "g16":  # a group wider than a block's 8 query rows: two chunks
        hq = 64
    pos_vals = {"page_edge": [127, 128, 255, lp * ps],
                "start": [0, 1, 2, lp * ps],
                "long": [lp * ps - 1, 1500, 2000, 3],
                "s8320": [8000, 4100, 0, lp * ps],
                "window_mid": [1000, 777, 2047, lp * ps],
                "s20480": [20000, 10000, 3, lp * ps]}.get(case, [0, 300, 1000, lp * ps])
    positions = torch.tensor(pos_vals, dtype=torch.int32, device=dev)[:, None]
    q = _randn((b, 1, hq, d), 30, dev, qdtype)
    kn = _randn((b, 1, hkv, d), 31, dev, qdtype)
    vn = _randn((b, 1, hkv, d), 32, dev, qdtype)
    k_pool, v_pool, table = _paged_inputs(b, hkv, d, lp, ps, pdtype, dev, 33)
    k2, v2 = k_pool.clone(), v_pool.clone()
    window = {"window": 300, "ps64_window_softcap": 300, "window_mid": 333}.get(case, 0)
    kw = dict(page_size=ps, scale=d ** -0.5,
              softcap=30.0 if case in ("softcap", "ps64_window_softcap") else 0.0,
              window=window)
    before = ta.paged_attn_decode_update.launches
    before_f16 = ta.paged_attn_decode_update.f16_launches
    got = ta.paged_attn_decode_update(q, kn, vn, k_pool, v_pool, table, positions, **kw)
    want = ta.paged_attn_decode_update_plain(q, kn, vn, k2, v2, table, positions, **kw)
    torch.cuda.synchronize()
    assert ta.paged_attn_decode_update.launches == before + 1
    assert ta.paged_attn_decode_update.f16_launches == before_f16 + (pdtype == torch.float16)
    assert got.dtype == qdtype and got.shape == q.shape
    live = positions[:, 0] < lp * ps
    assert _nmse(got[live].float(), want[live].float()) < 1e-6
    assert torch.equal(k_pool[:, ps:], k2[:, ps:]) and torch.equal(v_pool[:, ps:], v2[:, ps:])
    assert torch.equal(k_pool[:, :ps], k2[:, :ps])  # no row writes the trash page


# K7: (T, G, D, S, row starts, window, softcap, sinks, q dtype); S = 2176 is
# the engine's q8 cache (max_len 2048 + chunk 128), row start 2048 its
# trash row; R = T * G <= 32 takes the split form, more rows the tensor-core
# loop (attn_mma.cuh)
K7_CASES = {
    "decode_g8": (1, 8, 64, 2176, [255, 0, 300, 2048], 0, 0.0, False, torch.float32),
    "decode_g1_s144": (1, 1, 64, 144, [143, 0, 77, 144], 0, 0.0, False, torch.float32),
    "decode_g4_d128": (1, 4, 128, 2176, [2047, 5, 1000, 2048], 0, 0.0, False, torch.float32),
    "t16_g1_s144": (16, 1, 64, 144, [0, 100, 128, 60], 0, 0.0, False, torch.float32),
    "t16_g4": (16, 4, 64, 2176, [0, 700, 1500, 2048], 0, 0.0, False, torch.float32),
    "chunk_g8": (128, 8, 64, 2176, [0, 256, 300, 2048], 0, 0.0, False, torch.float32),
    "chunk_d128": (128, 4, 128, 2176, [0, 256, 1900, 2048], 0, 0.0, False, torch.float32),
    "s64": (16, 4, 64, 64, [0, 10, 48, 30], 0, 0.0, False, torch.float32),
    "window_decode": (1, 8, 64, 2176, [255, 0, 1300, 2048], 100, 0.0, False, torch.float32),
    "window_chunk": (16, 8, 64, 2176, [0, 256, 1300, 2048], 100, 0.0, False, torch.float32),
    "softcap_decode": (1, 8, 64, 2176, [255, 0, 300, 2048], 0, 30.0, False, torch.float32),
    "softcap_chunk": (128, 8, 64, 2176, [0, 256, 300, 2048], 0, 30.0, False, torch.float32),
    "sinks_decode": (1, 8, 64, 2176, [255, 0, 300, 2048], 0, 0.0, True, torch.float32),
    "sinks_chunk": (128, 8, 64, 2176, [0, 256, 300, 2048], 0, 0.0, True, torch.float32),
    "bf16q_decode": (1, 8, 64, 2176, [255, 0, 300, 2048], 0, 0.0, False, torch.bfloat16),
    "bf16q_chunk": (128, 8, 64, 2176, [0, 256, 300, 2048], 0, 0.0, False, torch.bfloat16),
    "chunk_g1_d128": (128, 1, 128, 2176, [0, 256, 1900, 2048], 0, 0.0, False, torch.float32),
    "ragged_t37": (37, 4, 64, 2176, [0, 700, 1500, 2048], 0, 0.0, False, torch.float32),
    "window_sinks_chunk": (128, 8, 64, 2176, [0, 256, 1300, 2048], 100, 0.0, True,
                           torch.float32),
    # the cluster's cases: 65 chunks a row (more than 8 blocks share evenly),
    # R = 32 (T = 4, G = 8: four clusters a kv head), a window whose span
    # starts mid-chunk, 157 chunks (more scores than a block keeps: the later
    # chunks' scores are recomputed)
    "s8320": (1, 8, 64, 8320, [8000, 4100, 0, 8320], 0, 0.0, False, torch.float32),
    "r32": (4, 8, 64, 2176, [255, 0, 300, 2048], 0, 0.0, False, torch.float32),
    "window_mid": (1, 8, 64, 2176, [1000, 777, 2047, 2048], 333, 0.0, False, torch.float32),
    "s20000_sinks": (1, 8, 64, 20000, [19000, 9000, 5, 20000], 0, 0.0, True, torch.float32),
    # head_dim 256 (Gemma-1 on the q8 cache: G 8): the split form on
    # decode_cluster.cuh's D 256 instantiation, the multi-row form on
    # attn_mma.cuh's 64-slot chunks; S 2100 ends mid-chunk
    "decode_g8_d256": (1, 8, 256, 2176, [255, 0, 300, 2048], 0, 0.0, False, torch.float32),
    "bf16q_decode_d256": (1, 8, 256, 2176, [255, 0, 300, 2048], 0, 0.0, False, torch.bfloat16),
    "chunk_g8_d256": (128, 8, 256, 2176, [0, 256, 300, 2048], 0, 0.0, False, torch.float32),
    "chunk_d256_s2100": (128, 8, 256, 2100, [0, 256, 1900, 2100], 0, 0.0, True, torch.float32),
}


@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_matches_plain(dev, case, kv):
    """Tolerance: nmse < 1e-6 with an f32 q (f32 sum order only: neither
    side rounds a probability), < 1e-5 with a bf16 q, whose output is
    rounded to bf16 on both sides (an ulp may flip)."""
    t, g, d, s, starts, window, softcap, sinks, qdtype = K7_CASES[case]
    b, hkv = 4, 4
    hq = g * hkv
    q = _randn((b, t, hq, d), 40, dev, qdtype)
    if kv == "int8":
        gen = torch.Generator(device=dev)
        gen.manual_seed(41)
        k = torch.randint(-127, 128, (b, hkv, s, d), generator=gen, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (b, hkv, s, d), generator=gen, device=dev, dtype=torch.int8)
        ks = _randn((b, hkv, s, 1), 42, dev).abs() * 0.01 + 1e-3
        vs = _randn((b, hkv, s, 1), 43, dev).abs() * 0.01 + 1e-3
    else:
        k = _randn((b, hkv, s, d), 44, dev, torch.bfloat16)
        v = _randn((b, hkv, s, d), 45, dev, torch.bfloat16)
        ks = vs = None
    positions = (torch.tensor(starts, dtype=torch.int32, device=dev)[:, None]
                 + torch.arange(t, dtype=torch.int32, device=dev)[None])
    kw = dict(scale=d ** -0.5, softcap=softcap, window=window, ks=ks, vs=vs,
              sinks=_randn((hq,), 46, dev) if sinks else None)
    before = ta.flash_attention_blockwise.launches
    before_mma = ta.flash_attention_blockwise.mma_launches
    got = ta.flash_attention_blockwise(q, k, v, positions, **kw)
    want = ta.flash_attention_blockwise_plain(q, k, v, positions, **kw)
    torch.cuda.synchronize()
    assert ta.flash_attention_blockwise.launches == before + 1
    assert ta.flash_attention_blockwise.mma_launches == before_mma + (t * g > 32)
    assert got.dtype == qdtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert _nmse(got.float(), want.float()) < (1e-6 if qdtype == torch.float32 else 1e-5)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
@pytest.mark.parametrize("k,n", [(256, 40), (2304, 72), (2048, 6144), (8192, 2048),
                                 (2048, 16384), (5632, 2048), (768, 72), (1280, 2100)])
def test_k12_matches_k1(dev, k, n, fuse, xdtype):
    """K = 2304 gives an odd number of super-blocks a column (the d/dmin
    runs start mid-word) and a last stage of 4 chunks; K = 5632 d/dmin runs
    of 44 bytes a column; K = 768 and 1280 sc/mn runs whose stages a bulk
    copy cannot take (K % 512 != 0), 1280 with a last stage of 4 chunks;
    N = 40 and 72 are smaller than one block's columns (its last warps
    without a column), N = 2100 not a multiple of them."""
    w = _qweight(n, k, k + n, dev)
    x = _randn((1, 2 * k if fuse == "glu" else k), 1, dev, xdtype, scale=2.0)
    aux = _randn((k,), 2, dev, scale=0.1) + 1.0 if fuse == "norm" else None
    before = tq.q4k_matvec_hbm.launches
    got = tq.q4k_matvec_hbm(x, w, fuse, aux, 1e-5)
    torch.cuda.synchronize()
    assert tq.q4k_matvec_hbm.launches == before + 1
    assert torch.equal(got, tq.q4k_matvec(x, w, fuse, aux, 1e-5))
    assert _nmse(got, tq.q4k_matvec_hbm_plain(x, w, fuse, aux, 1e-5)) < 1e-6


# K8: (B, G, D, S, positions, window, softcap); S = 2048 with pos 331 is the
# OLMo-2 decode step, S = 2176 the engine's contiguous stripe (max_len 2048
# + chunk 128, a trash row at 2048), pos == S a trash row past the stripe;
# S = 8320 spans more chunks (65) than the cluster's 8 blocks share evenly,
# S = 20000 more than a block keeps the scores of (its rest recomputed)
K8_CASES = {
    "olmo2": (1, 1, 128, 2048, [331], 0, 0.0),
    "engine_g8": (4, 8, 64, 2176, [255, 0, 300, 2048], 0, 0.0),
    "mid_g4": (1, 4, 128, 512, [331], 0, 0.0),
    "block_edge": (1, 4, 64, 512, [255], 0, 0.0),
    "start": (1, 1, 64, 256, [0], 0, 0.0),
    "b2": (2, 4, 128, 512, [17, 300], 0, 0.0),
    "window": (2, 1, 128, 512, [400, 40], 100, 0.0),
    "trash_row": (2, 4, 64, 256, [256, 100], 0, 0.0),
    "softcap": (1, 4, 128, 256, [200], 0, 30.0),
    "g16_ragged": (2, 16, 64, 300, [299, 5], 0, 0.0),
    "s200": (1, 1, 64, 200, [150], 0, 0.0),
    "s2000": (1, 1, 128, 2000, [1999], 0, 0.0),
    "s8320": (4, 1, 128, 8320, [8000, 4100, 0, 8320], 0, 0.0),
    "s20000": (1, 4, 64, 20000, [19990], 0, 0.0),
    "window_mid_chunk": (2, 4, 64, 1024, [700, 1024], 300, 0.0),
}


@pytest.mark.parametrize("qdtype,cdtype", [(torch.float32, torch.float32),
                                           (torch.float32, torch.bfloat16),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.float16),
                                           (torch.bfloat16, torch.float16)],
                         ids=["f32-f32", "f32-bf16", "bf16-bf16", "f32-f16", "bf16-f16"])
@pytest.mark.parametrize("case", list(K8_CASES))
def test_k8_matches_plain(dev, case, qdtype, cdtype):
    """The caches must come out bit-identical to the plain version's: one
    row written per batch row, at min(pos, S - 1) (trash rows: engine_g8's
    2048 in a stripe of 2176, trash_row's and s8320's pos == S).  An f16
    cache runs the f16 form, counted in `.f16_launches`."""
    b, g, d, s, pos_vals, window, softcap = K8_CASES[case]
    hkv = 2 if g >= 8 else 4
    hq = g * hkv
    positions = torch.tensor(pos_vals, dtype=torch.int32, device=dev)[:, None]
    q = _randn((b, 1, hq, d), 50, dev, qdtype)
    kn = _randn((b, 1, hkv, d), 51, dev, qdtype)
    vn = _randn((b, 1, hkv, d), 52, dev, qdtype)
    kc = _randn((b, hkv, s, d), 53, dev, cdtype)
    vc = _randn((b, hkv, s, d), 54, dev, cdtype)
    k2, v2 = kc.clone(), vc.clone()
    kw = dict(scale=d ** -0.5, softcap=softcap, window=window)
    before = ta.attn_decode_update.launches, ta.attn_decode_update.f16_launches
    got = ta.attn_decode_update(q, kn, vn, kc, vc, positions, **kw)
    want = ta.attn_decode_update_plain(q, kn, vn, k2, v2, positions, **kw)
    torch.cuda.synchronize()
    assert (ta.attn_decode_update.launches, ta.attn_decode_update.f16_launches) == (
        before[0] + 1, before[1] + (cdtype == torch.float16))
    assert got.dtype == qdtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert _nmse(got.float(), want.float()) < (1e-6 if qdtype == torch.float32 else 1e-5)
    assert torch.equal(kc, k2) and torch.equal(vc, v2)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16], ids=["f32q", "bf16q"])
def test_k8_f16_keeps_subnormal_probabilities(dev, qdtype):
    """The OLMo-2 step's shape over an f16 cache, q scaled so that the
    scores span more than 17 nats: many normalized probabilities fall
    under 2^-14 (f16 subnormals); the kernel keeps them as the plain
    version's f16 rounding does (nmse as test_k8_matches_plain's)."""
    b, hq, hkv, d, s = 1, 16, 16, 128, 2048
    q = _randn((b, 1, hq, d), 60, dev, qdtype, scale=6.0)
    kn, vn = _randn((b, 1, hkv, d), 61, dev, qdtype), _randn((b, 1, hkv, d), 62, dev, qdtype)
    kc = _randn((b, hkv, s, d), 63, dev, torch.float16)
    vc = _randn((b, hkv, s, d), 64, dev, torch.float16)
    k2, v2 = kc.clone(), vc.clone()
    pos = torch.tensor([[1500]], dtype=torch.int32, device=dev)
    got = ta.attn_decode_update(q, kn, vn, kc, vc, pos, scale=d ** -0.5)
    want = ta.attn_decode_update_plain(q, kn, vn, k2, v2, pos, scale=d ** -0.5)
    torch.cuda.synchronize()
    scores = torch.einsum("hd,hsd->hs", q[0, 0].float(), kc[0, :, :1501].float()) * d ** -0.5
    p = torch.softmax(scores, dim=-1).to(torch.float16)
    assert bool(((p > 0) & (p.float() < 2.0 ** -14)).any())
    assert _nmse(got.float(), want.float()) < (1e-6 if qdtype == torch.float32 else 1e-5)
    assert torch.equal(kc, k2) and torch.equal(vc, v2)


def _decode_call(kernel, kv, b, dev):
    """A 4-row decode call of K7's split form (S 2176, int8 or bf16 K/V), K8
    (S 8320, f32 or bf16 caches) or K9 (65 pages of 128, f32 or bf16 pools)
    with a trash row, as `fn(rows)`: the output of the call restricted to
    those batch rows, on fresh copies of the cache; and the rows to
    compare."""
    if kernel == "k8":
        s, hkv, hq, d = 8320, 4, 32, 64
        cdtype = torch.float32 if kv == "f32" else torch.bfloat16
        pos = torch.tensor([8000, 300, 0, s], dtype=torch.int32, device=dev)[:, None]
        q = _randn((b, 1, hq, d), 70, dev)
        kn, vn = _randn((b, 1, hkv, d), 71, dev), _randn((b, 1, hkv, d), 72, dev)
        kc, vc = _randn((b, hkv, s, d), 73, dev, cdtype), _randn((b, hkv, s, d), 74, dev, cdtype)

        def fn(rows):
            return ta.attn_decode_update(q[rows].contiguous(), kn[rows].contiguous(),
                                         vn[rows].contiguous(), kc[rows].clone(),
                                         vc[rows].clone(), pos[rows].contiguous(),
                                         scale=d ** -0.5)
        return fn, [0, 1, 2, 3]
    if kernel == "k7":
        s, hkv, hq, d = 2176, 4, 32, 64
        pos = torch.tensor([255, 2047, 0, 2048], dtype=torch.int32, device=dev)[:, None]
        q = _randn((b, 1, hq, d), 60, dev)
        if kv == "int8":
            gen = torch.Generator(device=dev)
            gen.manual_seed(61)
            k = torch.randint(-127, 128, (b, hkv, s, d), generator=gen, device=dev,
                              dtype=torch.int8)
            v = torch.randint(-127, 128, (b, hkv, s, d), generator=gen, device=dev,
                              dtype=torch.int8)
            ks = _randn((b, hkv, s, 1), 62, dev).abs() * 0.01 + 1e-3
            vs = _randn((b, hkv, s, 1), 63, dev).abs() * 0.01 + 1e-3
        else:
            k = _randn((b, hkv, s, d), 64, dev, torch.bfloat16)
            v = _randn((b, hkv, s, d), 65, dev, torch.bfloat16)
            ks = vs = None

        def fn(rows):
            sel = (lambda x: None if x is None else x[rows].contiguous())
            return ta.flash_attention_blockwise(q[rows].contiguous(), sel(k), sel(v),
                                                pos[rows].contiguous(), scale=d ** -0.5,
                                                ks=sel(ks), vs=sel(vs))
        return fn, [0, 1, 2]
    hq, hkv, d, lp, ps = 32, 4, 64, 65, 128
    pdtype = torch.float32 if kv == "f32" else torch.bfloat16
    pos = torch.tensor([8000, 300, 0, lp * ps], dtype=torch.int32, device=dev)[:, None]
    q = _randn((b, 1, hq, d), 66, dev)
    kn, vn = _randn((b, 1, hkv, d), 67, dev), _randn((b, 1, hkv, d), 68, dev)
    k_pool, v_pool, table = _paged_inputs(b, hkv, d, lp, ps, pdtype, dev, 69)

    def fn(rows):
        return ta.paged_attn_decode_update(q[rows].contiguous(), kn[rows].contiguous(),
                                           vn[rows].contiguous(), k_pool.clone(),
                                           v_pool.clone(), table[rows].contiguous(),
                                           pos[rows].contiguous(), page_size=ps,
                                           scale=d ** -0.5)
    return fn, [0, 1, 2]


@pytest.mark.parametrize("kernel,kv", [("k7", "int8"), ("k7", "bf16"), ("k9", "f32"),
                                       ("k9", "bf16"), ("k8", "f32"), ("k8", "bf16")])
def test_decode_rows_do_not_depend_on_the_batch(dev, kernel, kv):
    """Each live row of a 4-row decode call with a trash row (K8: every row,
    its trash row attending all S slots) is bit-identical to the same row
    run alone (B = 1): the cluster deals a row's chunks by a rule that reads
    only its own span and S."""
    fn, live = _decode_call(kernel, kv, 4, dev)
    together = fn(list(range(4)))
    for r in live:
        alone = fn([r])
        assert torch.equal(together[r:r + 1], alone), f"row {r}"


@pytest.mark.parametrize("fmt", [GGMLType.Q4_K, GGMLType.Q4_0, GGMLType.Q5_0, GGMLType.Q5_K],
                         ids=lambda t: t.name)
def test_k1_chain_in_a_graph(dev, fmt):
    """K1 launches with programmatic dependent launch: each may start while
    its predecessor drains, and only its weight loads may come before
    griddepcontrol.wait.  The chain norm -> gate|up (K1), glu -> down (K1),
    a torch add, norm -> wqkv (K1) at TinyLlama widths, captured once in a
    CUDA graph and replayed 50 times with its input rewritten in place
    between replays, must give each time the bits of the same chain run
    eagerly (a read of x or a write of y before the wait would race)."""
    d, ff, n_qkv = 2048, 5632, 2560
    w_gu, w_down = _qweight(2 * ff, d, 1, dev, fmt), _qweight(d, ff, 2, dev, fmt)
    w_qkv = _qweight(n_qkv, d, 3, dev, fmt)
    norm_ffn = _randn((d,), 4, dev, scale=0.1) + 1.0
    norm_att = _randn((d,), 5, dev, scale=0.1) + 1.0
    x = _randn((1, d), 6, dev, scale=3.0)

    def chain():  # each K1's output
        gu = tq.q4k_matvec(x, w_gu, "norm", norm_ffn, 1e-5)
        down = tq.q4k_matvec(gu, w_down, "glu", None, 1e-5)
        return gu, down, tq.q4k_matvec(x + down, w_qkv, "norm", norm_att, 1e-5)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = chain()
    for i in range(50):
        x.copy_(_randn((1, d), 100 + i, dev, scale=3.0))
        graph.replay()
        got = [t.clone() for t in outs]
        want = chain()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), f"replay {i}"
        if i == 0:  # each stage against its plain version on the same input
            gu, down, qkv = want
            assert _nmse(gu, tq.q4k_matvec_plain(x, w_gu, "norm", norm_ffn, 1e-5)) < 1e-6
            assert _nmse(down, tq.q4k_matvec_plain(gu, w_down, "glu", None, 1e-5)) < 1e-6
            assert _nmse(qkv, tq.q4k_matvec_plain(x + down, w_qkv, "norm", norm_att,
                                                  1e-5)) < 1e-6


def _replays_equal_eager(chain, rewrite, caches=(), n=50):
    """`chain()` (returning its kernels' outputs) captured once in a CUDA
    graph and replayed n times, `rewrite(i)` giving its inputs (and the
    caches it updates) fresh values in place before each replay: each
    replay's outputs and caches must equal, bit for bit, those of the same
    chain run eagerly on the same inputs.  Returns the last eager outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = chain()
    for i in range(n):
        rewrite(i)
        graph.replay()
        got = [t.clone() for t in (*outs, *caches)]
        rewrite(i)
        want = [*chain(), *caches]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), f"replay {i}"
    return want


def test_k2_chain_in_a_graph(dev):
    """K2 launches with programmatic dependent launch between two K1: before
    griddepcontrol.wait it stages only cache slots other than its insert
    slot, and the K1 on wo after it has only its weights in flight before
    its own wait.  The chain norm -> wqkv (K1) -> K2 -> wo (K1) at TinyLlama
    widths (bf16 cache of 2048 slots, pos 331), replayed from a CUDA graph
    with the input row and the cache rewritten between replays, gives each
    time the eager chain's bits, outputs and cache."""
    d, hq, hkv, hd, s = 2048, 32, 4, 64, 2048
    w_qkv, w_o = _qweight((hq + 2 * hkv) * hd, d, 1, dev), _qweight(d, d, 2, dev)
    norm = _randn((d,), 3, dev, scale=0.1) + 1.0
    x = _randn((1, d), 4, dev, scale=3.0)
    kc, vc = (torch.empty((1, hkv, s, hd), dtype=torch.bfloat16, device=dev) for _ in range(2))
    pos = torch.tensor([331], dtype=torch.int32, device=dev)
    rt = tl.rope_table(pos, tl.RopeParams(dim=hd, style="neox"), hd)

    def chain():
        qkv = tq.q4k_matvec(x, w_qkv, "norm", norm, 1e-5)
        att = ta.attn_decode_qkv(qkv.reshape(1, hq + 2 * hkv, hd), kc, vc, pos, rt,
                                 scale=hd ** -0.5)
        return qkv, att, tq.q4k_matvec(att.reshape(1, -1), w_o, "q", None, 1e-5)

    def rewrite(i):
        x.copy_(_randn((1, d), 100 + i, dev, scale=3.0))
        kc.copy_(_randn(kc.shape, 300 + i, dev, torch.bfloat16))
        vc.copy_(_randn(vc.shape, 500 + i, dev, torch.bfloat16))

    qkv, att, out = _replays_equal_eager(chain, rewrite, (kc, vc))[:3]
    rewrite(49)
    k2, v2 = kc.clone(), vc.clone()
    want = ta.attn_decode_qkv_plain(qkv.reshape(1, hq + 2 * hkv, hd), k2, v2, pos, rt,
                                    scale=hd ** -0.5)
    assert _nmse(att.float(), want.float()) < 1e-5
    assert _nmse(out, tq.q4k_matvec_plain(att.reshape(1, -1), w_o, "q", None, 1e-5)) < 1e-6


@pytest.mark.parametrize("pair", ["wk_wv", "gate_up_down"])
def test_k4_chain_in_a_graph(dev, pair):
    """K4 launches with programmatic dependent launch after a K1, as in a
    Q4_K_M step: K1 (q 2048->2048) -> K4 (Q6_K q 2048->256) on its output,
    and gate|up (K1 norm 2048->11264) -> down (K4 Q6_K glu 5632->2048).
    Replayed from a CUDA graph with the input rewritten between replays,
    each replay gives the eager chain's bits (a read of x or a write of y
    before griddepcontrol.wait would race)."""
    d, ff = 2048, 5632
    if pair == "wk_wv":
        w1, w4 = _qweight(d, d, 1, dev), _int_weight(GGMLType.Q6_K, 256, d, 2, dev)
        fuse1, aux1, fuse4 = "q", None, "q"
    else:
        w1, w4 = _qweight(2 * ff, d, 3, dev), _int_weight(GGMLType.Q6_K, d, ff, 4, dev)
        fuse1, aux1, fuse4 = "norm", _randn((d,), 5, dev, scale=0.1) + 1.0, "glu"
    x = _randn((1, d), 6, dev, torch.bfloat16, scale=3.0)

    def chain():
        y1 = tq.q4k_matvec(x, w1, fuse1, aux1, 1e-5)
        return y1, tq.int8_matvec(y1, w4, fuse4, None, 1e-5)

    def rewrite(i):
        x.copy_(_randn((1, d), 100 + i, dev, torch.bfloat16, scale=3.0))

    y1, y4 = _replays_equal_eager(chain, rewrite)
    assert _nmse(y4, tq.int8_matvec_plain(y1, w4, fuse4, None, 1e-5)) < 1e-6


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", [GGMLType.Q4_K, GGMLType.Q4_1], ids=lambda t: t.name)
def test_k12_chain_in_a_graph(dev, fmt, xdtype):
    """K12 launches with programmatic dependent launch and issues the bulk
    copies of its first weight stages before griddepcontrol.wait.  The
    chain norm -> gate|up, glu -> down, a torch add, norm -> wqkv (K12 each)
    at TinyLlama widths, captured in a CUDA graph and replayed with the
    input rewritten in place between replays, gives each time the eager
    chain's bits, and those are K1's."""
    d, ff, n_qkv = 2048, 5632, 2560
    w_gu, w_down = _qweight(2 * ff, d, 1, dev, fmt), _qweight(d, ff, 2, dev, fmt)
    w_qkv = _qweight(n_qkv, d, 3, dev, fmt)
    norm_ffn = _randn((d,), 4, dev, scale=0.1) + 1.0
    norm_att = _randn((d,), 5, dev, scale=0.1) + 1.0
    x = _randn((1, d), 6, dev, xdtype, scale=3.0)

    def chain(mv=tq.q4k_matvec_hbm):
        gu = mv(x, w_gu, "norm", norm_ffn, 1e-5)
        down = mv(gu, w_down, "glu", None, 1e-5)
        return gu, down, mv(x + down, w_qkv, "norm", norm_att, 1e-5)

    def rewrite(i):
        x.copy_(_randn((1, d), 100 + i, dev, xdtype, scale=3.0))

    got = _replays_equal_eager(chain, rewrite)
    want = chain(tq.q4k_matvec)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("fmt", [GGMLType.Q4_0, GGMLType.Q4_1], ids=lambda t: t.name)
def test_k11_chain_in_a_graph(dev, fmt):
    """K11 quantizes its row inside its one launch, after
    griddepcontrol.wait: K1 (wqkv, norm 2048->2560) -> K11 on its first
    2048 outputs (wo 2048->2048) -> K11 on K11's output, replayed from a
    CUDA graph with the input rewritten between replays, gives each time
    the eager chain's bits, and K11's are K1's."""
    d = 2048
    w_qkv, w_o, w_2 = (_qweight(n, d, s, dev, fmt) for n, s in ((2560, 1), (d, 2), (d, 3)))
    norm = _randn((d,), 4, dev, scale=0.1) + 1.0
    x = _randn((1, d), 5, dev, torch.bfloat16, scale=3.0)

    def chain(mv=tq.w4a8dd_matvec):
        qkv = tq.q4k_matvec(x, w_qkv, "norm", norm, 1e-5)
        o = mv(qkv[:, :d].contiguous(), w_o)
        return qkv, o, mv(o, w_2)

    def rewrite(i):
        x.copy_(_randn((1, d), 100 + i, dev, torch.bfloat16, scale=3.0))

    got = _replays_equal_eager(chain, rewrite)
    want = chain(tq.q4k_matvec)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


K2_POS = [255, 0, 2176, 1500]  # live, position 0, a trash row, a span of several chunks


@pytest.mark.parametrize("cdtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32c", "bf16c", "f16c"])
def test_k2_rows_do_not_depend_on_the_batch(dev, cdtype):
    """K2 at B = 1..4 (an engine stripe of 2176 slots, mixed positions and a
    trash row): every row's output and cache rows are bit-identical to the
    same row run alone, since a row's chunks are cut by a rule that reads
    only its position and S; and the 4-row call agrees with the plain
    version."""
    s, hq, hkv, d = 2176, 32, 4, 64
    qkv3 = _randn((4, hq + 2 * hkv, d), 80, dev)
    kc, vc = _randn((4, hkv, s, d), 81, dev, cdtype), _randn((4, hkv, s, d), 82, dev, cdtype)
    pos = torch.tensor(K2_POS, dtype=torch.int32, device=dev)
    rt = tl.rope_table(pos, tl.RopeParams(dim=d, style="neox"), d)

    def run(rows):
        k, v = kc[rows].clone(), vc[rows].clone()
        sub = tl.RopeTable(rt.cos[rows].contiguous(), rt.sin[rows].contiguous(), rt.neox)
        out = ta.attn_decode_qkv(qkv3[rows].contiguous(), k, v, pos[rows].contiguous(), sub,
                                 scale=d ** -0.5)
        return out, k, v

    alone = [run([r]) for r in range(4)]
    for nb in (1, 2, 3, 4):
        together = run(list(range(nb)))
        for r in range(nb):
            assert all(torch.equal(t[r:r + 1], a) for t, a in zip(together, alone[r])), \
                f"B {nb} row {r}"
    k2, v2 = kc.clone(), vc.clone()
    want = ta.attn_decode_qkv_plain(qkv3, k2, v2, pos, rt, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert _nmse(together[0].float(), want.float()) < 1e-5
    assert torch.equal(together[2], v2) and _nmse(together[1].float(), k2.float()) < 1e-9


@pytest.mark.parametrize("cdtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32c", "bf16c", "f16c"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(32, 4), (32, 2)], ids=["g8", "g16"])
def test_k2_long_span(dev, hq, hkv, d, cdtype):
    """K2 at S 8320: rows at 8000 and 4100 (spans of many chunks, finished
    by the last of their blocks), 0 and a trash row, against the plain
    version; G = 16 runs two query groups a kv head."""
    s = 8320
    pos = torch.tensor([8000, 4100, 0, s], dtype=torch.int32, device=dev)
    qkv3 = _randn((4, hq + 2 * hkv, d), 90, dev)
    kc, vc = _randn((4, hkv, s, d), 91, dev, cdtype), _randn((4, hkv, s, d), 92, dev, cdtype)
    rt = tl.rope_table(pos, tl.RopeParams(dim=d, style="neox"), d)
    k2, v2 = kc.clone(), vc.clone()
    got = ta.attn_decode_qkv(qkv3, kc, vc, pos, rt, scale=d ** -0.5)
    want = ta.attn_decode_qkv_plain(qkv3, k2, v2, pos, rt, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _nmse(got.float(), want.float()) < 1e-5
    assert torch.equal(vc, v2) and _nmse(kc.float(), k2.float()) < 1e-9
    again = ta.attn_decode_qkv(qkv3, kc, vc, pos, rt, scale=d ** -0.5)
    assert torch.equal(again, got)  # the counters were left zero


# the legacy nibble formats through K1, K3, K12 and K11: odd N (a block's
# last warps without a column), K = 2304 (nine 256-chunks), wide N (the
# OLMo-2 head)
LEGACY = [GGMLType.Q4_0, GGMLType.Q4_1]
LEGACY_KN = [(256, 40), (2304, 72), (2048, 6144), (8192, 2048), (2048, 100352), (768, 72),
             (1280, 2100), (5632, 2048)]


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
@pytest.mark.parametrize("fmt", LEGACY, ids=lambda t: t.name)
@pytest.mark.parametrize("k,n", LEGACY_KN)
def test_k1_k12_legacy_match_plain(dev, k, n, fmt, fuse, xdtype):
    """K1 against its plain version; K12 equal to K1 bit for bit."""
    w = _qweight(n, k, k + n, dev, fmt)
    x = _randn((1, 2 * k if fuse == "glu" else k), 1, dev, xdtype, scale=2.0)
    aux = _randn((k,), 2, dev, scale=0.1) + 1.0 if fuse == "norm" else None
    before = (tq.q4k_matvec.launches, tq.q4k_matvec_hbm.launches)
    got = tq.q4k_matvec(x, w, fuse, aux, 1e-5)
    hbm = tq.q4k_matvec_hbm(x, w, fuse, aux, 1e-5)
    torch.cuda.synchronize()
    assert (tq.q4k_matvec.launches, tq.q4k_matvec_hbm.launches) == (before[0] + 1, before[1] + 1)
    assert _nmse(got, tq.q4k_matvec_plain(x, w, fuse, aux, 1e-5)) < 1e-6
    assert torch.equal(hbm, got)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", LEGACY, ids=lambda t: t.name)
@pytest.mark.parametrize("m,k,n,n_pad", K3_CASES + [(256, 2048, 100352, 0)])
def test_k3_legacy_matches_plain(dev, m, k, n, n_pad, fmt, xdtype):
    _k3_case(dev, m, k, n, n_pad, xdtype, fmt)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", LEGACY, ids=lambda t: t.name)
@pytest.mark.parametrize("k,n", LEGACY_KN)
def test_k11_matches_plain(dev, k, n, fmt, xdtype):
    w = _qweight(n, k, k + n + 1, dev, fmt)
    x = _randn((1, k), 4, dev, xdtype, scale=2.0)
    before = tq.w4a8dd_matvec.launches
    got = tq.w4a8dd_matvec(x, w)
    torch.cuda.synchronize()
    assert tq.w4a8dd_matvec.launches == before + 1 and got.shape == (1, n)
    want = tq.w4a8dd_matvec_plain(*tq.quantize_acts_plain(x), w)
    assert _nmse(got, want) < 1e-6
    assert torch.equal(got, tq.q4k_matvec(x, w))  # K1's lane order and epilogue


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [256, 2304, 2048, 5632, 8192])
def test_k11_quantize_bit_equal(dev, k, xdtype):
    """A zero group (dx clamped to 1e-12), a group of exact halves (dx = 1:
    ties of the rounding) and a wide one beside Gaussian groups."""
    x = _randn((1, k), 5, dev, scale=3.0)
    x[0, :32] = 0.0
    x[0, 32:64] = torch.arange(32, device=dev) - 15.5
    x[0, 32] = 127.0
    x[0, 64:96] *= 1e4
    x = x.to(xdtype)
    got = tq.quantize_acts(x)
    torch.cuda.synchronize()
    want = tq.quantize_acts_plain(x)
    assert got[0].dtype == torch.int8 and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kv", ["paged_bf16", "q8", "contiguous_bf16", "olmo2_contiguous_bf16",
                                "paged_f16", "contiguous_f16", "olmo2_contiguous_f16",
                                "moe_paged_bf16"])
def test_engine_rows_do_not_depend_on_the_batch(dev, kv, tmp_path):
    """Greedy requests served together (a generating row riding the mixed
    steps of another request's prefill) and one at a time give the same
    logits rows and tokens, bit for bit: K3/K5 rows do not depend on M, and
    a mixed step attends a one-token row through the T=1 kernel (K9; K7's
    split form with the q8 cache; over a contiguous bf16 cache K2 for llama,
    K8 for OLMo-2; the f16 caches through K9/K10, K2/K6 and K8/K6 in their
    f16 forms), as a decode step does.  The fourth prompt extends the
    first's first 50 tokens: alone, the contiguous and q8 layouts reuse
    them and prefill its last token as a chunk of one, which keeps the
    multi-row kernel's bits as inside its longer chunk served together.
    The MoE case (a qwen3moe file, 8 experts, top-2, Q4_K stacks): each
    expert's rows through K3 at every M, the dense router in fixed blocks
    of rows (`models/llama._rows_linear`)."""
    import time

    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request
    from zllm_torch.testing import make_llama_gguf

    olmo2 = dict(arch="olmo2", n_kv_heads=4, norm_eps=1e-6, rope_base=500000.0)
    moe = dict(arch="qwen3moe", n_ff=256, n_experts=8, n_experts_used=2, norm_eps=1e-6)
    path = make_llama_gguf(str(tmp_path / "m.gguf"), gtype=GGMLType.Q4_K, seed=0,
                           **(olmo2 if kv.startswith("olmo2") else moe if kv.startswith("moe")
                              else {}))
    model = Model.load(path, device="cuda", dtype=torch.bfloat16)
    layout = dict(kv_dtype="q8") if kv == "q8" else dict(
        kv_dtype=torch.float16 if kv.endswith("_f16") else torch.bfloat16,
        kv_layout="contiguous" if "contiguous" in kv else "paged")
    rng = np.random.default_rng(3)
    prompts = [[1] + [int(t) for t in rng.integers(3, 512, n - 1)] for n in (70, 40, 9)]
    prompts.append(prompts[0][:50] + [7])

    def serve(groups):
        eng = Engine(model, n_slots=4, max_len=256, prefill_chunk=16, **layout)
        rows, real = {}, eng._sample_and_emit

        def record(lg, cols, slots):
            for s in slots:
                rows.setdefault(tuple(s.req.prompt_tokens), []).append(
                    lg[s.idx, int(cols[s.idx])].float().cpu())
            return real(lg, cols, slots)

        eng._sample_and_emit = record
        eng.start()
        try:
            for group in groups:
                reqs = eng.run_in_loop(lambda g=group: [
                    eng.submit(Request(prompt_tokens=p, max_new=12, temp=0.0)) for p in g])
                deadline = time.time() + 120
                while not all(r.done for r in reqs):
                    assert time.time() < deadline, "engine timed out"
                    time.sleep(0.005)
        finally:
            eng.stop()
        return rows

    together, alone = serve([prompts]), serve([[p] for p in prompts])
    for p in prompts:
        a, b = together[tuple(p)], alone[tuple(p)]
        assert len(a) == len(b) == 12
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# K1 and K3 in their Q5 forms: odd N (a block's last warps without a
# column), K = 2304 (nine 256-chunks), the models' shapes (TinyLlama's
# wqkv, gate|up, down, the head; Qwen2.5's K 8960)
Q5_KN = [(256, 40), (2304, 72), (2048, 2560), (2048, 11264), (5632, 2048), (8960, 1536),
         (768, 72)]


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
@pytest.mark.parametrize("fmt", Q5_FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("k,n", Q5_KN)
def test_k1_q5_matches_plain(dev, k, n, fmt, fuse, xdtype):
    w = _qweight(n, k, k + n, dev, fmt)
    x = _randn((1, 2 * k if fuse == "glu" else k), 1, dev, xdtype, scale=2.0)
    aux = _randn((k,), 2, dev, scale=0.1) + 1.0 if fuse == "norm" else None
    before = tq.q4k_matvec.launches
    got = tq.q4k_matvec(x, w, fuse, aux, 1e-5)
    torch.cuda.synchronize()
    assert tq.q4k_matvec.launches == before + 1
    assert _nmse(got, tq.q4k_matvec_plain(x, w, fuse, aux, 1e-5)) < 1e-6


@pytest.mark.parametrize("fmt", Q5_FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("n", [40, 2048])
def test_k1_q5_random_blocks(dev, fmt, n):
    """K1 on random GGUF bytes (every nibble, fifth-bit and scale position),
    held column by column: a fifth bit taken from the wrong word or bit
    shows in the columns it hits.  The group dots are exact integers, so
    only the f32 sum order differs."""
    k = 2048
    size, scales = NIBBLE_BLOCKS[fmt]
    rng = np.random.default_rng(3 + size)
    per_block = 256 if fmt == GGMLType.Q5_K else 32
    raw = rng.integers(0, 256, size=(n * k // per_block, size), dtype=np.uint8)
    for off in scales:
        vals = rng.uniform(0.002, 0.02, size=raw.shape[0]).astype(np.float16)
        raw[:, off:off + 2] = vals.view(np.uint8).reshape(-1, 2)
    w = repack(raw.reshape(n, -1), (n, k), fmt, dev)
    x = _randn((1, k), 4, dev)
    got, want = tq.q4k_matvec(x, w), tq.q4k_matvec_plain(x, w)
    col_err = (got - want).abs()[0] / (want.abs().max() + 1e-30)
    assert float(col_err.max()) < 1e-5


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", Q5_FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("m,k,n,n_pad", [
    (4, 2048, 2560, 0), (4, 2048, 11264, 0), (4, 5632, 2048, 0), (4, 2048, 32000, 32768),
    (4, 8960, 1536, 0), (256, 2048, 2560, 0), (256, 2048, 11264, 0), (256, 5632, 2048, 0),
    (256, 2048, 256, 0), (256, 2048, 32000, 32768), (256, 8960, 1536, 0), (7, 512, 200, 0),
    (37, 5632, 2048, 0), (512, 2048, 2048, 0), (3, 1024, 202, 0)])
def test_k3_q5_matches_plain(dev, m, k, n, n_pad, fmt, xdtype):
    _k3_case(dev, m, k, n, n_pad, xdtype, fmt)


@pytest.mark.parametrize("switch", ["ZLLM_QMM_HBM", "ZLLM_QMM_DUALDOT"])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
@pytest.mark.parametrize("fmt", Q5_FMTS, ids=lambda t: t.name)
def test_switches_keep_q5_on_k1(dev, fmt, fuse, switch, monkeypatch):
    """Under ZLLM_QMM_HBM=1 or ZLLM_QMM_DUALDOT=1 a Q5 matvec launches K1
    (zllm sends no weight with a qh plane to K12 or K11), with K1's bits;
    K12 and K11 refuse the weight."""
    monkeypatch.setenv(switch, "1")
    k, n = 2048, 2560
    w = _qweight(n, k, 7, dev, fmt)
    x = _randn((1, 2 * k if fuse == "glu" else k), 8, dev, scale=2.0)
    aux = _randn((k,), 9, dev, scale=0.1) + 1.0 if fuse == "norm" else None
    kernels = (tq.q4k_matvec, tq.q4k_matvec_hbm, tq.w4a8dd_matvec)
    before = [f.launches for f in kernels]
    got = tq.matvec(x, w, fuse, aux, 1e-5)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(kernels, before)] == [1, 0, 0]
    monkeypatch.delenv(switch)
    assert torch.equal(got, tq.q4k_matvec(x, w, fuse, aux, 1e-5))
    with pytest.raises(NotImplementedError, match="K12"):
        tq.q4k_matvec_hbm(x, w, fuse, aux, 1e-5)
    with pytest.raises(NotImplementedError, match="K11"):
        tq.w4a8dd_matvec(x[:, :k], w)


REQUANTIZED = ("Q5_K_M", "Q3_K_M", "IQ4_XS", "TQ2_0", "TQ1_0")


@pytest.mark.parametrize("ftype", ["Q5_0", "Q5_1", "Q5_K_M",
                                   "Q2_K", "Q3_K_M", "IQ4_NL", "IQ4_XS", "MXFP4",
                                   *(t.name for t in IQ_GRID_TYPES), "TQ2_0", "TQ1_0", "BF16"])
def test_q5_model_gpu_matches_cpu(dev, ftype, tmp_path):
    """A 2-layer llama file (Q5_0, Q5_1, Q2_K, IQ4_NL and MXFP4 from the
    factory: every matmul in the type; Q5_K_M, Q3_K_M and IQ4_XS by
    `zllm_torch.quantize` from an F16 one; the IQ grid presets from the
    factory's `ftype=`: wv Q4_K, the head Q5_K) on the card and on the CPU
    (plain versions), f32 model and caches, fed the same tokens: the
    prefill logits and 8 decode steps' within nmse 1e-3 (chip_smoke.py's
    small-model tolerance: an f32 sum order can move an int8 activation
    code or a bf16 operand, which the random weights carry to ~1e-4), and
    the matmul kernels of its matmul type launched: K1 and K3 for the Q5
    files (K4/K5 for Q5_K_M's Q6_K wv and head), K4 and K5 for the low-bit
    ones (K1/K3 for Q3_K_M's Q5_K wv), K5 and not K4 for IQ1_M; TQ2_0 and
    TQ1_0 by `zllm_torch.quantize` (the head Q6_K, the embedding Q4_K) on
    K4 and K5; BF16 from the factory, every matmul dense (`torch.matmul`),
    no K4 or K5."""
    from zllm_torch.models.loader import Model
    from zllm_torch.quantize import quantize_file
    from zllm_torch.runtime.generate import Generator
    from zllm_torch.testing import make_llama_gguf

    shape = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512, vocab_size=512,
                 seed=0)
    path = str(tmp_path / "m.gguf")
    if ftype in REQUANTIZED:
        src = make_llama_gguf(str(tmp_path / "f16.gguf"), gtype=GGMLType.F16, **shape)
        quantize_file(src, path, ftype, quiet=True)
    elif GGMLType[ftype] in IQ_GRID_TYPES:
        make_llama_gguf(path, ftype=ftype, **shape)
    else:
        make_llama_gguf(path, gtype=GGMLType[ftype], **shape)
    gens = {d: Generator(Model.load(path, device=d, dtype=torch.float32), max_len=128,
                         prefill_chunk=16, kv_dtype=torch.float32) for d in ("cuda", "cpu")}
    prompt = [1] + list(range(40, 59))
    kernels = ((tq.q4k_matvec, tq.q4k_gemm) if ftype.startswith("Q5")
               else (tq.dequant_gemm,) if ftype == "IQ1_M"
               else () if ftype == "BF16"
               else (tq.int8_matvec, tq.dequant_gemm))
    k4_before = tq.int8_matvec.launches
    before = [f.launches for f in kernels]
    rows = {d: [g.prefill(prompt).float().cpu()] for d, g in gens.items()}
    tok = int(torch.argmax(rows["cpu"][0]))
    for i in range(8):
        for d, g in gens.items():
            rows[d].append(g._decode_one(tok, len(prompt) + i).float().cpu())
        tok = int(torch.argmax(rows["cpu"][-1]))
    torch.cuda.synchronize()
    assert all(f.launches > n for f, n in zip(kernels, before))
    if ftype in ("IQ1_M", "BF16"):
        assert tq.int8_matvec.launches == k4_before
    for step, (a, b) in enumerate(zip(rows["cuda"], rows["cpu"])):
        assert bool(torch.isfinite(a).all()) and _nmse(a, b) < 1e-3, step


# ---------------------------------------------------------------------------
# K4 and K5 in their Q2_K, Q3_K, IQ4_NL, IQ4_XS and MXFP4 forms
# ---------------------------------------------------------------------------

# GGUF block bytes and the offsets of the fp16 scales (Q2_K d, dmin; Q3_K
# d; IQ4_NL, IQ4_XS d); MXFP4's exponent byte at 0
LOWBIT_BLOCKS = {GGMLType.Q2_K: (84, (80, 82), 256), GGMLType.Q3_K: (110, (108,), 256),
                 GGMLType.IQ4_NL: (18, (0,), 32), GGMLType.IQ4_XS: (136, (0,), 256),
                 GGMLType.MXFP4: (17, (), 32)}


@pytest.mark.parametrize("fmt", LOWBIT_FMTS, ids=lambda t: t.name)
def test_k4_k5_lowbit_random_blocks(dev, fmt):
    """Random bytes in every code, third-bit, index and scale position, fp16
    scales drawn from a finite range, MXFP4 exponents around 2^0 (K4 also
    with exponents 0 and 1, the subnormal scales), held column by column: a
    crumb, bit, table or slot slip shows in the columns it hits.  K5 at M =
    4 (row form) and 256 (tile form)."""
    n, k = 256, 2048
    size, scales, per = LOWBIT_BLOCKS[fmt]
    rng = np.random.default_rng(size)
    raw = rng.integers(0, 256, size=(n * k // per, size), dtype=np.uint8)
    for off in scales:
        vals = rng.uniform(-0.02, 0.02, size=raw.shape[0]).astype(np.float16)
        raw[:, off:off + 2] = vals.view(np.uint8).reshape(-1, 2)
    if fmt == GGMLType.MXFP4:
        raw[:, 0] = rng.integers(115, 135, size=raw.shape[0])
    w = repack(raw.reshape(n, -1), (n, k), fmt, dev)
    for m in (4, 256):
        xm = _randn((m, k), 5, dev)
        got, want = tq.dequant_gemm(xm, w), tq.dequant_gemm_plain(xm, w)
        col_err = ((got - want) ** 2).sum(0) / ((want ** 2).sum(0) + 1e-30)
        assert float(col_err.max()) < 1e-6, m
    if fmt == GGMLType.MXFP4:
        raw[::3, 0] = rng.integers(0, 2, size=raw[::3].shape[0])
        w = repack(raw.reshape(n, -1), (n, k), fmt, dev)
    x = _randn((1, k), 4, dev)
    got, want = tq.int8_matvec(x, w), tq.int8_matvec_plain(x, w)
    # exact integer dots: only the f32 sum order differs in any column
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("fmt", TQ_FMTS, ids=lambda t: t.name)
def test_k4_k5_tq_random_blocks(dev, fmt):
    """Random bytes in every code byte (TQ1_0: any base-3 byte; TQ2_0: the
    crumb 3 too, the value 2, which no encoder writes), d finite, held
    column by column: a crumb or slot slip shows in the columns it hits.
    K5 at M = 4 (row form) and 256 (tile form), their rows equal bit for
    bit; K4 at M = 1."""
    n, k = 256, 2048
    size, off = {GGMLType.TQ1_0: (54, 52), GGMLType.TQ2_0: (66, 64)}[fmt]
    rng = np.random.default_rng(size)
    raw = rng.integers(0, 256, size=(n * k // 256, size), dtype=np.uint8)
    vals = rng.uniform(-0.02, 0.02, size=raw.shape[0]).astype(np.float16)
    raw[:, off:off + 2] = vals.view(np.uint8).reshape(-1, 2)
    w = repack(raw.reshape(n, -1), (n, k), fmt, dev)
    xm = _randn((256, k), 5, dev)
    full = tq.dequant_gemm(xm, w)
    for m in (4, 256):
        got, want = tq.dequant_gemm(xm[:m], w), tq.dequant_gemm_plain(xm[:m], w)
        col_err = ((got - want) ** 2).sum(0) / ((want ** 2).sum(0) + 1e-30)
        assert float(col_err.max()) < 1e-6, m
        assert torch.equal(got, full[:m])
    x = _randn((1, k), 4, dev)
    got, want = tq.int8_matvec(x, w), tq.int8_matvec_plain(x, w)
    # exact integer dots: only the f32 sum order differs in any column
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("switch", ["ZLLM_QMM_HBM", "ZLLM_QMM_DUALDOT"])
@pytest.mark.parametrize("fmt", LOWBIT_FMTS + IQ_FMTS[:-1] + TQ_FMTS, ids=lambda t: t.name)
def test_switches_keep_lowbit_on_k4(dev, fmt, switch, monkeypatch):
    """Under ZLLM_QMM_HBM=1 or ZLLM_QMM_DUALDOT=1 a matvec of the five
    formats, of the six IQ grid formats K4 takes, or of TQ1_0 and TQ2_0,
    launches K4, with K4's bits."""
    monkeypatch.setenv(switch, "1")
    k, n = 2048, 2560
    w = _int_weight(fmt, n, k, 7, dev)
    x = _randn((1, k), 8, dev, scale=2.0)
    kernels = (tq.int8_matvec, tq.q4k_matvec, tq.q4k_matvec_hbm, tq.w4a8dd_matvec)
    before = [f.launches for f in kernels]
    got = tq.matvec(x, w)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(kernels, before)] == [1, 0, 0, 0]
    monkeypatch.delenv(switch)
    assert torch.equal(got, tq.int8_matvec(x, w))


def test_k4_lowbit_chain_in_a_graph(dev):
    """K4 after K4 and K1 after K4, with programmatic dependent launch, as a
    Q3_K_M step runs them: gate|up (K4 Q3_K norm 2048->11264) -> down (K4
    Q3_K glu 5632->2048) -> K1 (Q5_K q 2048->256) on its output.  Replayed
    from a CUDA graph with the input rewritten between replays, each replay
    gives the eager chain's bits."""
    d, ff = 2048, 5632
    w_gu = _int_weight(GGMLType.Q3_K, 2 * ff, d, 1, dev)
    w_dn = _int_weight(GGMLType.Q3_K, d, ff, 2, dev)
    w_v = _qweight(256, d, 3, dev, GGMLType.Q5_K)
    aux = _randn((d,), 5, dev, scale=0.1) + 1.0
    x = _randn((1, d), 6, dev, torch.bfloat16, scale=3.0)

    def chain():
        gu = tq.int8_matvec(x, w_gu, "norm", aux, 1e-5)
        dn = tq.int8_matvec(gu, w_dn, "glu", None, 1e-5)
        return gu, dn, tq.q4k_matvec(dn, w_v, "q", None, 1e-5)

    def rewrite(i):
        x.copy_(_randn((1, d), 100 + i, dev, torch.bfloat16, scale=3.0))

    gu, dn, v = _replays_equal_eager(chain, rewrite)
    assert _nmse(dn, tq.int8_matvec_plain(gu, w_dn, "glu", None, 1e-5)) < 1e-6
    assert _nmse(v, tq.q4k_matvec_plain(dn, w_v, "q", None, 1e-5)) < 1e-6


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "imatrix"])
@pytest.mark.parametrize("fmt", IQ_GRID_TYPES, ids=lambda t: t.name)
def test_iq_fit_card_matches_cpu(dev, fmt, weighted):
    """The IQ grid fit on the card against the CPU fit (zllm's bytes there)
    on a 64 x 2048 matrix: at least 99 % of the 256-blocks equal (the
    products' sum order may part a near-tie of two grid rows) and the
    weighted error within 0.1 % of the CPU's."""
    r = np.random.default_rng(11)
    x = (r.standard_normal((64, 2048)) * (1 + 2 * r.random((64, 2048)))).astype(np.float32)
    w = (0.05 + r.random(2048) ** 2 * 10).astype(np.float32) if weighted else None
    card = qb.quantize(x, fmt, weights=w, device="cuda")
    cpu = qb.quantize(x, fmt, weights=w, device="cpu")
    bsz = qb.GGML_BLOCK_SIZES[fmt][1]
    assert (card.reshape(-1, bsz) == cpu.reshape(-1, bsz)).all(1).mean() >= 0.99
    wt = np.ones(2048, np.float32) if w is None else w

    def err(raw):
        return float((wt * (qb.dequantize(raw, fmt) - x).astype(np.float64) ** 2).sum())

    assert abs(err(card) - err(cpu)) <= 1e-3 * err(cpu)


def test_imatrix_card_matches_plain(dev, tmp_path, monkeypatch):
    """`collect_imatrix` on the card (K5 for the Q8_0 GEMMs, K6) against the
    same collection through their plain versions on the card, a 2-layer
    Q8_0 model in f32, 4 chunks of 64 at batch 2: each tensor's sums
    within nmse 1e-6 (K5 rounds its f32 x to bf16, so an f32 sum-order
    difference upstream may move one such rounding), counts equal, and
    the kernels launched."""
    from zllm_torch import imatrix as ti
    from zllm_torch.models import llama
    from zllm_torch.models.loader import Model
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "m.gguf"), n_layers=2, n_embd=256, n_heads=4,
                           n_kv_heads=2, n_ff=512, vocab_size=512, gtype=GGMLType.Q8_0, seed=3)
    m = Model.load(path, device="cuda", dtype=torch.float32)
    ids = np.random.default_rng(3).integers(3, 512, 4 * 64).tolist()
    before = (tq.dequant_gemm.launches, ta.flash_attention.launches)
    sums, counts = ti.collect_imatrix(m, ids, n_ctx=64, batch=2)
    assert (tq.dequant_gemm.launches - before[0], ta.flash_attention.launches - before[1]) == (
        2 * (4 * 2 + 1), 2 * 2)
    monkeypatch.setattr(tq, "dequant_gemm", tq.dequant_gemm_plain)
    monkeypatch.setattr(llama, "flash_attention", ta.flash_attention_plain)
    psums, pcounts = ti.collect_imatrix(m, ids, n_ctx=64, batch=2)
    assert counts == pcounts and set(sums) == set(psums)
    for name in sums:
        assert _nmse(torch.from_numpy(sums[name]), torch.from_numpy(psums[name])) <= 1e-6, name


@pytest.mark.parametrize("src", ["bfloat16", "float32"])
def test_q8_quant_and_slot_restore_match_the_cpu(dev, src, tmp_path):
    """The q8 cache's quantize on the card, codes and scales bit for bit
    the CPU's (max|x| / 127 a true division, as numpy's), and a slot file
    requantized into a card cache as into a CPU one."""
    import types

    from zllm_torch.runtime import state
    from zllm_torch.runtime.kvcache import KVCache, KVCacheQ8

    g = torch.Generator().manual_seed(0)
    x = (torch.randn(4, 8, 512, 128, generator=g) * torch.rand(4, 8, 512, 1, generator=g) * 8)
    x = x.to(getattr(torch, src))
    qc, sc = KVCacheQ8._quant(x)
    qg, sg = KVCacheQ8._quant(x.to(dev))
    assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)

    model = types.SimpleNamespace(cfg=types.SimpleNamespace(arch="llama", n_layers=2,
                                                            n_kv_heads=8, head_dim=128))
    src_kv = KVCache(k=[x[:2].clone(), x[2:].clone()], v=[x[2:].clone(), x[:2].clone()])
    path = str(tmp_path / "slot.bin")
    state.seq_save_file(path, model, src_kv, 1, 500)
    cpu = KVCacheQ8.create(2, 2, 512, 8, 128, device="cpu")
    card = KVCacheQ8.create(2, 2, 512, 8, 128, device=dev)
    state.seq_load_file(path, model, cpu, 0)
    state.seq_load_file(path, model, card, 0)
    for name in ("k", "v", "ks", "vs"):
        for a, b in zip(getattr(card, name), getattr(cpu, name)):
            assert torch.equal(a.cpu(), b)


VERIFY_CASES = [("contiguous", torch.bfloat16, "llama"), ("contiguous", torch.float16, "llama"),
                ("contiguous", torch.float32, "llama"), ("contiguous", torch.bfloat16, "olmo2"),
                ("contiguous", torch.float16, "olmo2"), ("paged", torch.bfloat16, "llama"),
                ("paged", torch.float16, "llama"), ("q8", None, "llama")]


@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32], ids=["bf16_q", "f32_q"])
@pytest.mark.parametrize("kind,kv_dtype,arch", VERIFY_CASES,
                         ids=[f"{c}_{str(d).split('.')[-1]}_{a}" for c, d, a in VERIFY_CASES])
def test_verify_columns_get_decode_bits_on_card(dev, kind, kv_dtype, arch, act, monkeypatch):
    """A speculative verify step (`forward(..., verify=True)`) runs the T=1
    kernel once a column (K2, K8, K9, K7's split form): each column of a
    speculating row equals the decode step at its position bit for bit,
    and the committed slots hold what the decode steps write
    (tests/test_torch_verify_step.py holds the same on the CPU)."""
    from test_torch_verify_step import verify_matches_decode

    verify_matches_decode(kind, kv_dtype, arch, dev, act, monkeypatch)


# ---- head_dim 256 (the Gemma text families) and windows past the window ----
# (Hq, Hkv) of Gemma-2-2B / Gemma-3-4B (2:1 GQA) and Gemma-2B (8:1 MQA)
GEMMA_HEADS = {"g2": (8, 4), "g8": (8, 1)}
KV3 = [torch.float32, torch.bfloat16, torch.float16]
KV3_IDS = ["f32", "bf16", "f16"]


@pytest.mark.parametrize("cdtype", KV3, ids=KV3_IDS)
@pytest.mark.parametrize("case", ["gemma2", "gemma3", "gemma1", "trash", "bf16q", "long_span"])
def test_k2_d256_matches_plain(dev, case, cdtype):
    """K2's head_dim-256 form: Gemma-2's block (8 / 4 heads, softcap 50,
    window 4096, scale 1/16) at 5000 past its window; Gemma-3's (per-head
    q/k norms, window 1024) at 3000; Gemma-1's MQA (8 / 1); a trash row;
    a bf16 q; a span of several chunks (window 0, pos 6000)."""
    hq, hkv = GEMMA_HEADS["g8" if case == "gemma1" else "g2"]
    d, s = 256, 8192 + 128
    pos_vals = {"gemma2": [5000, 100], "gemma3": [3000, 1500], "trash": [s, 700],
                "long_span": [6000, 8191]}.get(case, [4500, 2])
    window = {"gemma2": 4096, "gemma3": 1024, "trash": 1024}.get(case, 0)
    qdtype = torch.bfloat16 if case == "bf16q" else torch.float32
    b = len(pos_vals)
    qkv3 = _randn((b, hq + 2 * hkv, d), 40, dev, qdtype)
    kc = _randn((b, hkv, s, d), 41, dev, cdtype)
    vc = _randn((b, hkv, s, d), 42, dev, cdtype)
    qw = _randn((d,), 43, dev) if case == "gemma3" else None
    kw = _randn((d,), 44, dev) if case == "gemma3" else None
    pos = torch.tensor(pos_vals, dtype=torch.int32, device=dev)
    base = 1e4 if case != "gemma3" else 1e6
    rope = tl.RopeParams(dim=d, base=base, style="neox")
    rt = tl.rope_table(pos, rope, d)
    kw_args = dict(scale=1 / 16, softcap=50.0 if case == "gemma2" else 0.0, window=window,
                   eps=1e-6)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = ta.attn_decode_qkv.launches
    got = ta.attn_decode_qkv(qkv3, k1, v1, pos, rt, qw, kw, **kw_args)
    want = ta.attn_decode_qkv_plain(qkv3, k2, v2, pos, rt, qw, kw, **kw_args)
    torch.cuda.synchronize()
    assert ta.attn_decode_qkv.launches == before + 1
    assert got.dtype == qdtype and got.shape == (b, 1, hq, d)
    assert _nmse(got.float(), want.float()) < 1e-5
    assert torch.equal(v1, v2) and _nmse(k1.float(), k2.float()) < 1e-9


@pytest.mark.parametrize("kvdtype", KV3, ids=KV3_IDS)
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16], ids=["f32q", "bf16q"])
@pytest.mark.parametrize("case", ["gemma2", "gemma3", "gemma1", "ragged", "rows"])
def test_k6_d256_matches_plain(dev, case, qdtype, kvdtype):
    """K6's head_dim-256 form (64-slot chunks on the tensor cores, the tile
    loop for f32 K/V): a 256-token chunk from 4352 under Gemma-2's window
    4096 and softcap 50, from 1280 under Gemma-3's 1024, Gemma-1's MQA from
    0; a ragged T 37; `rows`: a row of a T 44 call equals the T 128 call's
    bit for bit."""
    hq, hkv = GEMMA_HEADS["g8" if case == "gemma1" else "g2"]
    d, s = 256, 4736
    t = 37 if case == "ragged" else 256 if case != "rows" else 128
    base = {"gemma2": 4352, "gemma3": 1280, "gemma1": 0, "ragged": 900}.get(case, 2000)
    window = {"gemma2": 4096, "gemma3": 1024, "rows": 1024}.get(case, 0)
    q = _randn((1, t, hq, d), 50, dev, qdtype)
    k = _randn((1, hkv, s, d), 51, dev, kvdtype)
    v = _randn((1, hkv, s, d), 52, dev, kvdtype)
    positions = (base + torch.arange(t, device=dev, dtype=torch.int32))[None]
    kw = dict(scale=1 / 16, softcap=50.0 if case == "gemma2" else 0.0, window=window)
    before = (ta.flash_attention.launches, ta.flash_attention.mma_launches)
    got = ta.flash_attention(q, k, v, positions, **kw)
    torch.cuda.synchronize()
    assert ta.flash_attention.launches == before[0] + 1
    assert ta.flash_attention.mma_launches == before[1] + (kvdtype != torch.float32)
    if case == "rows":
        short = ta.flash_attention(q[:, :44].contiguous(), k, v, positions[:, :44], **kw)
        torch.cuda.synchronize()
        assert torch.equal(short, got[:, :44])
        return
    want = ta.flash_attention_plain(q, k, v, positions, **kw)
    assert got.dtype == qdtype and got.shape == q.shape
    assert _nmse(got.float(), want.float()) < 1e-5


@pytest.mark.parametrize("qdtype,pdtype", [(torch.float32, torch.float32),
                                           (torch.float32, torch.bfloat16),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.float16)],
                         ids=["f32-f32", "f32-bf16", "bf16-bf16", "f32-f16"])
@pytest.mark.parametrize("case", ["gemma1", "gemma2_window", "gemma3_window", "gen_row"])
def test_k10_d256_matches_plain(dev, case, qdtype, pdtype):
    """K10's head_dim-256 form (64-slot chunks of 128-slot pages; f32 pools
    the tile loop): Gemma-1's MQA over 2048 slots, the Gemma-2/3 windows
    with rows past them, a mixed step's generating row and an idle row."""
    hq, hkv = GEMMA_HEADS["g8" if case == "gemma1" else "g2"]
    b, d, ps, lp, t = 3, 256, 128, 16, 128
    window = {"gemma2_window": 600, "gemma3_window": 1024}.get(case, 0)
    q = _randn((b, t, hq, d), 60, dev, qdtype)
    k_pool, v_pool, table = _paged_inputs(b, hkv, d, lp, ps, pdtype, dev, 61)
    starts = torch.tensor([0, 1200, lp * ps], dtype=torch.int32, device=dev)
    if case == "gen_row":
        starts[1] = 1777
    positions = starts[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None]
    kw = dict(page_size=ps, scale=1 / 16, softcap=50.0 if case == "gemma2_window" else 0.0,
              window=window)
    before = ta.paged_attention.launches
    got = ta.paged_attention(q, k_pool, v_pool, table, positions, **kw)
    want = ta.paged_attention_plain(q, k_pool, v_pool, table, positions, **kw)
    torch.cuda.synchronize()
    assert ta.paged_attention.launches == before + 1
    live = (starts < lp * ps).cpu()
    assert bool(torch.isfinite(got).all())
    assert _nmse(got[live].float(), want[live].float()) < 1e-6


@pytest.mark.parametrize("qdtype,pdtype", [(torch.float32, torch.bfloat16),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.float16),
                                           (torch.bfloat16, torch.float16)],
                         ids=["f32-bf16", "bf16-bf16", "f32-f16", "bf16-f16"])
@pytest.mark.parametrize("case", ["gemma1", "gemma2_window", "gemma3_window", "long"])
def test_k9_d256_matches_plain(dev, case, qdtype, pdtype):
    """K9's head_dim-256 form (q's fragments in shared memory): Gemma-1's
    MQA, the Gemma-2/3 windows with rows past them (the window's first page
    mid-span), 65 pages a row; the pools bit-identical outside the trash
    page."""
    hq, hkv = GEMMA_HEADS["g8" if case == "gemma1" else "g2"]
    b, d, ps = 4, 256, 128
    lp = 65 if case == "long" else 40
    window = {"gemma2_window": 4096, "gemma3_window": 1024}.get(case, 0)
    pos_vals = {"long": [8000, 4100, 0, lp * ps]}.get(case, [5000, 1100, 127, lp * ps])
    positions = torch.tensor(pos_vals, dtype=torch.int32, device=dev)[:, None]
    q = _randn((b, 1, hq, d), 70, dev, qdtype)
    kn = _randn((b, 1, hkv, d), 71, dev, qdtype)
    vn = _randn((b, 1, hkv, d), 72, dev, qdtype)
    k_pool, v_pool, table = _paged_inputs(b, hkv, d, lp, ps, pdtype, dev, 73)
    k2, v2 = k_pool.clone(), v_pool.clone()
    kw = dict(page_size=ps, scale=1 / 16, softcap=50.0 if case == "gemma2_window" else 0.0,
              window=window)
    got = ta.paged_attn_decode_update(q, kn, vn, k_pool, v_pool, table, positions, **kw)
    want = ta.paged_attn_decode_update_plain(q, kn, vn, k2, v2, table, positions, **kw)
    torch.cuda.synchronize()
    live = positions[:, 0] < lp * ps
    assert _nmse(got[live].float(), want[live].float()) < 1e-6
    assert torch.equal(k_pool[:, ps:], k2[:, ps:]) and torch.equal(v_pool[:, ps:], v2[:, ps:])


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("kernel", ["k2", "k6", "k9", "k10"])
def test_windowed_forms_past_the_window(dev, kernel, d):
    """Each kernel's windowed form at d 64, 128 and 256, bf16 K/V, every
    query past a window of 300 whose first slot lies mid-chunk, so the
    chunks (pages) below pos - window are skipped."""
    hq, hkv, w = 8, 2, 300
    scale = d ** -0.5
    if kernel == "k2":
        s = 2176
        pos = torch.tensor([1700, 2047], dtype=torch.int32, device=dev)
        qkv3 = _randn((2, hq + 2 * hkv, d), 80, dev)
        kc = _randn((2, hkv, s, d), 81, dev, torch.bfloat16)
        vc = _randn((2, hkv, s, d), 82, dev, torch.bfloat16)
        rt = tl.rope_table(pos, tl.RopeParams(dim=d, style="neox"), d)
        k2c, v2c = kc.clone(), vc.clone()
        got = ta.attn_decode_qkv(qkv3, kc, vc, pos, rt, scale=scale, window=w)
        want = ta.attn_decode_qkv_plain(qkv3, k2c, v2c, pos, rt, scale=scale, window=w)
        tol = 1e-5
    elif kernel == "k6":
        s, t = 2176, 128
        q = _randn((2, t, hq, d), 83, dev)
        k = _randn((2, hkv, s, d), 84, dev, torch.bfloat16)
        v = _randn((2, hkv, s, d), 85, dev, torch.bfloat16)
        pos = torch.tensor([[1000], [1900]], dtype=torch.int32, device=dev) + torch.arange(
            t, dtype=torch.int32, device=dev)[None]
        got = ta.flash_attention(q, k, v, pos, scale=scale, window=w)
        want = ta.flash_attention_plain(q, k, v, pos, scale=scale, window=w)
        tol = 1e-5
    else:
        b, lp, ps = 2, 16, 128
        k_pool, v_pool, table = _paged_inputs(b, hkv, d, lp, ps, torch.bfloat16, dev, 86)
        if kernel == "k9":
            pos = torch.tensor([[1700], [2047]], dtype=torch.int32, device=dev)
            q = _randn((b, 1, hq, d), 87, dev)
            kn, vn = _randn((b, 1, hkv, d), 88, dev), _randn((b, 1, hkv, d), 89, dev)
            kp2, vp2 = k_pool.clone(), v_pool.clone()
            got = ta.paged_attn_decode_update(q, kn, vn, k_pool, v_pool, table, pos,
                                              page_size=ps, scale=scale, window=w)
            want = ta.paged_attn_decode_update_plain(q, kn, vn, kp2, vp2, table, pos,
                                                     page_size=ps, scale=scale, window=w)
        else:
            t = 64
            q = _randn((b, t, hq, d), 90, dev)
            pos = torch.tensor([[1000], [1900]], dtype=torch.int32, device=dev) + torch.arange(
                t, dtype=torch.int32, device=dev)[None]
            got = ta.paged_attention(q, k_pool, v_pool, table, pos, page_size=ps, scale=scale,
                                     window=w)
            want = ta.paged_attention_plain(q, k_pool, v_pool, table, pos, page_size=ps,
                                            scale=scale, window=w)
        tol = 1e-6
    torch.cuda.synchronize()
    assert _nmse(got.float(), want.float()) < tol


def test_k7_k8_refuse_d256_and_k9_f32_pools(dev):
    """K8 has no head_dim-256 form (ROADMAP queue 2), nor K9 over an f32
    pool: each raises a ValueError, launching nothing; K7 takes head_dim
    256 (the same call matches its plain version)."""
    q = _randn((1, 1, 8, 256), 91, dev)
    kc = _randn((1, 1, 512, 256), 92, dev, torch.bfloat16)
    pos = torch.tensor([[10]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="K8"):
        ta.attn_decode_update(q, q[:, :, :1], q[:, :, :1], kc, kc.clone(), pos, scale=0.0625)
    got = ta.flash_attention_blockwise(q, kc, kc.clone(), pos, scale=0.0625)
    want = ta.flash_attention_blockwise_plain(q, kc, kc.clone(), pos, scale=0.0625)
    torch.cuda.synchronize()
    assert _nmse(got, want) < 1e-6
    k_pool, v_pool, table = _paged_inputs(1, 1, 256, 4, 128, torch.float32, dev, 93)
    with pytest.raises(ValueError, match="f32 pool"):
        ta.paged_attn_decode_update(q, q[:, :, :1], q[:, :, :1], k_pool, v_pool, table, pos,
                                    page_size=128, scale=0.0625)


# ---- mixture-of-experts: the experts on K3 / K5 --------------------------------

@pytest.mark.parametrize("fmt", [GGMLType.Q4_K, GGMLType.Q6_K], ids=lambda f: f.name)
def test_expert_rows_do_not_depend_on_m(dev, fmt):
    """An expert of a stack (Qwen3-30B-A3B's gate shape, 768 x 2048, and
    its down's, 2048 x 768) through K3 (Q4_K) or K5 (Q6_K): a row alone
    (M = 1) and four rows equal the same rows of a 256-row call bit for
    bit; the plain version within nmse 1e-6."""
    from zllm_torch.quant.repack import repack_experts

    for n, k in ((768, 2048), (2048, 768)):
        rng = np.random.default_rng(n)
        raw = qb.quantize(rng.standard_normal((4, n, k)).astype(np.float32) * 0.05, fmt)
        w = repack_experts(raw, (4, n, k), fmt, dev).expert(2)
        x = _randn((256, k), 7, dev, torch.bfloat16)
        full = tq.gemm(x, w)
        assert torch.equal(tq.gemm(x[:1], w)[0], full[0])
        assert torch.equal(tq.gemm(x[37:41], w), full[37:41])
        assert _nmse(full, tq.dequant_gemm_plain(x, w)) < 1e-6


def test_moe_ffn_rows_and_launches(dev):
    """moe_ffn on the card (a qwen3moe-shaped layer: 2048 wide, 16 experts
    of 768, top-4, Q4_K gate|up and Q6_K down stacks, a bf16 router): a
    token alone and inside a 256-token chunk gets the same output bits;
    the expert launches are K3 and K5 once each a used expert, as the
    recorded routing says."""
    from types import SimpleNamespace

    from zllm_torch.models.config import MoeConfig
    from zllm_torch.models.llama import moe_ffn
    from zllm_torch.quant.repack import concat_experts, repack_experts

    e, d, f = 16, 2048, 768
    rng = np.random.default_rng(8)

    def stack(n, k, fmt):
        raw = qb.quantize(rng.standard_normal((e, n, k)).astype(np.float32) * 0.05, fmt)
        return repack_experts(raw, (e, n, k), fmt, dev)

    lay = {"ffn_gate_inp": _randn((d, e), 10, dev, torch.bfloat16, scale=0.05),
           "ffn_gateup_exps": concat_experts([stack(f, d, GGMLType.Q4_K),
                                              stack(f, d, GGMLType.Q4_K)]),
           "ffn_down_exps": stack(d, f, GGMLType.Q6_K)}
    cfg = SimpleNamespace(moe=MoeConfig(n_experts=e, n_experts_used=4, n_ff_exp=f), act="silu")
    h = _randn((1, 256, d), 9, dev, torch.bfloat16)
    k3, k5 = tq.q4k_gemm.launches, tq.dequant_gemm.launches
    moe_ffn.routing = []
    try:
        full = moe_ffn(lay, cfg, h)
        torch.cuda.synchronize()
        (_, used, *_), = moe_ffn.routing
    finally:
        moe_ffn.routing = None
    assert tq.q4k_gemm.launches - k3 == len(used) and tq.dequant_gemm.launches - k5 == len(used)
    assert torch.equal(moe_ffn(lay, cfg, h[:, :1])[0, 0], full[0, 0])
    assert torch.equal(moe_ffn(lay, cfg, h[:, 100:104]), full[:, 100:104])


# K2's sinks form at gpt-oss's shapes (64 / 8 heads of 64: G 8; its yarn
# rope): (rows' positions, S, window, sink shift)
K2_SINKS_CASES = {
    "decode": ([331], 2048, 0, 0.0),
    "windowed": ([331], 2048, 128, 0.0),
    "rows": ([0, 127, 1000, 2047], 2048, 128, 0.0),
    "sink_above_all": ([331, 5], 2048, 0, 40.0),
    "trash": ([2400], 2176, 128, 0.0),
    "long_span": ([8000], 8192, 0, 0.0),
}


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16], ids=["f32q", "bf16q"])
@pytest.mark.parametrize("cdtype", KV3, ids=KV3_IDS)
@pytest.mark.parametrize("case", list(K2_SINKS_CASES))
def test_k2_sinks_matches_plain(dev, case, cdtype, qdtype):
    """K2's sinks form against its plain version: a sink above every score
    (`sink_above_all`), a trash row so far past the horizon that its window
    holds no slot (`trash`: the sink alone, an output of zeros), a span of
    several chunks (`long_span`);
    the insert as without sinks, and `.sinks_launches` counted."""
    pos_vals, s, window, shift = K2_SINKS_CASES[case]
    b, hq, hkv, d = len(pos_vals), 64, 8, 64
    qkv3 = _randn((b, hq + 2 * hkv, d), 50, dev, qdtype)
    kc, vc = _randn((b, hkv, s, d), 51, dev, cdtype), _randn((b, hkv, s, d), 52, dev, cdtype)
    sinks = _randn((hq,), 53, dev) + shift
    pos = torch.tensor(pos_vals, dtype=torch.int32, device=dev)
    rope = tl.RopeParams(dim=d, base=150000.0, style="neox", scaling="yarn", scale_factor=32.0,
                         orig_ctx=4096)
    rt = tl.rope_table(pos, rope, d)
    kw = dict(scale=d ** -0.5, window=window, sinks=sinks)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = ta.attn_decode_qkv.sinks_launches
    got = ta.attn_decode_qkv(qkv3, k1, v1, pos, rt, **kw)
    want = ta.attn_decode_qkv_plain(qkv3, k2, v2, pos, rt, **kw)
    torch.cuda.synchronize()
    assert ta.attn_decode_qkv.sinks_launches == before + 1
    assert got.dtype == qdtype and bool(torch.isfinite(got).all())
    assert _nmse(got.float(), want.float()) < 1e-5
    assert torch.equal(v1, v2) and _nmse(k1.float(), k2.float()) < 1e-9
    if case != "trash":  # the sinks move the output (the trash row's is all zero)
        plain = ta.attn_decode_qkv(qkv3, kc.clone(), vc.clone(), pos, rt, scale=d ** -0.5,
                                   window=window)
        assert _nmse(plain.float(), got.float()) > 1e-10


@pytest.mark.parametrize("kvdtype", KV3, ids=KV3_IDS)
@pytest.mark.parametrize("window", [0, 128])
def test_k6_sinks_at_gpt_oss_shapes(dev, window, kvdtype):
    """K6 with sinks over a gpt-oss chunk (T 256 from 256, G 8, d 64)."""
    hq, hkv, d, t, s = 64, 8, 64, 256, 1024
    q = _randn((1, t, hq, d), 54, dev)
    k, v = _randn((1, hkv, s, d), 55, dev, kvdtype), _randn((1, hkv, s, d), 56, dev, kvdtype)
    positions = (256 + torch.arange(t, device=dev, dtype=torch.int32))[None]
    kw = dict(scale=d ** -0.5, window=window, sinks=_randn((hq,), 57, dev))
    before = ta.flash_attention.sinks_launches
    got = ta.flash_attention(q, k, v, positions, **kw)
    want = ta.flash_attention_plain(q, k, v, positions, **kw)
    torch.cuda.synchronize()
    assert ta.flash_attention.sinks_launches == before + 1
    assert _nmse(got.float(), want.float()) < 1e-5


@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("t", [1, 128], ids=["decode", "chunk"])
@pytest.mark.parametrize("window", [0, 128])
def test_k7_sinks_at_gpt_oss_shapes(dev, window, t, kv):
    """K7 with sinks at gpt-oss's heads (G 8, d 64) over a 4-slot q8 or bf16
    cache (S 2176, rows at 255, 0, 300 and a trash row)."""
    b, hq, hkv, d, s = 4, 64, 8, 64, 2176
    q = _randn((b, t, hq, d), 58, dev)
    if kv == "int8":
        gen = torch.Generator(device=dev)
        gen.manual_seed(59)
        k, v = (torch.randint(-127, 128, (b, hkv, s, d), generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks = _randn((b, hkv, s, 1), 60, dev).abs() * 0.01 + 1e-3
        vs = _randn((b, hkv, s, 1), 61, dev).abs() * 0.01 + 1e-3
    else:
        k, v = _randn((b, hkv, s, d), 62, dev, torch.bfloat16), _randn((b, hkv, s, d), 63, dev,
                                                                       torch.bfloat16)
        ks = vs = None
    starts = [255, 0, 300, 2048] if t == 1 else [0, 256, 300, 2048]
    positions = (torch.tensor(starts, dtype=torch.int32, device=dev)[:, None]
                 + torch.arange(t, dtype=torch.int32, device=dev)[None])
    kw = dict(scale=d ** -0.5, window=window, ks=ks, vs=vs, sinks=_randn((hq,), 64, dev))
    before = ta.flash_attention_blockwise.sinks_launches
    got = ta.flash_attention_blockwise(q, k, v, positions, **kw)
    want = ta.flash_attention_blockwise_plain(q, k, v, positions, **kw)
    torch.cuda.synchronize()
    assert ta.flash_attention_blockwise.sinks_launches == before + 1
    assert bool(torch.isfinite(got).all()) and _nmse(got.float(), want.float()) < 1e-6


def test_dequant_route_rows_do_not_depend_on_m(dev):
    """A weight zllm's kernels do not take (Q8_0 at K 2880, N 2880; MXFP4
    at K 96) runs x @ dequant(w) by torch.matmul in fixed row blocks: a
    row's bits are the same alone and among 37 rows, and no kernel wrapper
    is launched."""
    from zllm_torch.ops.linear import linear

    launches = {n: getattr(tq, n).launches for n in ("q4k_matvec", "int8_matvec", "q4k_gemm",
                                                     "dequant_gemm")}
    for fmt, n, k in ((GGMLType.Q8_0, 2880, 2880), (GGMLType.MXFP4, 320, 96)):
        w = repack(_qweight_raw(n, k, 70, fmt), (n, k), fmt, dev)
        assert not tq.supports(w)
        for xdtype in (torch.float32, torch.bfloat16):
            x = _randn((37, k), 71, dev, xdtype)
            full = linear(x, w)
            assert full.dtype == torch.float32
            assert torch.equal(linear(x[5:6], w), full[5:6])
            assert torch.equal(linear(x[:4], w), full[:4])
            want = x.float() @ w.dequant(torch.float32).to(xdtype).float()
            assert _nmse(full, want) < 1e-5
    torch.cuda.synchronize()
    assert launches == {n: getattr(tq, n).launches for n in launches}


def test_gpt_oss_model_on_card_matches_cpu(dev, tmp_path):
    """A 2-layer gpt-oss file (320 wide, MXFP4 experts, Q8_0 elsewhere, a
    window of 8, yarn) generated greedily on the card (f32 model and cache)
    gives the CPU's tokens, its logits within nmse 1e-6, every K2 and K6
    launch in its sinks form and no matmul kernel launched."""
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "oss.gguf"), arch="gpt-oss", n_layers=2, n_embd=320,
                           n_heads=4, n_kv_heads=2, head_dim=64, n_ff=96, n_experts=4,
                           n_experts_used=2, vocab_size=512, sliding_window=8,
                           rope_base=150000.0, rope_yarn=(32.0, 64), gtype=GGMLType.Q8_0,
                           expert_gtype=GGMLType.MXFP4)
    prompt = [1] + list(range(40, 79))
    out = {}
    for side in ("cpu", "cuda"):
        m = Model.load(path, device=side, dtype=torch.float32)
        gen = Generator(m, max_len=128, prefill_chunk=16, kv_dtype=torch.float32)
        counters = [ta.attn_decode_qkv, ta.flash_attention, tq.q4k_gemm, tq.dequant_gemm,
                    tq.int8_matvec, tq.q4k_matvec]
        before = [(f.launches, getattr(f, "sinks_launches", 0)) for f in counters]
        logits = [gen.prefill(prompt).float().cpu()]
        toks = [int(torch.argmax(logits[0]))]
        for i in range(8):
            logits.append(gen._decode_one(toks[-1], len(prompt) + i).float().cpu())
            toks.append(int(torch.argmax(logits[-1])))
        out[side] = (toks, torch.stack(logits))
        if side == "cuda":
            torch.cuda.synchronize()
            after = [(f.launches, getattr(f, "sinks_launches", 0)) for f in counters]
            (k2, k2s), (k6, k6s), *mm = [(a - b, c - d) for (a, c), (b, d) in zip(after, before)]
            assert k2 == k2s == 2 * (3 + 8) and k6 == k6s == 2 * 3
            assert all(n == 0 for n, _ in mm)
    assert out["cuda"][0] == out["cpu"][0]
    assert _nmse(out["cuda"][1], out["cpu"][1]) < 1e-6
