"""The port's six CUDA kernels against their plain PyTorch versions, on the
card, over the variants the main path does not reach (dtypes, formats,
head dims, batch rows, sinks, windows, softcap, ragged M and N, the padded
head).

Marked `cuda`: skipped where no CUDA device is visible.  Run on a GPU host
(which needs no JAX) with:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: K1/K4 nmse < 1e-6 (exact integer dots; only f32 sum order, and
an ulp of rsqrt/exp may move one int8 code), K3/K5 < 1e-6 (bf16 operands,
f32 sum order), K2/K6 < 1e-5 (f32 sum order, then one bf16 rounding of a
probability may move by an ulp).
"""

import numpy as np
import pytest
import torch

from zllm_torch.gguf.constants import GGMLType
from zllm_torch.ops import attention as ta
from zllm_torch.ops import layers as tl
from zllm_torch.ops import qmatmul as tq
from zllm_torch.quant import blocks as qb
from zllm_torch.quant.repack import pad_n, repack

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


def _qweight(n: int, k: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    raw = qb.quantize(rng.standard_normal((n, k)).astype(np.float32) * 0.05, GGMLType.Q4_K)
    return repack(raw, (n, k), GGMLType.Q4_K, dev)


def _randn(shape, seed, dev, dtype=torch.float32, scale=1.0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
@pytest.mark.parametrize("k,n", [(256, 40), (2048, 2560), (5632, 2048)])
def test_k1_matches_plain(dev, k, n, fuse, xdtype):
    w = _qweight(n, k, k + n, dev)
    x = _randn((1, 2 * k if fuse == "glu" else k), 1, dev, xdtype, scale=2.0)
    aux = _randn((k,), 2, dev, scale=0.1) + 1.0 if fuse == "norm" else None
    before = tq.q4k_matvec.launches
    got = tq.q4k_matvec(x, w, fuse, aux, 1e-5)
    torch.cuda.synchronize()
    assert tq.q4k_matvec.launches == before + 1
    assert _nmse(got, tq.q4k_matvec_plain(x, w, fuse, aux, 1e-5)) < 1e-6


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(1, 256, 64), (7, 512, 200), (64, 2048, 2560),
                                   (256, 5632, 2048), (256, 2048, 32768)])
def test_k3_matches_plain(dev, m, k, n, xdtype):
    w = _qweight(n, k, m + k + n, dev)
    x = _randn((m, k), 3, dev, xdtype)
    got = tq.q4k_gemm(x, w)
    torch.cuda.synchronize()
    assert got.shape == (m, n)
    assert _nmse(got, tq.q4k_gemm_plain(x, w)) < 1e-6


INT_FMTS = [GGMLType.Q6_K, GGMLType.Q8_0]


def _int_weight(fmt, n: int, k: int, seed: int, dev, n_pad: int = 0):
    """A random Q6_K/Q8_0 weight; `n_pad` > n zero-pads it as the loader
    pads the head."""
    rng = np.random.default_rng(seed)
    raw = qb.quantize(rng.standard_normal((n, k)).astype(np.float32) * 0.05, fmt)
    w = repack(raw, (n, k), fmt, dev)
    return pad_n(w, n_pad) if n_pad else w


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
@pytest.mark.parametrize("fmt", INT_FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("k,n,n_pad", [(256, 128, 0), (2048, 256, 0), (5632, 2048, 0),
                                       (2048, 32000, 32768)])
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


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", INT_FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("m,k,n,n_pad", [(1, 256, 128, 0), (7, 512, 384, 0),
                                         (64, 2048, 256, 0), (256, 5632, 2048, 0),
                                         (256, 2048, 32000, 32768)])
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


@pytest.mark.parametrize("cdtype", [torch.float32, torch.bfloat16], ids=["f32c", "bf16c"])
@pytest.mark.parametrize("case", ["plain", "qknorm", "softcap", "window", "b2", "d128",
                                  "norm_style", "partial", "trash", "pos0", "bf16q"])
def test_k2_matches_plain(dev, case, cdtype):
    b = 2 if case == "b2" else 1
    d = 128 if case == "d128" else 64
    hq, hkv, s = 32, 4, 512
    style = "norm" if case in ("norm_style", "partial") else "neox"
    rope = tl.RopeParams(dim=32 if case == "partial" else d, style=style)
    pos_vals = {"trash": [s], "pos0": [0], "b2": [5, 400]}.get(case, [331])
    qdtype = torch.bfloat16 if case == "bf16q" else torch.float32
    qkv3 = _randn((b, hq + 2 * hkv, d), 4, dev, qdtype)
    kc = _randn((b, hkv, s, d), 5, dev, cdtype)
    vc = _randn((b, hkv, s, d), 6, dev, cdtype)
    qw = _randn((d,), 7, dev) if case == "qknorm" else None
    kw = _randn((d,), 8, dev) if case == "qknorm" else None
    pos = torch.tensor(pos_vals, dtype=torch.int32, device=dev)
    rt = tl.rope_table(pos, rope, d)
    kw_args = dict(scale=d ** -0.5, softcap=30.0 if case == "softcap" else 0.0,
                   window=48 if case == "window" else 0, eps=1e-5)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = ta.attn_decode_qkv(qkv3, k1, v1, pos, rt, qw, kw, **kw_args)
    want = ta.attn_decode_qkv_plain(qkv3, k2, v2, pos, rt, qw, kw, **kw_args)
    torch.cuda.synchronize()
    assert got.dtype == qdtype and got.shape == (b, 1, hq, d)
    assert _nmse(got.float(), want.float()) < 1e-5
    assert torch.equal(v1, v2)
    assert _nmse(k1.float(), k2.float()) < 1e-9


@pytest.mark.parametrize("kvdtype", [torch.float32, torch.bfloat16], ids=["f32kv", "bf16kv"])
@pytest.mark.parametrize("case", ["plain", "sinks", "softcap", "window", "base0", "b2",
                                  "d128", "ragged", "bf16q"])
def test_k6_matches_plain(dev, case, kvdtype):
    b = 2 if case == "b2" else 1
    d = 128 if case == "d128" else 64
    t = 37 if case == "ragged" else 256
    hq, hkv, s = 32, 4, 1024
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
