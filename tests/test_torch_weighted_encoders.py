"""The importance-weighted encoders and the IQ grid encoders of
`zllm_torch.quant.blocks` / `zllm_torch.quant.iq_encode` on the CPU,
against `zllm.quant.blocks.quantize(x, t, weights=w)`.

  * the nine weighted K and legacy encoders and TQ1_0's weighted scale
    search: byte-identical to zllm's, with per-column and per-element
    weights, and on rows with zero and constant groups;
  * the seven IQ grid encoders, unweighted and weighted, fitted on
    device="cpu": byte-identical to zllm's on 16 x 512 and 64 x 2048
    matrices (the sums of the fit add in numpy's pairwise order, a
    division by a constant divides, the grid products are MKL's sgemm,
    which sums as numpy's BLAS does);
  * for every weighted format the weighted error is at most the
    unweighted one (zllm's own claim, tests/test_imatrix.py);
  * the device: an IQ encode for "cuda" raises without a card and never
    falls back to the host; every other format ignores the device."""

import numpy as np
import pytest
import torch

from zllm.gguf.constants import GGML_BLOCK_SIZES, GGMLType

from zllm_torch.quant import blocks as tb

KQ = ["Q4_K", "Q5_K", "Q2_K", "Q3_K", "Q6_K", "Q4_0", "Q5_0", "Q4_1", "Q5_1", "TQ1_0"]
IQ = ["IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S", "IQ1_M"]


def _x(rows, cols, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((rows, cols)) * (1 + 2 * r.random((rows, cols)))).astype(np.float32)


def _w(shape, seed):
    r = np.random.default_rng(seed + 100)
    return (0.05 + r.random(shape) ** 2 * 10).astype(np.float32)


def _both(x, name, w):
    from zllm.quant import blocks as zb

    want = zb.quantize(x, GGMLType[name], weights=w)
    got = tb.quantize(x, GGMLType[name], weights=w, device="cpu")
    return want, got


def _equal_blocks(want, got, name) -> float:
    bsz = GGML_BLOCK_SIZES[GGMLType[name]][1]
    return float((want.reshape(-1, bsz) == got.reshape(-1, bsz)).all(1).mean())


@pytest.mark.parametrize("weights", ["columns", "elements"])
@pytest.mark.parametrize("name", KQ)
def test_weighted_encoder_byte_identical(name, weights):
    x = _x(16, 512, 1)
    x[0, :32] = 0.0  # a zero group
    x[1, 32:64] = 0.25  # a constant one
    w = _w((512,) if weights == "columns" else x.shape, 1)
    want, got = _both(x, name, w)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "imatrix"])
@pytest.mark.parametrize("name", IQ)
def test_iq_encoder_matches_zllm(name, weighted):
    for rows, cols, seed in ((16, 512, 2), (64, 2048, 3)):
        x = _x(rows, cols, seed)
        want, got = _both(x, name, _w((cols,), seed) if weighted else None)
        assert got.shape == want.shape
        assert _equal_blocks(want, got, name) == 1.0, (rows, cols)


@pytest.mark.parametrize("name", KQ + IQ)
def test_weighted_error_not_above_plain(name):
    """The imatrix-steered encode's weighted error is at most the plain
    encode's (per-element weights, as zllm's test has them)."""
    t = GGMLType[name]
    x = _x(32, 256, 4)
    w = _w(x.shape, 4)
    plain = tb.dequantize(tb.quantize(x, t, device="cpu"), t)
    steered = tb.dequantize(tb.quantize(x, t, weights=w, device="cpu"), t)
    e_plain = float((w * (plain - x) ** 2).sum())
    e_steer = float((w * (steered - x) ** 2).sum())
    assert e_steer <= e_plain * 1.001, (e_steer, e_plain)


def test_supported_encode_covers_the_grid_formats():
    assert {GGMLType[n] for n in KQ + IQ} <= tb.supported_encode()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
@pytest.mark.parametrize("name", IQ)
def test_iq_encode_for_cuda_raises_without_a_card(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.quantize(_x(2, 256, 5), GGMLType[name])


@pytest.mark.parametrize("name", ["Q4_K", "TQ1_0", "IQ4_XS", "Q8_0"])
def test_other_formats_never_touch_the_device(name, monkeypatch):
    """A format without a grid encodes on the host whatever the device."""
    import zllm_torch.quant.iq_encode as ie

    def no_device(*a, **kw):
        raise AssertionError("the grid fit was reached")

    monkeypatch.setattr(ie, "encode", no_device)
    x = _x(4, 256, 6)
    assert np.array_equal(tb.quantize(x, GGMLType[name], weights=_w((256,), 6), device="cuda"),
                          tb.quantize(x, GGMLType[name], weights=_w((256,), 6), device="cpu"))
