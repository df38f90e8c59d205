"""K7 (blockwise attention, bf16/f32 or int8 K/V): the port's plain version
against zllm's `flash_attention_blockwise` run with interpret=True.

The cases are those of tests/test_attention.py's blockwise tests (decode
with b=2, MHA prefill, MQA at d=128, window / softcap / sinks, quantized
K/V), plus S = 144 (zllm with block_s=16) and the engine's q8 cache length
S = 2176 (zllm with block_s=128; its default 512 does not divide 2176, and
the port takes any S).  Inputs are f32 (int8 codes and f32 scales for the
quantized cases), made with numpy from a seed.

Tolerance: atol = rtol = 5e-5 in f32.  Both sides compute f32 scores and an
exact softmax; they differ in the sum order over slots (zllm's online
softmax rescales block by block) and in ulps of exp between XLA and
PyTorch."""

import numpy as np
import pytest
import torch
from test_torch_oracle import to_np

from zllm_torch.ops import attention as ta

CASES = {
    # name: (b, t, s, hq, hkv, d, block_s, base, window, softcap, sinks, quant)
    "decode_b2": (2, 1, 512, 8, 2, 64, 128, 200, 0, 0.0, False, False),
    "prefill_mha": (1, 16, 1024, 4, 4, 64, 256, 200, 0, 0.0, False, False),
    "mqa_d128": (1, 8, 256, 8, 1, 128, 128, 200, 0, 0.0, False, False),
    "window": (1, 8, 512, 4, 2, 64, 128, 300, 64, 0.0, False, False),
    "softcap": (1, 8, 512, 4, 2, 64, 128, 300, 0, 30.0, False, False),
    "sinks": (1, 8, 512, 4, 2, 64, 128, 300, 0, 0.0, True, False),
    "window_softcap_sinks": (1, 8, 512, 4, 2, 64, 128, 300, 128, 25.0, True, False),
    "quantized": (2, 4, 512, 8, 2, 64, 128, 400, 0, 0.0, False, True),
    "s144": (2, 4, 144, 8, 2, 64, 16, 100, 0, 0.0, False, True),
    "s144_window_sinks": (1, 16, 144, 4, 2, 64, 16, 120, 40, 0.0, True, True),
    "s2176_decode": (3, 1, 2176, 8, 1, 64, 128, 2040, 0, 0.0, False, True),
    "s2176_chunk": (1, 16, 2176, 8, 2, 64, 128, 2048, 0, 0.0, False, True),
}


def _inputs(case):
    b, t, s, hq, hkv, d, bs, base, window, softcap, sinks, quant = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, size=(b, hkv, s, d)).astype(np.int8)
        v = rng.integers(-127, 128, size=(b, hkv, s, d)).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, size=(b, hkv, s, 1)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, size=(b, hkv, s, 1)).astype(np.float32)
    else:
        k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
        v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
        ks = vs = None
    # each row from its own base, as the engine's slots
    positions = np.stack([np.arange(base + 7 * i, base + 7 * i + t) for i in range(b)])
    sk = rng.standard_normal(hq).astype(np.float32) if sinks else None
    kw = dict(scale=1.0 / d ** 0.5, softcap=softcap, window=window)
    return q, k, v, ks, vs, positions.astype(np.int32), sk, kw, bs


@pytest.mark.parametrize("case", list(CASES))
def test_k7_plain_matches_pallas(case):
    import jax.numpy as jnp

    from zllm.ops.attention import flash_attention_blockwise

    q, k, v, ks, vs, positions, sk, kw, bs = _inputs(case)

    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.from_numpy(x)

    want = flash_attention_blockwise(j(q), j(k), j(v), j(positions), sinks=j(sk), ks=j(ks),
                                     vs=j(vs), block_s=bs, interpret=True, **kw)
    before = ta.flash_attention_blockwise.launches
    got = ta.flash_attention_blockwise(t(q), t(k), t(v), t(positions), sinks=t(sk), ks=t(ks),
                                       vs=t(vs), **kw)
    assert ta.flash_attention_blockwise.launches == before  # the CPU runs the plain version
    assert tuple(got.shape) == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=5e-5, atol=5e-5)


def test_k7_scales_act_where_the_kernel_applies_them():
    """int8 codes with their scales give what the dequantized f32 K/V give:
    the K scale on the score and the V scale on the probability are the
    dequantization, up to f32 reassociation."""
    q, k, v, ks, vs, positions, _, kw, _ = _inputs("quantized")
    got = ta.flash_attention_blockwise(*map(torch.from_numpy, (q, k, v, positions)),
                                       ks=torch.from_numpy(ks), vs=torch.from_numpy(vs), **kw)
    deq = ta.flash_attention_blockwise(
        torch.from_numpy(q), ta.QuantKV(torch.from_numpy(k), torch.from_numpy(ks)).dequant(
            torch.float32), ta.QuantKV(torch.from_numpy(v), torch.from_numpy(vs)).dequant(
            torch.float32), torch.from_numpy(positions), **kw)
    np.testing.assert_allclose(to_np(got), to_np(deq), rtol=2e-5, atol=2e-5)


def test_k7_refuses_codes_without_scales():
    q, k, v, ks, vs, positions, _, kw, _ = _inputs("quantized")
    with pytest.raises(ValueError, match="scales"):
        ta.flash_attention_blockwise(*map(torch.from_numpy, (q, k, v, positions)), **kw)
    with pytest.raises(ValueError, match="scales"):
        ta.flash_attention_blockwise(*map(torch.from_numpy, (q, k.astype(np.float32), v, positions)),
                                     ks=torch.from_numpy(ks), vs=torch.from_numpy(vs), **kw)
