"""K2 (decode attention block) and K6 (prefill attention): the port's plain
versions against zllm's Pallas kernels run with interpret=True, plus the
rope and norm ops they build on.

Tolerances: attention outputs nmse < 1e-6 in f32 (the kernels differ only
in f32 sum order and in ulps of exp/cos/sin between XLA and PyTorch);
cache rows the step must not touch are compared exactly."""

import numpy as np
import pytest
import torch
from test_torch_oracle import nmse, to_np

from zllm_torch.ops import attention as ta
from zllm_torch.ops import layers as tl

RNG = np.random.default_rng(41)


def _rope_pair(style: str, dim: int, scaling: str = "none"):
    from zllm.ops.layers import RopeParams as ZRope

    kw = dict(dim=dim, style=style, base=10000.0)
    if scaling == "yarn":
        kw.update(scaling="yarn", scale_factor=4.0, orig_ctx=2048)
    elif scaling == "llama3":
        kw.update(scaling="llama3", scale_factor=8.0, orig_ctx=8192)
    return ZRope(**kw), tl.RopeParams(**kw)


@pytest.mark.parametrize("style,dim,scaling", [("norm", 64, "none"), ("neox", 64, "none"),
                                               ("neox", 32, "yarn"), ("norm", 64, "llama3")])
def test_apply_rope_and_rotation_match_zllm(style, dim, scaling):
    import jax.numpy as jnp

    from zllm.ops.layers import apply_rope, rope_rot_matrix

    zp, tp = _rope_pair(style, dim, scaling)
    x = RNG.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = np.array([[0, 1, 2, 300, 4000], [7, 8, 9, 10, 11]], np.int32)
    want = apply_rope(jnp.asarray(x), jnp.asarray(pos), zp)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tp)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-5, atol=2e-5)
    rz = rope_rot_matrix(jnp.asarray(pos[:, 3]), zp, 64)
    rt = tl.rope_rot_matrix(torch.from_numpy(pos[:, 3]), tp, 64)
    np.testing.assert_allclose(to_np(rt), to_np(rz), rtol=2e-5, atol=2e-5)
    # the cos/sin table the decode kernel takes computes what R does
    xr = torch.from_numpy(x[:, 3])
    via_table = tl.rope_apply_table(xr, tl.rope_table(torch.from_numpy(pos[:, 3]), tp, 64))
    np.testing.assert_allclose(to_np(via_table), to_np(torch.einsum("bhd,bde->bhe", xr, rt)),
                               rtol=1e-5, atol=1e-5)


def test_rms_norm_and_swiglu_match_zllm():
    import jax.numpy as jnp

    from zllm.ops.layers import rms_norm, swiglu

    x = RNG.standard_normal((3, 256)).astype(np.float32)
    w = RNG.standard_normal(256).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)),
        to_np(rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        to_np(tl.swiglu(torch.from_numpy(x), torch.from_numpy(w))),
        to_np(swiglu(jnp.asarray(x), jnp.asarray(w))), rtol=1e-6, atol=1e-6)


B, HQ, HKV, D, S = 1, 8, 1, 64, 256


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qknorm"])
@pytest.mark.parametrize("pos", [0, 37, 255])
def test_k2_plain_matches_pallas(pos, qk_norm, softcap, window):
    import jax.numpy as jnp

    from zllm.ops.attention import attn_decode_qkv
    from zllm.ops.layers import rope_rot_matrix

    zp, tp = _rope_pair("neox", D)
    rng = np.random.default_rng(pos * 8 + 4 * qk_norm + 2 * (softcap > 0) + (window > 0))
    kc = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    vc = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    qkv3 = rng.standard_normal((B, HQ + 2 * HKV, D)).astype(np.float32)
    qw = rng.standard_normal(D).astype(np.float32) if qk_norm else None
    kw = rng.standard_normal(D).astype(np.float32) if qk_norm else None
    positions = np.array([[pos]], np.int32)
    eps = 1e-5

    want, kz, vz = attn_decode_qkv(
        jnp.asarray(qkv3), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(positions),
        rope_rot_matrix(jnp.asarray(positions[:, 0]), zp, D),
        None if qw is None else jnp.asarray(qw), None if kw is None else jnp.asarray(kw),
        scale=0.125, softcap=softcap, window=window, eps=eps, interpret=True)
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    pt = torch.from_numpy(positions[:, 0])
    got = ta.attn_decode_qkv(
        torch.from_numpy(qkv3), kt, vt, pt, tl.rope_table(pt, tp, D),
        None if qw is None else torch.from_numpy(qw), None if kw is None else torch.from_numpy(kw),
        scale=0.125, softcap=softcap, window=window, eps=eps)
    assert tuple(got.shape) == (B, 1, HQ, D)
    assert nmse(to_np(got), to_np(want)) < 1e-6
    kz, vz = to_np(kz), to_np(vz)
    others = np.arange(S) != pos
    assert np.array_equal(kt.numpy()[:, :, others], kz[:, :, others])
    assert np.array_equal(vt.numpy()[:, :, others], vz[:, :, others])
    np.testing.assert_allclose(kt.numpy()[:, :, pos], kz[:, :, pos], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(vt.numpy()[:, :, pos], vz[:, :, pos])


def test_k2_trash_row_clamps_and_bf16_rounding():
    """pos == S writes the last slot and leaves the rest alone; with a bf16
    cache the new rows land rounded to bf16."""
    _, tp = _rope_pair("neox", D)
    kc = torch.from_numpy(RNG.standard_normal((B, HKV, S, D)).astype(np.float32)).bfloat16()
    vc = kc.clone()
    k0, v0 = kc.clone(), vc.clone()
    qkv3 = torch.from_numpy(RNG.standard_normal((B, HQ + 2 * HKV, D)).astype(np.float32))
    pos = torch.tensor([S], dtype=torch.int32)
    out = ta.attn_decode_qkv(qkv3, kc, vc, pos, tl.rope_table(pos, tp, D), scale=0.125)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert torch.equal(kc[:, :, :-1], k0[:, :, :-1]) and torch.equal(vc[:, :, :-1], v0[:, :, :-1])
    assert torch.equal(vc[0, :, -1], qkv3[0, HQ + HKV:].bfloat16())


@pytest.mark.parametrize("sinks", [False, True], ids=["nosink", "sinks"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("base", [0, 100])
def test_k6_plain_matches_pallas(base, window, softcap, sinks):
    import jax.numpy as jnp

    from zllm.ops.attention import flash_attention

    t, s, hq, hkv, d = 16, 128, 8, 2, 64
    rng = np.random.default_rng(base + window + int(softcap) + sinks)
    q = rng.standard_normal((1, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((1, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((1, hkv, s, d)).astype(np.float32)
    sk = rng.standard_normal(hq).astype(np.float32) if sinks else None
    positions = np.arange(base, base + t, dtype=np.int32)[None]
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions),
                           scale=0.125, softcap=softcap, window=window,
                           sinks=None if sk is None else jnp.asarray(sk), interpret=True)
    got = ta.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(positions), scale=0.125, softcap=softcap,
                             window=window, sinks=None if sk is None else torch.from_numpy(sk))
    assert tuple(got.shape) == (1, t, hq, d)
    assert nmse(to_np(got), to_np(want)) < 1e-6


def test_k6_bf16_cache_rounds_probabilities():
    """With bf16 K/V both sides cast the probabilities to bf16 before P.V;
    a 1-ulp f32 difference can flip one such rounding, hence 1e-5."""
    import jax.numpy as jnp

    from zllm.ops.attention import flash_attention

    q = RNG.standard_normal((1, 16, 8, 64)).astype(np.float32)
    kv = RNG.standard_normal((2, 1, 2, 128, 64)).astype(np.float32)
    kb = torch.from_numpy(kv).bfloat16()
    positions = np.arange(50, 66, dtype=np.int32)[None]
    want = flash_attention(jnp.asarray(q), jnp.asarray(to_np(kb[0])).astype(jnp.bfloat16),
                           jnp.asarray(to_np(kb[1])).astype(jnp.bfloat16),
                           jnp.asarray(positions), scale=0.125, interpret=True)
    got = ta.flash_attention(torch.from_numpy(q), kb[0], kb[1], torch.from_numpy(positions),
                             scale=0.125)
    assert nmse(to_np(got), to_np(want)) < 1e-5


def test_attention_ref_matches_zllm():
    import jax.numpy as jnp

    from zllm.ops.layers import attention_ref
    from zllm.runtime.kvcache import causal_mask

    q = RNG.standard_normal((1, 4, 4, 32)).astype(np.float32)
    k = RNG.standard_normal((1, 2, 16, 32)).astype(np.float32)
    pos = np.arange(5, 9, dtype=np.int32)[None]
    want = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                         causal_mask(jnp.asarray(pos), 16, 3), 0.2, logit_softcap=20.0)
    got = tl.attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                           tl.causal_mask(torch.from_numpy(pos), 16, 3), 0.2, logit_softcap=20.0)
    assert nmse(to_np(got), to_np(want)) < 1e-10
