"""K10 (paged_attention) and K9 (paged_attn_decode_update): the port's plain
versions against zllm's Pallas kernels run in interpret mode on the same
numpy pools, scrambled tables (physical != logical) and positions.

Tolerance, f32 throughout: atol = rtol = 1e-4 on att (the sums run in
another order, and zllm's kernels take an online softmax where the plain
versions normalize once), except trash rows (position >= horizon: their
output is never read).  K9's pools are exact on every page but the trash
page 0: both sides write only the live rows' new K/V, cast to f32."""

import numpy as np
import pytest
import torch
from test_torch_oracle import to_np

HQ, HKV, D, PS, LP = 8, 2, 64, 128, 4
HZ = LP * PS
SCALE = 1.0 / D ** 0.5


def _pools(b, seed):
    """zllm-layout pools [Hkv, D, P*ps] and a scrambled table [b, LP+1]."""
    from zllm.runtime.paged import PagedKVCache as ZPaged
    import jax.numpy as jnp

    r = np.random.default_rng(seed)
    z = ZPaged.create(1, b, HZ, HKV, D, jnp.float32, page_size=PS)
    tbl = np.asarray(z.table).copy()
    tbl[:, :LP] = tbl[:, :LP][:, ::-1]
    kp = r.standard_normal(z.k[0].shape).astype(np.float32)
    vp = r.standard_normal(z.v[0].shape).astype(np.float32)
    return kp, vp, tbl, r


def _port(x):
    """A zllm pool as the port's [Hkv, P*ps, D] tensor."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("variant", ["causal", "window", "softcap"])
def test_paged_attention_plain_matches_zllm(t, variant):
    import jax.numpy as jnp

    from zllm.ops.attention import paged_attention as zpa
    from zllm_torch.ops import attention as ta

    kp, vp, tbl, r = _pools(3, 11)
    window = 96 if variant == "window" else 0
    softcap = 30.0 if variant == "softcap" else 0.0
    starts = [300, 0, HZ]  # row 2: the engine's trash row
    pos = np.stack([np.arange(p, p + t) for p in starts]).astype(np.int32)
    pos[1, :] = np.arange(t) + (120 if t > 1 else 0)  # a chunk across a page edge
    q = r.standard_normal((3, t, HQ, D)).astype(np.float32)
    want = zpa(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
               jnp.asarray(pos), page_size=PS, scale=SCALE, softcap=softcap, window=window,
               interpret=True)
    before = ta.paged_attention.launches
    got = ta.paged_attention(torch.from_numpy(q), _port(kp), _port(vp), torch.from_numpy(tbl),
                             torch.from_numpy(pos), page_size=PS, scale=SCALE, softcap=softcap,
                             window=window)
    assert ta.paged_attention.launches == before  # CPU tensors: the plain version
    assert got.shape == (3, t, HQ, D) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got)[:2], np.asarray(want)[:2], rtol=1e-4, atol=1e-4)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("case", ["mid", "page_edge", "start", "b2", "window", "trash"])
def test_paged_decode_plain_matches_zllm(case):
    """The cases of tests/test_attention.py's fused paged decode test."""
    import jax.numpy as jnp

    from zllm.ops.attention import paged_attn_decode_update as zpd
    from zllm_torch.ops import attention as ta

    b = 2 if case == "b2" else 1
    window = 96 if case == "window" else 0
    pos_vals = {"mid": [300], "page_edge": [255], "start": [0], "b2": [37, 450],
                "window": [400], "trash": [HZ]}[case]
    positions = np.asarray([[p] for p in pos_vals], np.int32)
    kp, vp, tbl, r = _pools(b, 5)
    q = r.standard_normal((b, 1, HQ, D)).astype(np.float32)
    kn = r.standard_normal((b, 1, HKV, D)).astype(np.float32)
    vn = r.standard_normal((b, 1, HKV, D)).astype(np.float32)

    att_z, kp_z, vp_z = zpd(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
                            jnp.asarray(vp), jnp.asarray(tbl), jnp.asarray(positions),
                            page_size=PS, scale=SCALE, window=window, interpret=True)
    k_t, v_t = _port(kp), _port(vp)
    before = ta.paged_attn_decode_update.launches
    att = ta.paged_attn_decode_update(torch.from_numpy(q), torch.from_numpy(kn),
                                      torch.from_numpy(vn), k_t, v_t, torch.from_numpy(tbl),
                                      torch.from_numpy(positions), page_size=PS, scale=SCALE,
                                      window=window)
    assert ta.paged_attn_decode_update.launches == before
    assert att.shape == (b, 1, HQ, D)
    if case != "trash":
        np.testing.assert_allclose(to_np(att), np.asarray(att_z), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(to_np(k_t)[:, PS:], np.asarray(kp_z).transpose(0, 2, 1)[:, PS:])
    np.testing.assert_array_equal(to_np(v_t)[:, PS:], np.asarray(vp_z).transpose(0, 2, 1)[:, PS:])
    if case == "trash":  # a trash row writes nowhere, page 0 included
        np.testing.assert_array_equal(to_np(k_t), kp.transpose(0, 2, 1))


# bf16 pools: the rounding of exp(s - running max) to bf16 before P.V is
# where a plain version that normalizes first parts from zllm (nmse ~3e-6);
# rounded where zllm rounds, only f32 sum order and an ulp of exp remain
BF16_NMSE = 1e-8


def _nmse(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((b ** 2).mean() + 1e-30))


def _pools_bf16(b, seed, ps):
    """bf16 pools of 512 slots a row (zllm layout, and the port's) and a
    scrambled table."""
    import jax.numpy as jnp

    from zllm.runtime.paged import PagedKVCache as ZPaged

    r = np.random.default_rng(seed)
    z = ZPaged.create(1, b, HZ, HKV, D, jnp.bfloat16, page_size=ps)
    tbl = np.asarray(z.table).copy()
    lp = HZ // ps
    tbl[:, :lp] = tbl[:, :lp][:, ::-1]
    kz = jnp.asarray(r.standard_normal(z.k[0].shape).astype(np.float32), jnp.bfloat16)
    vz = jnp.asarray(r.standard_normal(z.v[0].shape).astype(np.float32), jnp.bfloat16)

    def port(x):
        return torch.from_numpy(np.asarray(x.astype(jnp.float32)).transpose(0, 2, 1).copy()
                                ).to(torch.bfloat16).contiguous()

    return kz, vz, port(kz), port(vz), tbl, r


@pytest.mark.parametrize("ps", [64, 128])
@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("variant", ["causal", "window", "softcap"])
def test_paged_attention_plain_matches_zllm_bf16(t, variant, ps):
    """bf16 pools, f32 q (the serve path's dtypes): rows from 300 (mid-page),
    from 120 (a chunk across a page edge at T 16) and the trash row."""
    import jax.numpy as jnp

    from zllm.ops.attention import paged_attention as zpa
    from zllm_torch.ops import attention as ta

    kz, vz, kp, vp, tbl, r = _pools_bf16(3, 13 + ps, ps)
    window = 96 if variant == "window" else 0
    softcap = 30.0 if variant == "softcap" else 0.0
    starts = [300, 120 if t > 1 else 0, HZ]
    pos = np.stack([np.arange(p, p + t) for p in starts]).astype(np.int32)
    q = r.standard_normal((3, t, HQ, D)).astype(np.float32)
    want = zpa(jnp.asarray(q), kz, vz, jnp.asarray(tbl), jnp.asarray(pos), page_size=ps,
               scale=SCALE, softcap=softcap, window=window, interpret=True)
    got = ta.paged_attention(torch.from_numpy(q), kp, vp, torch.from_numpy(tbl),
                             torch.from_numpy(pos), page_size=ps, scale=SCALE, softcap=softcap,
                             window=window)
    assert got.shape == (3, t, HQ, D) and got.dtype == torch.float32
    assert _nmse(to_np(got)[:2], np.asarray(want)[:2]) <= BF16_NMSE


@pytest.mark.parametrize("ps", [64, 128])
@pytest.mark.parametrize("case", ["mid", "page_edge", "b2", "window", "softcap"])
def test_paged_decode_plain_matches_zllm_bf16(case, ps):
    """bf16 pools, f32 q/k/v rows; the pools after the insert equal zllm's
    outside the trash page."""
    import jax.numpy as jnp

    from zllm.ops.attention import paged_attn_decode_update as zpd
    from zllm_torch.ops import attention as ta

    b = 2 if case == "b2" else 1
    window = 96 if case == "window" else 0
    softcap = 30.0 if case == "softcap" else 0.0
    pos_vals = {"page_edge": [255], "b2": [37, 450], "window": [400]}.get(case, [300])
    positions = np.asarray([[p] for p in pos_vals], np.int32)
    kz, vz, kp, vp, tbl, r = _pools_bf16(b, 7 + ps, ps)
    q = r.standard_normal((b, 1, HQ, D)).astype(np.float32)
    kn = r.standard_normal((b, 1, HKV, D)).astype(np.float32)
    vn = r.standard_normal((b, 1, HKV, D)).astype(np.float32)
    att_z, kp_z, _ = zpd(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), kz, vz,
                         jnp.asarray(tbl), jnp.asarray(positions), page_size=ps, scale=SCALE,
                         softcap=softcap, window=window, interpret=True)
    att = ta.paged_attn_decode_update(torch.from_numpy(q), torch.from_numpy(kn),
                                      torch.from_numpy(vn), kp, vp, torch.from_numpy(tbl),
                                      torch.from_numpy(positions), page_size=ps, scale=SCALE,
                                      softcap=softcap, window=window)
    assert att.shape == (b, 1, HQ, D)
    assert _nmse(to_np(att), np.asarray(att_z)) <= BF16_NMSE
    np.testing.assert_array_equal(to_np(kp.float())[:, ps:],
                                  np.asarray(kp_z.astype(jnp.float32)).transpose(0, 2, 1)[:, ps:])


def test_paged_wrappers_check_shapes():
    from zllm_torch.ops import attention as ta

    kp = torch.zeros(HKV, 5 * PS, D)
    tbl = torch.zeros(1, LP + 1, dtype=torch.int32)
    pos = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="bad shapes"):
        ta.paged_attention(torch.zeros(1, 1, HQ, D + 1), kp, kp, tbl, pos, page_size=PS,
                           scale=SCALE)
    with pytest.raises(ValueError, match="bad shapes"):
        ta.paged_attn_decode_update(torch.zeros(1, 1, HQ, D), torch.zeros(1, 1, HKV + 1, D),
                                    torch.zeros(1, 1, HKV + 1, D), kp, kp, tbl, pos,
                                    page_size=PS, scale=SCALE)
