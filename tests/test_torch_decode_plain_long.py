"""The plain versions that K9, K7's split form and K8 are held to on the
card, against zllm's Pallas kernels run in interpret mode, at spans longer
than the 8 blocks of a cluster: K9 (`paged_attn_decode_update_plain`) at
pages of 16 slots, rows spanning 20+ pages, K7
(`flash_attention_blockwise_plain`) at T = 1 over int8 codes with zllm's
`block_s` = 16, a row spanning 20+ blocks, and K8
(`attn_decode_update_plain`) at S = 2304, 18 of the kernel's 128-slot
chunks.  Inputs are made with numpy from a seed.

Tolerances are those of the short-span tests: K9 f32 pools atol = rtol =
1e-4 on att (tests/test_torch_paged_attention.py: another sum order, an
online softmax against one normalization), bf16 pools nmse <= 1e-8 (both
round exp(s - running max) a page at a time, so only f32 sum order and an
ulp of exp remain); K7 atol = rtol = 5e-5 (tests/test_torch_blockwise.py);
K8 those of tests/test_torch_attn_decode_update.py (f32 cache max |diff|
<= 1e-5, bf16 cache nmse <= 1e-5, the caches bit-equal).  K9's trash rows
(position >= horizon) are not compared: their output is never read; K8's
trash row (pos == S) writes slot S - 1 and attends all S, and is compared."""

import numpy as np
import pytest
import torch
from test_torch_oracle import to_np

HQ, HKV, D, PS, LP = 8, 2, 64, 16, 22
HZ = LP * PS  # the horizon: 352 slots
SCALE = 1.0 / D ** 0.5
BF16_NMSE = 1e-8

# K9 rows: one spanning all 22 pages, one across 11, position 0, a trash row
POS9 = [HZ - 1, 170, 0, HZ]


def _nmse(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((b ** 2).mean() + 1e-30))


def _pools(seed, dtype):
    """zllm-layout pools [Hkv, D, P*ps] in `dtype`, the port's [Hkv, P*ps, D]
    copies, and a scrambled table [4, LP+1] (physical != logical)."""
    import jax.numpy as jnp

    from zllm.runtime.paged import PagedKVCache as ZPaged

    r = np.random.default_rng(seed)
    z = ZPaged.create(1, len(POS9), HZ, HKV, D, dtype, page_size=PS)
    tbl = np.asarray(z.table).copy()
    tbl[:, :LP] = tbl[:, :LP][:, ::-1]
    kz = jnp.asarray(r.standard_normal(z.k[0].shape).astype(np.float32), dtype)
    vz = jnp.asarray(r.standard_normal(z.v[0].shape).astype(np.float32), dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16

    def port(x):
        return torch.from_numpy(np.asarray(x.astype(jnp.float32)).transpose(0, 2, 1).copy()
                                ).to(tdt).contiguous()

    return kz, vz, port(kz), port(vz), tbl, r


@pytest.mark.parametrize("pool", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["causal", "window", "softcap", "window_softcap"])
def test_k9_plain_matches_zllm_long(variant, pool):
    """Four rows over 22 pages of 16, the pools scrambled; the window (100
    slots) starts mid-page.  The pools after the insert equal zllm's
    outside the trash page 0."""
    import jax.numpy as jnp

    from zllm.ops.attention import paged_attn_decode_update as zpd
    from zllm_torch.ops import attention as ta

    kz, vz, kp, vp, tbl, r = _pools(23, jnp.float32 if pool == "f32" else jnp.bfloat16)
    window = 100 if "window" in variant else 0
    softcap = 30.0 if "softcap" in variant else 0.0
    positions = np.asarray([[p] for p in POS9], np.int32)
    b = len(POS9)
    q = r.standard_normal((b, 1, HQ, D)).astype(np.float32)
    kn = r.standard_normal((b, 1, HKV, D)).astype(np.float32)
    vn = r.standard_normal((b, 1, HKV, D)).astype(np.float32)
    att_z, kp_z, vp_z = zpd(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), kz, vz,
                            jnp.asarray(tbl), jnp.asarray(positions), page_size=PS, scale=SCALE,
                            softcap=softcap, window=window, interpret=True)
    before = ta.paged_attn_decode_update.launches
    att = ta.paged_attn_decode_update(torch.from_numpy(q), torch.from_numpy(kn),
                                      torch.from_numpy(vn), kp, vp, torch.from_numpy(tbl),
                                      torch.from_numpy(positions), page_size=PS, scale=SCALE,
                                      softcap=softcap, window=window)
    assert ta.paged_attn_decode_update.launches == before  # CPU tensors: the plain version
    assert att.shape == (b, 1, HQ, D) and bool(torch.isfinite(att).all())
    live = [i for i, p in enumerate(POS9) if p < HZ]
    got, want = to_np(att)[live], np.asarray(att_z)[live]
    if pool == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert _nmse(got, want) <= BF16_NMSE
    for mine, theirs in ((kp, kp_z), (vp, vp_z)):
        theirs = np.asarray(theirs.astype(jnp.float32)).transpose(0, 2, 1)
        np.testing.assert_array_equal(to_np(mine.float())[:, PS:], theirs[:, PS:])


# K7 at T = 1: S = 352 slots in zllm's blocks of 16; rows at 345 (22 blocks),
# 170 (mid-block) and 3
S7, BS7 = 352, 16
POS7 = [345, 170, 3]


@pytest.mark.parametrize("variant", ["causal", "sinks", "window_sinks", "softcap_sinks"])
def test_k7_plain_matches_zllm_long(variant):
    """int8 codes with f32 scales (the q8 cache), GQA 8/2 heads; the window
    (100 slots) starts mid-block."""
    import jax.numpy as jnp

    from zllm.ops.attention import flash_attention_blockwise
    from zllm_torch.ops import attention as ta

    rng = np.random.default_rng(71)
    b = len(POS7)
    q = rng.standard_normal((b, 1, HQ, D)).astype(np.float32)
    k = rng.integers(-127, 128, size=(b, HKV, S7, D)).astype(np.int8)
    v = rng.integers(-127, 128, size=(b, HKV, S7, D)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, size=(b, HKV, S7, 1)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, size=(b, HKV, S7, 1)).astype(np.float32)
    sk = rng.standard_normal(HQ).astype(np.float32) if "sinks" in variant else None
    positions = np.asarray([[p] for p in POS7], np.int32)
    kw = dict(scale=SCALE, softcap=30.0 if "softcap" in variant else 0.0,
              window=100 if "window" in variant else 0)

    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.from_numpy(x)

    want = flash_attention_blockwise(j(q), j(k), j(v), j(positions), sinks=j(sk), ks=j(ks),
                                     vs=j(vs), block_s=BS7, interpret=True, **kw)
    before = ta.flash_attention_blockwise.launches
    got = ta.flash_attention_blockwise(t(q), t(k), t(v), t(positions), sinks=t(sk), ks=t(ks),
                                       vs=t(vs), **kw)
    assert ta.flash_attention_blockwise.launches == before  # CPU tensors: the plain version
    assert tuple(got.shape) == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=5e-5, atol=5e-5)


# K8 at S = 2304 (18 chunks of 128): rows at 2200, 1100, 0 and the trash row
S8 = 2304
POS8 = [2200, 1100, 0, S8]


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["causal", "window_softcap"])
def test_k8_plain_matches_zllm_long(variant, cache):
    """GQA 8/2 heads of 64, f32 q; the window (700 slots) starts mid-chunk
    for every row but position 0."""
    import jax.numpy as jnp

    from zllm.ops.attention import attn_decode_update as zllm_k8
    from zllm_torch.ops import attention as ta

    rng = np.random.default_rng(83)
    b = len(POS8)
    q = rng.standard_normal((b, 1, HQ, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, 1, HKV, D)).astype(np.float32) for _ in range(2))
    kc, vc = (rng.standard_normal((b, HKV, S8, D)).astype(np.float32) for _ in range(2))
    positions = np.asarray([[p] for p in POS8], np.int32)
    kw = dict(scale=SCALE, softcap=30.0 if "softcap" in variant else 0.0,
              window=700 if "window" in variant else 0)
    jc, tc = getattr(jnp, cache), getattr(torch, cache)
    want, zk, zv = zllm_k8(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc, jc),
                           jnp.asarray(vc, jc), jnp.asarray(positions), interpret=True, **kw)
    tk, tv = torch.from_numpy(kc).to(tc), torch.from_numpy(vc).to(tc)
    before = ta.attn_decode_update.launches
    got = ta.attn_decode_update(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
                                tk, tv, torch.from_numpy(positions), **kw)
    assert ta.attn_decode_update.launches == before  # CPU tensors: the plain version
    assert tuple(got.shape) == q.shape and got.dtype == torch.float32
    if cache == "float32":
        assert np.abs(to_np(got) - np.asarray(want)).max() <= 1e-5
    else:
        assert _nmse(to_np(got), np.asarray(want)) <= 1e-5
    for mine, theirs in ((tk, zk), (tv, zv)):
        np.testing.assert_array_equal(to_np(mine.float()), np.asarray(theirs.astype(jnp.float32)))
