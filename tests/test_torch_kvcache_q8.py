"""The port's contiguous caches (`KVCache`, `KVCacheQ8`) and
`shift_context_row` against zllm's (runtime/kvcache.py), and `forward`
over a q8 cache against zllm's `forward`.

The same numpy caches go into both packages (`from_jax`).  Quantizing is
bit-exact (f32 max, division and round-half-to-even on both sides), and
the per-row inserts only move values, so codes, scales and f32 rows are
compared exactly.  The context shift re-rotates K through rope, computed in
f32 on both sides and held to 1e-6 as the paged shift is; in the q8 cache
the rotated K is requantized, so a value that lands within an ulp of a
rounding edge may take the next code: codes are held to within one code,
on at most 0.1 % of the moved values, and scales to 1e-6.  V codes and
scales, and the region past the horizon, are compared exactly."""

import numpy as np
import pytest
import torch
from test_torch_oracle import SMALL_LLAMA, nmse, to_np

from zllm.gguf.constants import GGMLType

L, B, HKV, D, S, T = 2, 3, 2, 64, 80, 16


def _caches(kind, seed):
    """zllm's cache with random contents and the port's from the same
    numpy arrays."""
    import jax.numpy as jnp

    from zllm.runtime.kvcache import KVCache as ZKV
    from zllm.runtime.kvcache import KVCacheQ8 as ZQ8
    from zllm_torch.runtime.kvcache import KVCache, KVCacheQ8

    r = np.random.default_rng(seed)
    shape, sshape = (B, HKV, S, D), (B, HKV, S, 1)
    if kind == "q8":
        arrs = [[r.integers(-127, 128, size=shape).astype(np.int8) for _ in range(L)]
                for _ in range(2)]
        arrs += [[r.uniform(0.01, 0.1, size=sshape).astype(np.float32) for _ in range(L)]
                 for _ in range(2)]
        z = ZQ8(*(tuple(jnp.asarray(x) for x in a) for a in arrs))
        return z, KVCacheQ8.from_jax(*arrs, device="cpu"), r
    arrs = [[r.standard_normal(shape).astype(np.float32) for _ in range(L)] for _ in range(2)]
    z = ZKV(*(tuple(jnp.asarray(x) for x in a) for a in arrs))
    return z, KVCache.from_jax(*arrs, device="cpu"), r


def _fields(kind):
    return ("k", "v", "ks", "vs") if kind == "q8" else ("k", "v")


def test_quant_is_bit_exact_with_zllm():
    import jax.numpy as jnp

    from zllm.runtime.kvcache import KVCacheQ8 as ZQ8
    from zllm_torch.runtime.kvcache import KVCacheQ8

    r = np.random.default_rng(0)
    x = (r.standard_normal((2, 3, 40, 64)) * r.uniform(0.01, 10, (2, 3, 40, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector takes the 1e-12 floor
    # values on the .5 rounding edge of their code: the max is 127, so the
    # scale is exactly 1 and x / s keeps the halves
    x[0, 0, 1] = np.arange(64) - 31.5
    x[0, 0, 1, 0] = 127.0
    zq, zs = ZQ8._quant(jnp.asarray(x))
    tq, ts = KVCacheQ8._quant(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (2, 3, 40, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(zq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(zs))


@pytest.mark.parametrize("t", [1, T], ids=["t1", "chunk"])
@pytest.mark.parametrize("kind", ["f32", "q8"])
def test_update_matches_zllm(kind, t):
    """Three rows at different starts, the last clamped to end at S - 1
    (the trash-row convention), written in place; then the caches are
    equal, exactly."""
    import jax.numpy as jnp

    z, p, r = _caches(kind, 1)
    starts = [0, 21, S - 2]  # the last run clamps to S - t
    pos = np.stack([np.arange(s0, s0 + t) for s0 in starts]).astype(np.int32)
    pos[1, 1:] = S  # a generating row with trash columns after its token
    k_new = r.standard_normal((B, t, HKV, D)).astype(np.float32)
    v_new = r.standard_normal((B, t, HKV, D)).astype(np.float32)
    for il in range(L):
        z = z.update(il, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos))
        p.update(il, torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(pos))
    for name in _fields(kind):
        for il in range(L):
            np.testing.assert_array_equal(getattr(p, name)[il].numpy(),
                                          np.asarray(getattr(z, name)[il]))


def test_create_and_layer():
    from zllm.runtime.kvcache import KVCacheQ8 as ZQ8
    from zllm_torch.ops.attention import QuantKV
    from zllm_torch.runtime.kvcache import KVCacheQ8

    z = ZQ8.create(L, B, S, HKV, D)
    p = KVCacheQ8.create(L, B, S, HKV, D, device="cpu")
    for name in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(getattr(p, name)[1].numpy(), np.asarray(getattr(z, name)[1]))
    kq, vq = p.layer(1)
    assert isinstance(kq, QuantKV) and kq.q is p.k[1] and vq.s is p.vs[1]
    assert kq.shape == (B, HKV, S, D) and p.max_len == S


@pytest.mark.parametrize("n_keep", [0, 5])
@pytest.mark.parametrize("kind", ["f32", "q8"])
def test_shift_context_row_matches_zllm(kind, n_keep):
    """Row 1 shifts inside a horizon of 64 of S = 80: [64, 80) is the
    engine's trash region and stays as it is, as do the other rows."""
    from zllm.ops.layers import RopeParams as ZRope
    from zllm.runtime.kvcache import shift_context_row as zshift
    from zllm_torch.ops.layers import RopeParams
    from zllm_torch.runtime.kvcache import shift_context_row

    z, p, _ = _caches(kind, 2)
    hz = 64
    before = {name: [x.clone() for x in getattr(p, name)] for name in _fields(kind)}
    n_discard = (hz - n_keep) // 2
    z = zshift(z, ZRope(dim=D, style="neox"), 1, n_keep, n_discard, horizon=hz)
    assert shift_context_row(p, RopeParams(dim=D, style="neox"), 1, n_keep, n_discard,
                             horizon=hz) is p
    for il in range(L):
        for name in _fields(kind):
            got, want = getattr(p, name)[il].numpy(), np.asarray(getattr(z, name)[il])
            old = before[name][il].numpy()
            np.testing.assert_array_equal(got[:, :, hz:], old[:, :, hz:])  # trash region
            np.testing.assert_array_equal(got[[0, 2]], old[[0, 2]])  # other rows
            if name == "k" and kind == "q8":
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), diff.mean())
            elif name == "k" or name == "ks":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def f32_gguf(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    path = str(tmp_path_factory.mktemp("q8") / "f32.gguf")
    return make_llama_gguf(path, **dict(SMALL_LLAMA, gtype=GGMLType.F32), with_tokenizer=True)


def test_forward_q8_matches_zllm(f32_gguf):
    """One 16-token prefill chunk and 8 decode steps of two rows at their
    own positions (the second row starts at 5), through a q8 cache of 48 +
    16 slots, the same tokens fed to both.  F32 weights keep the matmuls
    f32 on both sides, so the logits differ only where zllm dequantizes
    K/V before its reference attention and the port applies the scales to
    the scores and probabilities (K7's plain version): f32 reassociation,
    held to nmse < 1e-8 (measured up to 3e-10), with the same greedy
    tokens.  Layer 0's K codes are equal; layer 1's within one code."""
    import jax.numpy as jnp

    from zllm.models.llama import forward as zforward
    from zllm.models.loader import Model as ZModel
    from zllm.runtime.kvcache import KVCacheQ8 as ZQ8
    from zllm_torch.models.llama import forward
    from zllm_torch.models.loader import Model
    from zllm_torch.ops import attention
    from zllm_torch.runtime.kvcache import KVCacheQ8

    zm = ZModel.load(f32_gguf, dtype=jnp.float32)
    tm = Model.load(f32_gguf, device="cpu", dtype=torch.float32)
    cfg = tm.cfg
    zkv = ZQ8.create(cfg.n_layers, 2, 64, cfg.n_kv_heads, cfg.head_dim)
    tkv = KVCacheQ8.create(cfg.n_layers, 2, 64, cfg.n_kv_heads, cfg.head_dim, device="cpu")
    r = np.random.default_rng(3)
    toks = r.integers(3, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    starts = np.array([[0], [5]], np.int32)
    before = attention.flash_attention_blockwise.launches
    for step in range(9):
        n = 16 if step == 0 else 1
        base = starts[:, 0] + (0 if step == 0 else 15 + step)
        pos = (base[:, None] + np.arange(n)[None]).astype(np.int32)
        zl, zkv = zforward(zm.params, zm.cfg, jnp.asarray(toks), jnp.asarray(pos), zkv)
        tl = forward(tm.params, cfg, torch.from_numpy(toks), torch.from_numpy(pos), tkv)
        assert tl.shape == (2, n, cfg.vocab_size)
        err = nmse(to_np(tl), to_np(zl))
        assert err < 1e-8, f"step {step}: nmse {err}"
        nxt = np.asarray(to_np(zl)[:, -1].argmax(-1), np.int32)
        assert (to_np(tl)[:, -1].argmax(-1) == nxt).all()
        toks = nxt[:, None]
    assert attention.flash_attention_blockwise.launches == before
    # layer 1's K comes from f32 activations that differ in their last
    # bits, so a value on a rounding edge may take the next code
    diff = np.abs(tkv.k[1].numpy().astype(np.int32) - np.asarray(zkv.k[1]).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(tkv.k[0].numpy(), np.asarray(zkv.k[0]))
