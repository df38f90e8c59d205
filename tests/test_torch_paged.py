"""zllm_torch's paged KV cache against zllm's (runtime/paged.py).

The same numpy pools and table go into both (zllm's pools token-minor
[Hkv, D, P*ps], the port's token-major [Hkv, P*ps, D], carried across by
`PagedKVCache.from_jax`); every operation then gives equal pools, exactly:
they only move f32 values.  The context shift re-rotates K through rope,
computed in f32 on both sides, held to 1e-6.  The allocator is zllm's
host-side code, copied: a scripted assign/share/release/unshare sequence
gives the same tables, refcounts and free lists."""

import numpy as np
import pytest
import torch
from test_torch_oracle import to_np

L, B, HKV, D, PS, MAXLEN = 2, 3, 2, 64, 128, 512


def _pair(seed):
    """zllm's PagedKVCache with random pools and a scrambled table, and the
    port's from the same numpy arrays."""
    import jax.numpy as jnp

    from zllm.runtime.paged import PagedKVCache as ZPaged
    from zllm_torch.runtime.paged import PagedKVCache

    r = np.random.default_rng(seed)
    z = ZPaged.create(L, B, MAXLEN, HKV, D, jnp.float32, page_size=PS)
    tbl = np.asarray(z.table).copy()
    tbl[:, :-1] = tbl[:, :-1][:, ::-1]  # physical != logical
    ks = [r.standard_normal(z.k[0].shape).astype(np.float32) for _ in range(L)]
    vs = [r.standard_normal(z.v[0].shape).astype(np.float32) for _ in range(L)]
    z = ZPaged(k=tuple(jnp.asarray(x) for x in ks), v=tuple(jnp.asarray(x) for x in vs),
               table=jnp.asarray(tbl), page_size=PS, horizon=MAXLEN)
    t = PagedKVCache.from_jax(ks, vs, tbl, PS, MAXLEN, device="cpu")
    return z, t, r


def _same_pools(z, t):
    for il in range(L):
        np.testing.assert_array_equal(to_np(t.k[il]), np.asarray(z.k[il]).transpose(0, 2, 1))
        np.testing.assert_array_equal(to_np(t.v[il]), np.asarray(z.v[il]).transpose(0, 2, 1))


def test_from_jax_and_gather():
    z, t, _ = _pair(0)
    _same_pools(z, t)
    for il in range(L):
        zk, zv = z.layer(il)[0].gather()
        tk, tv = t.layer(il).gather()
        np.testing.assert_array_equal(to_np(tk), np.asarray(zk))
        np.testing.assert_array_equal(to_np(tv), np.asarray(zv))
    assert t.layer(0).shape == z.layer(0)[0].shape


@pytest.mark.parametrize("case", ["chunk", "decode", "trash", "mixed"])
def test_update_matches_zllm(case):
    import jax.numpy as jnp

    z, t, r = _pair(1)
    tl = {"chunk": 16, "decode": 1, "trash": 4, "mixed": 8}[case]
    pos = np.stack([np.arange(p, p + tl) for p in (0, 250, 127)]).astype(np.int32)
    if case == "trash":
        pos[:] = MAXLEN  # the engine's inactive rows
    if case == "mixed":
        pos[1, 1:] = MAXLEN  # a generating row rides in column 0
    k_new = r.standard_normal((B, tl, HKV, D)).astype(np.float32)
    v_new = r.standard_normal((B, tl, HKV, D)).astype(np.float32)
    for il in range(L):
        z = z.update(il, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos))
        out = t.update(il, torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(pos))
        assert out is t
    if case in ("trash", "mixed"):
        # several trash tokens land on one row of page 0; which one wins is
        # unspecified on both sides, and no live slot ever reads page 0
        for il in range(L):
            np.testing.assert_array_equal(to_np(t.k[il])[:, PS:],
                                          np.asarray(z.k[il]).transpose(0, 2, 1)[:, PS:])
            np.testing.assert_array_equal(to_np(t.v[il])[:, PS:],
                                          np.asarray(z.v[il]).transpose(0, 2, 1)[:, PS:])
    else:
        _same_pools(z, t)


def test_copy_pages_and_table_upload():
    from zllm.runtime.paged import PageAllocator as ZAlloc
    from zllm_torch.runtime.paged import PageAllocator

    z, t, _ = _pair(2)
    za, ta = ZAlloc(B, MAXLEN, PS), PageAllocator(B, MAXLEN, PS)
    for a in (za, ta):
        a.assign_slot(0, None, 0)
        a.assign_slot(1, 0, 2)
    copies = ta.unshare_slot(1)
    assert copies == za.unshare_slot(1) and len(copies) == 2
    z = z.copy_pages(copies).with_table(za.table)
    t2 = t.copy_pages(copies).with_table(ta.table)
    _same_pools(z, t2)
    np.testing.assert_array_equal(t2.table.numpy(), np.asarray(z.table))
    # the device table is a copy: later host edits do not reach it
    before = t2.table.clone()
    ta.release_slot(1)
    assert torch.equal(t2.table, before)
    assert t2.k is t.k  # same pools under the new table


def test_gather_scatter_row_matches_zllm():
    import jax.numpy as jnp

    z, t, r = _pair(3)
    length = PS + 32
    k_row = r.standard_normal((HKV, length, D)).astype(np.float32)
    v_row = r.standard_normal((HKV, length, D)).astype(np.float32)
    z = z.scatter_row(1, 2, jnp.asarray(k_row), jnp.asarray(v_row))
    t.scatter_row(1, 2, torch.from_numpy(k_row), torch.from_numpy(v_row))
    _same_pools(z, t)
    for row in range(B):
        zk, zv = z.gather_row(1, row, length)
        tk, tv = t.gather_row(1, row, length)
        np.testing.assert_array_equal(to_np(tk), np.asarray(zk))
        np.testing.assert_array_equal(to_np(tv), np.asarray(zv))


def test_allocator_script_matches_zllm():
    """assign, share, release, unshare, exhaust: same tables, refcounts,
    free lists and ownership at every step."""
    from zllm.runtime.paged import PageAllocator as ZAlloc
    from zllm_torch.runtime.paged import PageAllocator

    za, ta = ZAlloc(3, 256, 128), PageAllocator(3, 256, 128)

    def same():
        np.testing.assert_array_equal(ta.table, za.table)
        np.testing.assert_array_equal(ta.refs, za.refs)
        assert ta.free == za.free and ta.owned == za.owned
        for s in range(3):
            assert ta.exclusively_owned(s) == za.exclusively_owned(s)

    script = [("assign", 0, None, 0), ("assign", 1, 0, 1), ("assign", 2, 0, 2),
              ("unshare", 1), ("release", 0), ("assign", 0, 2, 1), ("unshare", 2),
              ("release", 1), ("assign", 1, None, 0)]
    for op, *args in script:
        for a in (za, ta):
            if op == "assign":
                a.assign_slot(*args)
            elif op == "release":
                a.release_slot(*args)
        if op == "unshare":
            assert ta.unshare_slot(*args) == za.unshare_slot(*args)
        same()
    assert ta.shareable_pages(300) == za.shareable_pages(300) == 2
    # exhausting the free list raises IndexError on both
    for a in (za, ta):
        a.assign_slot(2, 0, 2)
        a.free.clear()
        with pytest.raises(IndexError):
            a.unshare_slot(2)


@pytest.mark.parametrize("n_keep", [0, 5])
def test_shift_context_row_paged_matches_zllm(n_keep):
    from zllm.ops.layers import RopeParams as ZRope
    from zllm.runtime.kvcache import shift_context_row as zshift
    from zllm_torch.ops.layers import RopeParams
    from zllm_torch.runtime.paged import shift_context_row_paged

    z, t, _ = _pair(4)
    n_discard = (MAXLEN - n_keep) // 2
    z = zshift(z, ZRope(dim=D, style="neox"), 1, n_keep, n_discard, horizon=MAXLEN)
    t = shift_context_row_paged(t, RopeParams(dim=D, style="neox"), 1, n_keep, n_discard)
    for il in range(L):
        np.testing.assert_allclose(to_np(t.k[il]), np.asarray(z.k[il]).transpose(0, 2, 1),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(to_np(t.v[il]), np.asarray(z.v[il]).transpose(0, 2, 1))


def test_shift_context_row_paged_leaves_other_rows():
    """The shift rewrites only the pages of its own row: every pool row
    mapped by another slot, and page 0 (the trash page), keeps its bits."""
    from zllm_torch.ops.layers import RopeParams
    from zllm_torch.runtime.paged import shift_context_row_paged

    _, t, _ = _pair(5)
    before = [(k.clone(), v.clone()) for k, v in zip(t.k, t.v)]
    own = t.table[1, :MAXLEN // PS].tolist()
    t = shift_context_row_paged(t, RopeParams(dim=D, style="neox"), 1, 0, MAXLEN // 2)
    keep = torch.ones(t.k[0].shape[1], dtype=torch.bool)
    for pid in own:
        keep[pid * PS:(pid + 1) * PS] = False
    for il, (k0, v0) in enumerate(before):
        assert torch.equal(t.k[il][:, keep], k0[:, keep])
        assert torch.equal(t.v[il][:, keep], v0[:, keep])
        assert not torch.equal(t.k[il], k0)
