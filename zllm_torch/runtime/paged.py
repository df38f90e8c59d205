"""Paged KV cache with per-slot page tables (counterpart of
`zllm/runtime/paged.py`).

  * one physical page pool per layer, shared by every slot, in bf16, f16
    or f32 (K9 and K10 take each on the card).  The pool is
    token-major, [Hkv, P * page_size, D]: a token's D values are contiguous
    for 16-byte loads on the card (zllm keeps the token-minor
    [Hkv, D, P * ps] its TPU wants; `PagedKVCache.from_jax` transposes);
  * a per-slot page table [n_slots, LP + 1] int32 maps logical page ->
    physical page; the last column is pinned to the reserved trash page 0,
    which absorbs the engine's inactive-row writes (positions >= horizon);
  * a token at position s of slot b lives at row
    table[b, s // ps] * ps + s % ps of every head's pool;
  * prefix sharing: full pages of one slot's prompt can be mapped read-only
    into another slot's table.

The pools are updated in place (the T=1 kernel writes its row itself).
The table lives on the pools' device and is uploaded from the host
allocator only when the allocator changes it (`with_table`).  Allocation
policy is `PageAllocator`, host-side numpy, as in zllm.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PagedKV:
    """One layer's attention view: the page pools and the step's table."""

    k: torch.Tensor  # [Hkv, P * ps, D]
    v: torch.Tensor
    table: torch.Tensor  # int32 [B, LP + 1]
    page_size: int

    @property
    def shape(self):
        """Advertised as [B, Hkv, S, D] like a dense cache view."""
        b = self.table.shape[0]
        s = (self.table.shape[1] - 1) * self.page_size
        return (b, self.k.shape[0], s, self.k.shape[2])

    def rows(self) -> torch.Tensor:
        """int64 [B, S]: each (slot, logical position)'s pool row."""
        b, _, s, _ = self.shape
        ps = self.page_size
        off = torch.arange(s, device=self.table.device)
        return self.table[:, :s // ps].long()[:, off // ps] * ps + (off % ps)[None, :]

    def gather(self, dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Contiguous [B, Hkv, S, D] K/V (the kernels' plain versions)."""
        b, h, s, d = self.shape
        idx = self.rows().reshape(-1)
        k = self.k[:, idx].reshape(h, b, s, d).transpose(0, 1)
        v = self.v[:, idx].reshape(h, b, s, d).transpose(0, 1)
        if dtype is not None:
            k, v = k.to(dtype), v.to(dtype)
        return k, v


@dataclass
class PagedKVCache:
    k: list  # L x [Hkv, P * ps, D]
    v: list
    table: torch.Tensor  # int32 [n_slots, LP + 1]; last column = trash page 0
    page_size: int
    horizon: int  # attendable positions per slot (LP * ps)

    @classmethod
    def create(cls, n_layers: int, n_slots: int, max_len: int, n_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, page_size: int = 128,
               device="cuda") -> "PagedKVCache":
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} is not a multiple of page_size {page_size}")
        lp = max_len // page_size
        p = n_slots * lp + 1  # +1 trash
        shape = (n_kv_heads, p * page_size, head_dim)
        # identity-ish initial table: slot b owns pages [1 + b*lp, 1 + (b+1)*lp)
        tbl = np.zeros((n_slots, lp + 1), np.int32)
        for b in range(n_slots):
            tbl[b, :lp] = 1 + b * lp + np.arange(lp)
        return cls(k=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layers)],
                   v=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layers)],
                   table=torch.tensor(tbl, device=device), page_size=page_size,
                   horizon=max_len)

    @classmethod
    def from_jax(cls, k_pools, v_pools, table, page_size: int, horizon: int,
                 device="cuda") -> "PagedKVCache":
        """zllm's token-minor pools [Hkv, D, P * ps] (numpy, one per layer)
        and table -> this layout, value for value."""
        def pool(x):
            return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1))).to(device)

        return cls(k=[pool(x) for x in k_pools], v=[pool(x) for x in v_pools],
                   table=torch.tensor(np.array(table, dtype=np.int32), device=device),
                   page_size=page_size, horizon=horizon)

    @property
    def n_layers(self) -> int:
        return len(self.k)

    def with_table(self, table) -> "PagedKVCache":
        """The same pools under another table.  A numpy table (the
        allocator's, mutated later on the host) is copied to the device."""
        if isinstance(table, torch.Tensor):
            t = table.to(device=self.table.device, dtype=torch.int32)
        else:
            t = torch.tensor(np.array(table, dtype=np.int32), device=self.table.device)
        return PagedKVCache(self.k, self.v, t, self.page_size, self.horizon)

    def _rows(self, positions: torch.Tensor) -> torch.Tensor:
        """int64 pool rows of positions [B, T]; positions >= horizon route
        to the trash page through the pinned last table column."""
        ps = self.page_size
        lp = torch.clamp(positions.long() // ps, max=self.table.shape[1] - 1)
        phys = torch.gather(self.table.long(), 1, lp)
        return phys * ps + positions.long() % ps

    def update(self, il: int, k_new: torch.Tensor, v_new: torch.Tensor,
               positions: torch.Tensor) -> "PagedKVCache":
        """Write k/v [B, T, H, D] of layer il at per-token positions [B, T]
        (any values), in place: one scatter of B*T token rows per pool."""
        idx = self._rows(positions).reshape(-1)
        b, t, h, d = k_new.shape
        self.k[il][:, idx] = k_new.permute(2, 0, 1, 3).reshape(h, b * t, d).to(self.k[il].dtype)
        self.v[il][:, idx] = v_new.permute(2, 0, 1, 3).reshape(h, b * t, d).to(self.v[il].dtype)
        return self

    def copy_pages(self, copies: list[tuple[int, int]]) -> "PagedKVCache":
        """Copy page contents src -> dst in every layer's pools, in place
        (the device half of PageAllocator.unshare_slot)."""
        if not copies:
            return self
        ps = self.page_size
        src = np.concatenate([np.arange(o * ps, (o + 1) * ps) for o, _ in copies])
        dst = np.concatenate([np.arange(n * ps, (n + 1) * ps) for _, n in copies])
        dev = self.table.device
        src, dst = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
        for p in (*self.k, *self.v):
            p[:, dst] = p[:, src]
        return self

    def layer(self, il: int) -> PagedKV:
        """Layer il's attention view (both pools and the table)."""
        return PagedKV(self.k[il], self.v[il], self.table, self.page_size)

    def _row_idx(self, row: int, length: int) -> torch.Tensor:
        ps = self.page_size
        off = torch.arange(length, device=self.table.device)
        return self.table[row].long()[off // ps] * ps + off % ps

    def gather_row(self, il: int, row: int, length: int):
        """Contiguous [Hkv, length, D] K/V of one slot."""
        idx = self._row_idx(row, length)
        return self.k[il][:, idx], self.v[il][:, idx]

    def scatter_row(self, il: int, row: int, k_row, v_row) -> "PagedKVCache":
        """Inverse of gather_row: write [Hkv, L, D] into the slot's pages."""
        idx = self._row_idx(row, k_row.shape[1])
        self.k[il][:, idx] = k_row.to(self.k[il].dtype)
        self.v[il][:, idx] = v_row.to(self.v[il].dtype)
        return self


class PageAllocator:
    """Host-side physical-page bookkeeping: refcounts + free list + the
    per-slot tables (zllm's PageAllocator, unchanged)."""

    def __init__(self, n_slots: int, max_len: int, page_size: int):
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} is not a multiple of page_size {page_size}")
        self.ps = page_size
        self.lp = max_len // page_size
        self.n_pages = n_slots * self.lp + 1
        self.refs = np.zeros(self.n_pages, np.int32)
        self.refs[0] = 2**30  # trash page: never freed
        self.free: list[int] = list(range(self.n_pages - 1, 0, -1))  # pop() -> low ids first
        self.table = np.zeros((n_slots, self.lp + 1), np.int32)  # logical -> phys
        self.owned = [0] * n_slots  # logical pages mapped per slot

    def _alloc(self) -> int:
        pid = self.free.pop()
        self.refs[pid] = 1
        return pid

    def release_slot(self, slot: int):
        for j in range(self.owned[slot]):
            pid = int(self.table[slot, j])
            self.refs[pid] -= 1
            if self.refs[pid] == 0:
                self.free.append(pid)
        self.table[slot, : self.lp] = 0
        self.owned[slot] = 0

    def assign_slot(self, slot: int, shared_from: int | None, n_shared_pages: int):
        """Map a fresh table row for `slot`: the first `n_shared_pages`
        logical pages alias `shared_from`'s physical pages (incref), the
        rest get fresh pages."""
        self.release_slot(slot)
        for j in range(n_shared_pages):
            pid = int(self.table[shared_from, j])
            self.refs[pid] += 1
            self.table[slot, j] = pid
        for j in range(n_shared_pages, self.lp):
            self.table[slot, j] = self._alloc()
        self.owned[slot] = self.lp

    def shareable_pages(self, prefix_tokens: int) -> int:
        """How many FULL pages a common prefix of `prefix_tokens` covers."""
        return prefix_tokens // self.ps

    def exclusively_owned(self, slot: int) -> bool:
        """True when none of the slot's pages are shared: the context shift
        rewrites page contents in place, which is only legal on refcount-1
        pages."""
        return all(
            int(self.refs[int(self.table[slot, j])]) == 1
            for j in range(self.owned[slot])
        )

    def unshare_slot(self, slot: int) -> list[tuple[int, int]]:
        """Copy-on-write unshare: remap every page `slot` shares (refcount
        > 1) to a fresh private page, decref'ing the shared one.  Returns
        [(src_pid, dst_pid), ...]; the caller copies page contents src ->
        dst in the device pools (PagedKVCache.copy_pages) before any write
        through the new mapping.  Raises IndexError when the free list
        cannot cover the copies."""
        copies = []
        for j in range(self.owned[slot]):
            pid = int(self.table[slot, j])
            if self.refs[pid] > 1:
                new = self._alloc()
                self.refs[pid] -= 1
                self.table[slot, j] = new
                copies.append((pid, new))
        return copies


def shift_context_row_paged(kv: PagedKVCache, rope_params, row: int, n_keep: int,
                            n_discard: int) -> PagedKVCache:
    """Per-slot context shift on the paged pool: gather the slot's logical
    row through its page table, drop `n_discard` entries after `n_keep`,
    re-rotate the moved K by -n_discard positions, scatter back into the
    same pages (in place).  The table is untouched; the slot's pages must be
    exclusively owned (PageAllocator.exclusively_owned)."""
    from ..ops.layers import apply_rope

    hz = kv.horizon
    for il in range(kv.n_layers):
        rk, rv = kv.gather_row(il, row, hz)  # [Hkv, hz, D]
        mk = rk[:, n_keep + n_discard:, :].transpose(0, 1)[None]  # [1, T, H, D]
        delta = torch.full((1, mk.shape[1]), -n_discard, dtype=torch.int32, device=mk.device)
        mk = apply_rope(mk, delta, rope_params)[0].transpose(0, 1)
        zk = torch.zeros_like(rk[:, :n_discard, :])
        nk = torch.cat([rk[:, :n_keep, :], mk, zk], dim=1)
        nv = torch.cat([rv[:, :n_keep, :], rv[:, n_keep + n_discard:, :], zk], dim=1)
        kv.scatter_row(il, row, nk, nv)
    return kv
