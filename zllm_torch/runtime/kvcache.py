"""Contiguous KV caches: per layer [B, Hkv, S, D] tensors updated in place.

Slot index == absolute token position.  The counterparts of
`zllm/runtime/kvcache.py::KVCache` and `KVCacheQ8`; JAX's arrays are
immutable and the cache is threaded through the forward pass, here the
tensors are written in place (the decode kernel K2 writes its row itself).

  * `KVCache`: bf16, f16 or f32 K/V (f16: llama.cpp's default cache
    type; on the card K2 and K6 take it in their f16 forms, K8 not yet).
  * `KVCacheQ8`: int8 codes with one f32 scale per [D] vector (llama.cpp's
    `-ctk/-ctv q8_0`), half the bytes a token of bf16.  Quantizing and
    inserting are plain PyTorch on the device, as they are XLA in zllm;
    attention reads the codes and scales directly (K7,
    `ops/attention.flash_attention_blockwise`).
  * `KVCacheSWA`: a `KVCache` whose windowed layers keep a ring of slots
    (zllm's pruned cache of sliding-window models, the reference's iswa
    cache); `ring_mask` is what a query of such a layer attends.
  * `shift_context_row`: the serving engine's per-row context shift over
    all three layouts (contiguous, q8, paged); `shift_context`, the same
    shift of every row of a `KVCache` at once.

The engine's caches hold `max_len + prefill_chunk` slots: inactive rows sit
at position max_len, and a run of T writes starting at or past S - T is
moved back to end at S - 1, as zllm's `dynamic_update_slice` clamps, so
their writes stay in the trash region [max_len, S).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.attention import QuantKV


_Q8_DIVISOR: dict[torch.device, torch.Tensor] = {}  # 127 as a 0-dim f32 tensor a device


def _q8_divisor(device: torch.device) -> torch.Tensor:
    d = _Q8_DIVISOR.get(device)
    if d is None:
        d = torch.full((), 127.0, device=device)
        # one made inside a CUDA-graph capture lives in the graph's pool
        if not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            _Q8_DIVISOR[device] = d
    return d


def _run_slots(positions: torch.Tensor, t: int, s: int):
    """Row and slot indices [B, 1], [B, T] of each row's run of t slots:
    it starts at clamp(positions[b, 0], 0, s - t), on the device (no host
    read, so rows may start anywhere)."""
    lo = positions[:, :1].long().clamp(0, s - t)
    rows = torch.arange(positions.shape[0], device=positions.device)[:, None]
    return rows, lo + torch.arange(t, device=positions.device)[None, :]


def _tensors(xs, device):
    return [torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(device) for x in xs]


@dataclass
class KVCache:
    k: list  # L x [B, Hkv, S, D]
    v: list  # L x [B, Hkv, S, D]

    @classmethod
    def create(cls, n_layers: int, batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        shape = (batch, n_kv_heads, max_len, head_dim)
        return cls(k=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layers)],
                   v=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layers)])

    @classmethod
    def from_jax(cls, k, v, device="cuda") -> "KVCache":
        """zllm's per-layer arrays (numpy) -> this cache, value for value."""
        return cls(k=_tensors(k, device), v=_tensors(v, device))

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]

    @property
    def n_layers(self) -> int:
        return len(self.k)

    @property
    def dtype(self) -> torch.dtype:
        return self.k[0].dtype

    def update(self, il: int, k_new: torch.Tensor, v_new: torch.Tensor, positions: torch.Tensor):
        """Write k/v [B, T, H, D] of layer il: row b's T tokens at slots
        p .. p+T-1, p = clamp(positions[b, 0], 0, S - T).  Positions are
        consecutive per row except where the engine pads a row with trash
        positions after its real tokens; only positions[:, 0] is read."""
        rows, idx = _run_slots(positions, k_new.shape[1], self.k[il].shape[2])
        self.k[il][rows, :, idx] = k_new.to(self.dtype)
        self.v[il][rows, :, idx] = v_new.to(self.dtype)

    def layer(self, il: int) -> tuple[torch.Tensor, torch.Tensor]:
        """-> k, v as [B, Hkv, S, D]."""
        return self.k[il], self.v[il]


@dataclass
class KVCacheSWA(KVCache):
    """The cache of a sliding-window model (zllm's `KVCacheSWA`): a full
    layer is an ordinary stripe of horizon + chunk slots; a windowed layer
    keeps `ring` = round_up(window + chunk, 128) slots (at most the
    horizon), addressed as position % ring, plus `chunk` slots of trash
    [ring, ring + chunk) that take the writes of rows at or past the
    horizon (the engine's idle rows).  A Gemma-2 layer pair then holds
    horizon + ring slots instead of 2 x horizon.

    Contract (zllm's): a run of writes starts at a multiple of `chunk`
    (the engine's prefill alignment) or is one generating token, so it
    never wraps inside the ring; a generating row's trash columns land on
    ring slots older than its window."""

    swa_mask: tuple = ()  # per layer: windowed
    ring: int = 0  # the windowed layers' ring slots
    horizon: int = 0  # attendable positions (the engine's max_len)

    @classmethod
    def create_swa(cls, cfg, batch: int, max_len: int, chunk: int, dtype=torch.bfloat16,
                   device="cuda") -> "KVCacheSWA":
        ring = min((cfg.sliding_window + chunk + 127) // 128 * 128, max_len)
        swa_mask = tuple(cfg.is_swa_layer(il) for il in range(cfg.n_layers))

        def stripe(il):
            s = ring + chunk if swa_mask[il] else max_len + chunk
            return torch.zeros((batch, cfg.n_kv_heads, s, cfg.head_dim), dtype=dtype,
                               device=device)

        return cls(k=[stripe(il) for il in range(cfg.n_layers)],
                   v=[stripe(il) for il in range(cfg.n_layers)], swa_mask=swa_mask, ring=ring,
                   horizon=max_len)

    @property
    def max_len(self) -> int:
        return max(x.shape[2] for x in self.k)

    def _map_positions(self, il: int, positions: torch.Tensor) -> torch.Tensor:
        """A windowed layer's slots of the rows' runs: position % ring for a
        live run, ring + offset (the trash) for a row at the horizon."""
        if not self.swa_mask[il]:
            return positions
        p0 = positions[:, :1]
        return torch.where(p0 >= self.horizon, self.ring + (positions - p0),
                           positions - p0 + p0 % self.ring)

    def update(self, il: int, k_new: torch.Tensor, v_new: torch.Tensor, positions: torch.Tensor):
        super().update(il, k_new, v_new, self._map_positions(il, positions))

    def ring_size(self, il: int) -> int:
        """Layer il's ring, 0 for a full layer."""
        return self.ring if self.swa_mask[il] else 0


def ring_mask(positions: torch.Tensor, ring: int, s_total: int, window: int) -> torch.Tensor:
    """bool [B, T, S] of a ring layer (zllm's `ring_mask`): slot s holds
    position a = p - ((p - s) mod ring); query p attends it iff 0 <= a <=
    p, a > p - window, and s < ring (the trash never)."""
    s_idx = torch.arange(s_total, device=positions.device)[None, None, :]
    p = positions[:, :, None].long()
    a = p - torch.remainder(p - s_idx, ring)
    m = (a >= 0) & (a <= p) & (s_idx < ring)
    if window > 0:
        m = m & (a > p - window)
    return m


@dataclass
class KVCacheQ8:
    """Per-vector symmetric int8 KV: each [D] key/value vector stores int8
    codes and one f32 scale (zllm's `KVCacheQ8`)."""

    k: list  # L x int8 [B, Hkv, S, D]
    v: list
    ks: list  # L x f32 [B, Hkv, S, 1]
    vs: list

    @classmethod
    def create(cls, n_layers: int, batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               device="cuda") -> "KVCacheQ8":
        shape, sshape = (batch, n_kv_heads, max_len, head_dim), (batch, n_kv_heads, max_len, 1)

        def codes():
            return [torch.zeros(shape, dtype=torch.int8, device=device) for _ in range(n_layers)]

        def scales():  # created at 1, as zllm's
            return [torch.ones(sshape, dtype=torch.float32, device=device)
                    for _ in range(n_layers)]

        return cls(k=codes(), v=codes(), ks=scales(), vs=scales())

    @classmethod
    def from_jax(cls, k, v, ks, vs, device="cuda") -> "KVCacheQ8":
        """zllm's per-layer codes and scales (numpy) -> this cache."""
        return cls(k=_tensors(k, device), v=_tensors(v, device), ks=_tensors(ks, device),
                   vs=_tensors(vs, device))

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]

    @property
    def n_layers(self) -> int:
        return len(self.k)

    @staticmethod
    def _quant(x: torch.Tensor):
        """[..., D] -> int8 codes and f32 scales [..., 1]: s = max|x| / 127
        (at least 1e-12), codes round(x / s) half to even, clipped to ±127;
        bit-exact with zllm's.  127 is a 0-dim tensor on x's device, made
        once: a CUDA division by a Python scalar multiplies by its rounded
        reciprocal instead."""
        xf = x.float()
        amax = xf.abs().amax(dim=-1, keepdim=True)
        s = torch.clamp_min(amax / _q8_divisor(x.device), 1e-12)
        return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s

    def update(self, il: int, k_new: torch.Tensor, v_new: torch.Tensor, positions: torch.Tensor):
        """Quantize k/v [B, T, H, D] and write them as `KVCache.update`
        does."""
        rows, idx = _run_slots(positions, k_new.shape[1], self.max_len)
        for codes, scales, x in ((self.k, self.ks, k_new), (self.v, self.vs, v_new)):
            q, s = self._quant(x)
            codes[il][rows, :, idx] = q
            scales[il][rows, :, idx] = s

    def layer(self, il: int) -> tuple[QuantKV, QuantKV]:
        """-> (k, v) as `QuantKV` pairs of codes and scales."""
        return QuantKV(self.k[il], self.ks[il]), QuantKV(self.v[il], self.vs[il])


def _splice(a: torch.Tensor, mid: torch.Tensor, fill: torch.Tensor, n_keep: int, hz: int):
    """One row [H, S, X]: keep [0, n_keep), then `mid`, then `fill`, then
    the region past the horizon as it is."""
    return torch.cat([a[:, :n_keep], mid, fill, a[:, hz:]], dim=1)


def _shift_rows(k: torch.Tensor, v: torch.Tensor, rope_params, n_keep: int, n_discard: int,
                hz: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows [H, S, D] of one layer's K and V (or [B, H, S, D], every row
    at once), shifted: K re-rotated by -n_discard."""
    from ..ops.layers import apply_rope

    batched = k.dim() == 4
    if not batched:
        k, v = k[None], v[None]
    mk = k[:, :, n_keep + n_discard:hz].transpose(1, 2)  # [B, T, H, D]
    delta = torch.full(mk.shape[:2], -n_discard, dtype=torch.int32, device=mk.device)
    mk = apply_rope(mk, delta, rope_params).transpose(1, 2)
    zk = torch.zeros_like(k[:, :, :n_discard])
    nk = torch.cat([k[:, :, :n_keep], mk, zk, k[:, :, hz:]], dim=2)
    nv = torch.cat([v[:, :, :n_keep], v[:, :, n_keep + n_discard:hz], zk, v[:, :, hz:]], dim=2)
    return (nk, nv) if batched else (nk[0], nv[0])


def _shift_contiguous(kv: KVCache, rope_params, row: int, n_keep: int, n_discard: int, hz: int):
    for il in range(kv.n_layers):
        kv.k[il][row], kv.v[il][row] = _shift_rows(kv.k[il][row], kv.v[il][row], rope_params,
                                                   n_keep, n_discard, hz)


def shift_context(kv: KVCache, rope_params, n_keep: int, n_discard: int) -> KVCache:
    """Context shift of every row at once (zllm's `shift_context`): drop
    `n_discard` slots after the first `n_keep`, slide the rest down, zero
    the freed tail and re-rotate the moved K by -n_discard positions, so
    its rotary phase matches its new slot.  The caller moves its positions
    back by n_discard.  In place; returns kv."""
    if not isinstance(kv, KVCache):
        raise TypeError(f"shift_context shifts a KVCache, not {type(kv).__name__}")
    for il in range(kv.n_layers):
        nk, nv = _shift_rows(kv.k[il], kv.v[il], rope_params, n_keep, n_discard, kv.max_len)
        kv.k[il].copy_(nk)
        kv.v[il].copy_(nv)
    return kv


def _shift_q8(kv: KVCacheQ8, rope_params, row: int, n_keep: int, n_discard: int, hz: int):
    """The moved K is dequantized, re-rotated and requantized (scales
    recomputed); V codes and scales just slide down (zllm's
    `_shift_context_row_q8`)."""
    from ..ops.layers import apply_rope

    for il in range(kv.n_layers):
        rk, rs = kv.k[il][row], kv.ks[il][row]  # [H, S, D] int8, [H, S, 1] f32
        mk = rk[:, n_keep + n_discard:hz].float() * rs[:, n_keep + n_discard:hz]
        delta = torch.full((1, mk.shape[1]), -n_discard, dtype=torch.int32, device=mk.device)
        mk = apply_rope(mk.transpose(0, 1)[None], delta, rope_params)[0].transpose(0, 1)
        mq, ms = KVCacheQ8._quant(mk)
        zq, zs = torch.zeros_like(rk[:, :n_discard]), torch.ones_like(rs[:, :n_discard])
        rv, rvs = kv.v[il][row], kv.vs[il][row]
        nk, nks = _splice(rk, mq, zq, n_keep, hz), _splice(rs, ms, zs, n_keep, hz)
        nv = _splice(rv, rv[:, n_keep + n_discard:hz], zq, n_keep, hz)
        nvs = _splice(rvs, rvs[:, n_keep + n_discard:hz], zs, n_keep, hz)
        kv.k[il][row], kv.ks[il][row], kv.v[il][row], kv.vs[il][row] = nk, nks, nv, nvs


def shift_context_row(kv, rope_params, row: int, n_keep: int, n_discard: int,
                      horizon: int | None = None):
    """Per-row context shift for the serving engine: within batch row `row`,
    drop `n_discard` slots after the first `n_keep`, slide [n_keep +
    n_discard, horizon) down, zero the freed tail, and re-rotate the moved
    K by -n_discard positions.  Slots at or past `horizon` (the engine's
    trash region; S when None) stay as they are.  A `PagedKVCache` shifts
    through its page table (`runtime/paged.shift_context_row_paged`; its
    horizon is its own).  In place; returns kv."""
    from .paged import PagedKVCache, shift_context_row_paged

    if isinstance(kv, PagedKVCache):
        return shift_context_row_paged(kv, rope_params, row, n_keep, n_discard)
    hz = kv.max_len if horizon is None else horizon
    if isinstance(kv, KVCacheQ8):
        _shift_q8(kv, rope_params, row, n_keep, n_discard, hz)
    else:
        _shift_contiguous(kv, rope_params, row, n_keep, n_discard, hz)
    return kv
