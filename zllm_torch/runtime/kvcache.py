"""Contiguous KV cache: per layer [B, Hkv, S, D] tensors updated in place.

Slot index == absolute token position.  The counterpart of
`zllm/runtime/kvcache.py::KVCache`; JAX's arrays are immutable and the
cache is threaded through the forward pass, here the tensors are written
in place (the decode kernel writes its row itself).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.k[0].dtype

    def update(self, il: int, k_new: torch.Tensor, v_new: torch.Tensor, start: int):
        """Write k/v [B, T, H, D] of layer il at slots start .. start+T-1 of
        every row.

        A run whose start exceeds S - T is moved back to end at slot S - 1,
        as JAX's dynamic_update_slice clamps (the trash-row convention:
        padded prefill positions clamp to max_len - 1, and write-before-attend
        keeps those slots safe).  `start` is a host int, so the insert needs
        no read back from the device."""
        t = k_new.shape[1]
        lo = min(max(int(start), 0), self.max_len - t)
        self.k[il][:, :, lo:lo + t] = k_new.transpose(1, 2).to(self.dtype)
        self.v[il][:, :, lo:lo + t] = v_new.transpose(1, 2).to(self.dtype)

    def layer(self, il: int) -> tuple[torch.Tensor, torch.Tensor]:
        """-> k, v as [B, Hkv, S, D]."""
        return self.k[il], self.v[il]
