"""GGUF Q4_K blocks -> `QWeight`, the port's Hopper weight layout.

`zllm.quant.repack` cuts each weight into planes shaped for the TPU's
(8, 128) tiles: N on lanes, nibbles folded along K, and for Q4_K an
N-major packed-byte variant whose high nibble holds column c + N/2.  None
of that helps a GPU.  Here a Q4_K weight keeps one row per output column,
as the GGUF file has it, so that one warp streams one column's bytes along
K with 16-byte loads:

  * logical weight is y = x @ W with W[K, N] (GGUF stores W^T as [N, K])
  * qs   uint8 [N, K/2]:  qs[n, 32c + i] = code[n, 64c + i]
                          | code[n, 64c + 32 + i] << 4   (ggml's nibble order
                          inside each 64-element chunk c, so the low nibbles
                          of 4 bytes are 4 consecutive codes of group 2c and
                          the high nibbles 4 codes of group 2c + 1)
  * sc   uint8 [N, K/32]:  6-bit group scale
  * mn   uint8 [N, K/32]:  6-bit group min
  * d    fp16  [N, K/256]: superblock scale
  * dmin fp16  [N, K/256]: superblock min scale

The scales stay exact and two-level: a = f32(d) * sc, b = f32(dmin) * mn,
w = code * a - b, as ggml's dequantize_row_q4_K and `zllm`'s Q4_K kernels
compute them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.constants import QK_K, GGMLType
from . import blocks as qb

_PLANES = ("qs", "sc", "mn", "d", "dmin")


@dataclass
class QWeight:
    """A Q4_K weight of logical shape (K, N) in the layout above."""

    shape: tuple[int, int]  # (K, N)
    qs: torch.Tensor
    sc: torch.Tensor
    mn: torch.Tensor
    d: torch.Tensor
    dmin: torch.Tensor
    fmt: GGMLType = GGMLType.Q4_K

    @property
    def device(self) -> torch.device:
        return self.qs.device

    @property
    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.planes().values())

    def planes(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in _PLANES}

    def _replace(self, n: int, fn) -> "QWeight":
        return QWeight((self.shape[0], n), **{k: fn(p) for k, p in self.planes().items()})

    def codes(self) -> torch.Tensor:
        """uint8 [N, K] codes 0..15 in natural k order."""
        k, n = self.shape
        b = self.qs.reshape(n, k // 64, 1, 32)
        return torch.cat([b & 0xF, b >> 4], dim=2).reshape(n, k)

    def group_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-32-group f32 (a, b) [N, K/32]: a = d*sc, b = dmin*mn (exact)."""
        a = self.d.float().repeat_interleave(8, dim=1) * self.sc.float()
        b = self.dmin.float().repeat_interleave(8, dim=1) * self.mn.float()
        return a, b

    def dequant_nk(self) -> torch.Tensor:
        """f32 [N, K]: w = code * a - b."""
        k, n = self.shape
        a, b = self.group_scales()
        q = self.codes().float().reshape(n, k // 32, 32)
        return (q * a[..., None] - b[..., None]).reshape(n, k)

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """The logical [K, N] weight."""
        return self.dequant_nk().t().contiguous().to(dtype)

    def permute_n(self, perm) -> "QWeight":
        """Reorder output columns (every plane is one row per column)."""
        idx = torch.as_tensor(np.asarray(perm), dtype=torch.long, device=self.device)
        return self._replace(self.shape[1], lambda p: p.index_select(0, idx).contiguous())


def from_gguf_blocks(raw: np.ndarray, gguf_shape: tuple[int, int]) -> dict[str, np.ndarray]:
    """raw uint8 [N, row_bytes] Q4_K rows -> numpy planes of the layout."""
    n, k = gguf_shape
    if k % QK_K:
        raise ValueError(f"Q4_K row of {k} is not a multiple of {QK_K}")
    b = np.ascontiguousarray(raw).reshape(-1, 144)
    sc, mn = qb.unpack_kscales(b[:, 4:16])
    return {
        "qs": np.ascontiguousarray(b[:, 16:]).reshape(n, k // 2),
        "sc": sc.reshape(n, k // 32),
        "mn": mn.reshape(n, k // 32),
        "d": np.ascontiguousarray(b[:, 0:2]).view("<f2").reshape(n, k // QK_K),
        "dmin": np.ascontiguousarray(b[:, 2:4]).view("<f2").reshape(n, k // QK_K),
    }


def from_planes(planes: dict[str, np.ndarray], shape: tuple[int, int], device) -> QWeight:
    """numpy planes -> QWeight on `device` (fp16 planes as torch.float16)."""
    def t(x):
        x = np.ascontiguousarray(x)
        if x.dtype == np.dtype("<f2"):
            return torch.from_numpy(x.astype(np.float16)).to(device)
        return torch.from_numpy(x).to(device)

    return QWeight(tuple(shape), **{name: t(planes[name]) for name in _PLANES})


def repack(raw: np.ndarray, gguf_shape: tuple[int, int], fmt: GGMLType, device) -> QWeight:
    """GGUF rows (one per output feature) -> QWeight."""
    if GGMLType(fmt) != GGMLType.Q4_K:
        raise NotImplementedError(f"zllm_torch keeps only Q4_K quantized, not {GGMLType(fmt).name}")
    n, k = gguf_shape
    return from_planes(from_gguf_blocks(raw, (n, k)), (k, n), device)


def concat_n(qws: list[QWeight]) -> QWeight:
    """Concatenate along the output-feature axis (wq|wk|wv -> wqkv,
    gate|up -> gateup): one row per column, so this is a row concat."""
    k = qws[0].shape[0]
    if any(q.shape[0] != k for q in qws):
        raise ValueError("concat_n needs equal K")
    planes = {name: torch.cat([getattr(q, name) for q in qws], dim=0) for name in _PLANES}
    return QWeight((k, sum(q.shape[1] for q in qws)), **planes)


def pad_n(qw: QWeight, mult: int) -> QWeight:
    """Zero-pad the output-feature axis to a multiple of `mult`.  Padded
    columns dequantize to zero (d = dmin = 0); callers slice logits back to
    the true vocab."""
    k, n = qw.shape
    pad = (-n) % mult
    if pad == 0:
        return qw
    return qw._replace(n + pad, lambda p: torch.cat([p, p.new_zeros((pad,) + p.shape[1:])]))
