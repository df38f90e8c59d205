"""GGUF blocks -> `QWeight`, the port's Hopper weight layouts (Q4_K, Q6_K,
Q8_0).

`zllm.quant.repack` cuts each weight into planes shaped for the TPU's
(8, 128) tiles: N on lanes, nibbles and crumbs folded along K, and for Q4_K
an N-major packed-byte variant whose high nibble holds column c + N/2.
None of that helps a GPU.  Here every plane keeps one row per output
column, as the GGUF file has it, so that one warp streams one column's
bytes along K with 16-byte loads.  The logical weight is y = x @ W with
W[K, N] (GGUF stores W^T as [N, K]).

Q4_K (`Q4KWeight`):
  * qs   uint8 [N, K/2]:  qs[n, 32c + i] = code[n, 64c + i]
                          | code[n, 64c + 32 + i] << 4   (ggml's nibble order
                          inside each 64-element chunk c, so the low nibbles
                          of 4 bytes are 4 consecutive codes of group 2c and
                          the high nibbles 4 codes of group 2c + 1)
  * sc, mn uint8 [N, K/32]: 6-bit group scale and min
  * d, dmin fp16 [N, K/256]: superblock scales
  The scales stay exact and two-level: a = f32(d) * sc, b = f32(dmin) * mn,
  w = code * a - b, as ggml's dequantize_row_q4_K and `zllm`'s Q4_K
  kernels compute them.

Q6_K (`Q6KWeight`), each 256-element superblock in ggml's bit order:
  * ql uint8 [N, K/2]: the superblock's 128 bytes; in half h (64 bytes)
                       byte j holds code 128h + j in its low nibble and
                       code 128h + 64 + j in its high nibble
  * qh uint8 [N, K/4]: the superblock's 64 bytes; in half h (32 bytes)
                       byte j holds bits 4-5 of code 128h + 32i + j in its
                       crumb i
  * a  fp16  [N, K/16]: a = fp16(f32(d) * sc), the scale of each 16-group
  w = (code - 32) * a.  `a` is rounded to fp16 as `zllm`'s repack rounds
  it (`zllm/quant/repack.py::_rp_q6_k`), so the kernels and `dequant()`
  give `zllm`'s values; ggml's own decoder uses the unrounded d * sc.

Q8_0 (`Q80Weight`):
  * qs int8 [N, K]:     the codes
  * d  fp16 [N, K/32]:  the scale of each 32-group;  w = qs * d

Every plane has one row per column, so `permute_n`, `concat_n` and `pad_n`
work on rows alike for every format; a padded column is all zeros and
dequantizes to zero.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from ..gguf.constants import GGML_BLOCK_SIZES, QK_K, GGMLType
from . import blocks as qb


class QWeight:
    """A block-quantized weight of logical shape (K, N): its planes, each
    [N, K / kdiv] with one row per output column.  Subclasses name the
    planes (`PLANES`: name -> (dtype, kdiv)) and their dequantization."""

    fmt: ClassVar[GGMLType]
    PLANES: ClassVar[dict[str, tuple[torch.dtype, int]]]
    shape: tuple[int, int]  # (K, N)

    @property
    def device(self) -> torch.device:
        return next(iter(self.planes().values())).device

    @property
    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.planes().values())

    def planes(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self.PLANES}

    def validate(self):
        """Raise unless every plane has its dtype and shape for self.shape."""
        k, n = self.shape
        for name, (dtype, kdiv) in self.PLANES.items():
            p = getattr(self, name)
            if p.dtype != dtype or tuple(p.shape) != (n, k // kdiv):
                raise ValueError(f"{self.fmt.name} plane {name}: {p.dtype} {tuple(p.shape)}, "
                                 f"want {dtype} {(n, k // kdiv)}")

    def _replace(self, n: int, fn) -> "QWeight":
        return type(self)((self.shape[0], n), **{k: fn(p) for k, p in self.planes().items()})

    def dequant_nk(self) -> torch.Tensor:
        """f32 [N, K]."""
        raise NotImplementedError

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """The logical [K, N] weight."""
        return self.dequant_nk().t().contiguous().to(dtype)

    def permute_n(self, perm) -> "QWeight":
        """Reorder output columns (every plane is one row per column)."""
        idx = torch.as_tensor(np.asarray(perm), dtype=torch.long, device=self.device)
        return self._replace(self.shape[1], lambda p: p.index_select(0, idx).contiguous())


@dataclass
class Q4KWeight(QWeight):
    """A Q4_K weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    sc: torch.Tensor
    mn: torch.Tensor
    d: torch.Tensor
    dmin: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.Q4_K
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "sc": (torch.uint8, 32),
                              "mn": (torch.uint8, 32), "d": (torch.float16, QK_K),
                              "dmin": (torch.float16, QK_K)}

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

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        sc, mn = qb.unpack_kscales(b[:, 4:16])
        return {
            "qs": np.ascontiguousarray(b[:, 16:]).reshape(n, k // 2),
            "sc": sc.reshape(n, k // 32),
            "mn": mn.reshape(n, k // 32),
            "d": np.ascontiguousarray(b[:, 0:2]).view("<f2").reshape(n, k // QK_K),
            "dmin": np.ascontiguousarray(b[:, 2:4]).view("<f2").reshape(n, k // QK_K),
        }


class _IntWeight(QWeight):
    """A format whose weight is a signed integer code times one scale per
    GROUP-wide group (no min term): w = int_codes * group_scale."""

    GROUP: ClassVar[int]

    def int_codes(self) -> torch.Tensor:
        """int16 [N, K] signed codes in natural k order."""
        raise NotImplementedError

    def group_scale(self) -> torch.Tensor:
        """f32 [N, K/GROUP]."""
        raise NotImplementedError

    def dequant_nk(self) -> torch.Tensor:
        k, n = self.shape
        q = self.int_codes().float().reshape(n, k // self.GROUP, self.GROUP)
        return (q * self.group_scale()[..., None]).reshape(n, k)


@dataclass
class Q6KWeight(_IntWeight):
    """A Q6_K weight in the layout above."""

    shape: tuple[int, int]
    ql: torch.Tensor
    qh: torch.Tensor
    a: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.Q6_K
    GROUP: ClassVar[int] = 16
    PLANES: ClassVar[dict] = {"ql": (torch.uint8, 2), "qh": (torch.uint8, 4),
                              "a": (torch.float16, 16)}

    def codes(self) -> torch.Tensor:
        """uint8 [N, K] codes 0..63 (bias 32) in natural k order."""
        k, n = self.shape
        ql = self.ql.reshape(n, k // 128, 1, 64)
        qh = self.qh.reshape(n, k // 128, 1, 32)
        lo = torch.cat([ql & 0xF, ql >> 4], dim=2).reshape(n, k // 128, 128)
        hi = torch.cat([(qh >> s) & 3 for s in (0, 2, 4, 6)], dim=2).reshape(n, k // 128, 128)
        return (lo | (hi << 4)).reshape(n, k)

    def int_codes(self) -> torch.Tensor:
        return self.codes().to(torch.int16) - 32

    def group_scale(self) -> torch.Tensor:
        return self.a.float()

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        d = np.ascontiguousarray(b[:, 208:210]).view("<f2").reshape(n, k // QK_K)
        sc = np.ascontiguousarray(b[:, 192:208]).view(np.int8).reshape(n, k // 16)
        return {
            "ql": np.ascontiguousarray(b[:, :128]).reshape(n, k // 2),
            "qh": np.ascontiguousarray(b[:, 128:192]).reshape(n, k // 4),
            # as zllm's repack rounds it: fp16(f32(d) * sc)
            "a": (d.astype(np.float32).repeat(16, axis=1) * sc).astype("<f2"),
        }

    @staticmethod
    def pack_codes(codes: np.ndarray) -> dict[str, np.ndarray]:
        """uint8 [N, K] codes 0..63 in natural k order -> the ql/qh planes."""
        n, k = codes.shape
        c = codes.astype(np.uint8).reshape(n, k // 128, 2, 64)
        h = (codes.astype(np.uint8) >> 4).reshape(n, k // 128, 4, 32)
        ql = (c[:, :, 0] & 0xF) | ((c[:, :, 1] & 0xF) << 4)
        qh = h[:, :, 0] | (h[:, :, 1] << 2) | (h[:, :, 2] << 4) | (h[:, :, 3] << 6)
        return {"ql": ql.reshape(n, k // 2), "qh": qh.reshape(n, k // 4)}


@dataclass
class Q80Weight(_IntWeight):
    """A Q8_0 weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    d: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.Q8_0
    GROUP: ClassVar[int] = 32
    PLANES: ClassVar[dict] = {"qs": (torch.int8, 1), "d": (torch.float16, 32)}

    def int_codes(self) -> torch.Tensor:
        return self.qs.to(torch.int16)

    def group_scale(self) -> torch.Tensor:
        return self.d.float()

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        return {
            "qs": np.ascontiguousarray(b[:, 2:]).view(np.int8).reshape(n, k),
            "d": np.ascontiguousarray(b[:, :2]).view("<f2").reshape(n, k // 32),
        }


WEIGHT_CLASSES: dict[GGMLType, type[QWeight]] = {
    cls.fmt: cls for cls in (Q4KWeight, Q6KWeight, Q80Weight)}


def _weight_class(fmt) -> type[QWeight]:
    cls = WEIGHT_CLASSES.get(GGMLType(fmt))
    if cls is None:
        raise NotImplementedError(f"zllm_torch keeps Q4_K, Q6_K and Q8_0 quantized, "
                                  f"not {GGMLType(fmt).name}")
    return cls


def from_planes(planes: dict[str, np.ndarray], shape: tuple[int, int], fmt, device) -> QWeight:
    """numpy planes -> the format's QWeight on `device` (fp16 planes as
    torch.float16)."""
    cls = _weight_class(fmt)

    def t(x):
        x = np.ascontiguousarray(x)
        if x.dtype == np.dtype("<f2"):
            x = x.astype(np.float16)
        return torch.from_numpy(x).to(device)

    qw = cls(tuple(shape), **{name: t(planes[name]) for name in cls.PLANES})
    qw.validate()
    return qw


def repack(raw: np.ndarray, gguf_shape: tuple[int, int], fmt: GGMLType, device) -> QWeight:
    """GGUF rows (one per output feature) -> QWeight; raises
    NotImplementedError for a format the port does not keep quantized."""
    cls = _weight_class(fmt)
    n, k = gguf_shape
    if k % QK_K:
        raise ValueError(f"{cls.fmt.name} row of {k} is not a multiple of {QK_K}")
    b = np.ascontiguousarray(raw).reshape(-1, GGML_BLOCK_SIZES[cls.fmt][1])
    return from_planes(cls.from_gguf(b, n, k), (k, n), cls.fmt, device)


def concat_n(qws: list[QWeight]) -> QWeight:
    """Concatenate along the output-feature axis (wq|wk|wv -> wqkv,
    gate|up -> gateup): one row per column, so this is a row concat."""
    k, cls = qws[0].shape[0], type(qws[0])
    if any(q.shape[0] != k or type(q) is not cls for q in qws):
        raise ValueError("concat_n needs one format and equal K")
    planes = {name: torch.cat([getattr(q, name) for q in qws], dim=0) for name in cls.PLANES}
    return cls((k, sum(q.shape[1] for q in qws)), **planes)


def pad_n(qw: QWeight, mult: int) -> QWeight:
    """Zero-pad the output-feature axis to a multiple of `mult`.  Padded
    columns dequantize to zero (all planes zero, so every scale is zero);
    callers slice logits back to the true vocab."""
    k, n = qw.shape
    pad = (-n) % mult
    if pad == 0:
        return qw
    return qw._replace(n + pad, lambda p: torch.cat([p, p.new_zeros((pad,) + p.shape[1:])]))
