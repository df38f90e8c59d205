"""GGUF blocks -> `QWeight`, the port's Hopper weight layouts (Q4_0, Q4_1,
Q4_K, Q5_0, Q5_1, Q5_K, Q6_K, Q8_0, Q2_K, Q3_K, IQ4_NL, IQ4_XS, MXFP4, the
IQ grid formats IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, IQ1_M, and
the ternary TQ1_0 and TQ2_0).

`zllm.quant.repack` cuts each weight into planes shaped for the TPU's
(8, 128) tiles: N on lanes, nibbles and crumbs folded along K, and for the
nibble formats an N-major packed-byte variant whose high nibble holds
column c + N/2.  None of that helps a GPU.  Here every plane keeps one row
per output column, as the GGUF file has it, so that one warp streams one
column's bytes along K with 16-byte loads.  The logical weight is y = x @ W
with W[K, N] (GGUF stores W^T as [N, K]).

The nibble formats (`NibbleWeight`: Q4_K, Q4_0, Q4_1, and the 5-bit Q5_0,
Q5_1, Q5_K) share one code plane, of the codes' low four bits:
  * qs   uint8 [N, K/2]:  qs[n, 32c + i] = code[n, 64c + i]
                          | code[n, 64c + 32 + i] << 4   (ggml's Q4_K nibble
                          order inside each 64-element chunk c, so the low
                          nibbles of 4 bytes are 4 consecutive codes of group
                          2c and the high nibbles 4 codes of group 2c + 1;
                          Q4_0/Q4_1 blocks pair code j with code j + 16 of
                          one 32-block instead, and are re-paired at load)
and differ in their scales:
  * Q4_K (`Q4KWeight`): sc, mn uint8 [N, K/32], the 6-bit group scale and
    min; d, dmin fp16 [N, K/256], the superblock scales.  The scales stay
    exact and two-level: a = f32(d) * sc, b = f32(dmin) * mn, w = code * a
    - b, as ggml's dequantize_row_q4_K and `zllm`'s Q4_K kernels compute
    them.
  * Q4_0 (`Q40Weight`): d fp16 [N, K/32];  w = (code - 8) * d, the -8
    applied to the integer code first, as `zllm`'s kernels do.
  * Q4_1 (`Q41Weight`): a = d and b = -m, fp16 [N, K/32];  w = code * a - b
    (`zllm/quant/repack.py::_rp_q4_1`'s contract).

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

Q2_K and Q3_K (`Q2KWeight`, `Q3KWeight`), 16-groups of 2-bit codes (Q3_K
adds a third bit), in an order of the port's own:
  * qs uint8 [N, K/4]:  16-group g in bytes 4g..4g+3, its element e in byte
                        4g + e % 4, bits 2(e // 4): the u32 word of a group,
                        shifted by 2i and masked with 0x03030303, holds its
                        elements 4i..4i+3 in its four bytes
  * qh uint8 [N, K/8]:  (Q3_K) the third bits in natural k order (bit j of
                        byte r is element 8r + j): the hmask bit, 1 where
                        ggml adds no -4
  * Q2_K: a = fp16(f32(d) * sc), b = fp16(f32(dmin) * mn) fp16 [N, K/16],
    w = code * a - b (code 0..3);  Q3_K: a = fp16(f32(d) * (sc - 32)) fp16
    [N, K/16], w = ((crumb | bit << 2) - 4) * a.
IQ4_NL, IQ4_XS and MXFP4 (`IQ4NLWeight`, `IQ4XSWeight`, `MXFP4Weight`),
32-groups of 4-bit indexes into a 16-entry table of int8 values
(IQ4NL_VALUES; MXFP4_VALUES, the e2m1 values doubled):
  * qs uint8 [N, K/2]:  the indexes in the nibble formats' shared order
  * IQ4_NL: d fp16 [N, K/32];  IQ4_XS: a = fp16(f32(d) * (sc - 32)) fp16
    [N, K/32];  MXFP4: e uint8 [N, K/32], the E8M0 exponent, scale
    2^(e - 128) (subnormal for e < 2);  w = table[index] * scale.
The IQ grid formats (`IQ2XXSWeight` ... `IQ1MWeight`): every grid value
times its sign falls in a small set, so at load each weight's grid row and
sign are folded into a per-weight value index, as `zllm`'s repack folds
them (`zllm/quant/repack.py::_rp_iq2_xxs` ...), with the group's scale
product rounded to fp16:
  * IQ2_XXS, IQ2_XS, IQ2_S: a 4-bit index into IQ2_VALUES (8, 25, 43, 0,
    -8, -25, -43, 0: magnitude index | sign << 2) in the qs order of the
    nibble formats; a = fp16(f32(d) * (0.5 + sc) * 0.25) fp16 [N, K/32]
    (IQ2_XXS) or [N, K/16] (IQ2_XS, IQ2_S);
  * IQ3_XXS: an index into IQ3XXS_VALUES (4, 12, ..., 52, 62, then their
    negatives), a = fp16(f32(d) * (0.5 + sc) * 0.5) [N, K/32];
  * IQ3_S: an index into IQ3S_VALUES (the odd values 1..15, then their
    negatives), a = fp16(f32(d) * (1 + 2 sc)) [N, K/32];
  * IQ1_S: the grid value + 1 (0..2) in the crumb plane of Q2_K, a =
    fp16(dl), b = fp16(-dl * delta) [N, K/32], dl = f32(d) * (2 sc + 1),
    delta +-1/8;  w = (crumb - 1) * a - b;
  * IQ1_M: the same crumbs, d from the top nibbles of its four scale
    words, a = fp16(dl) [N, K/16] and b = fp16(-dl * delta) [N, K/8] (its
    delta is one an 8-group).
The fold runs in torch on the target device, a chunk of superblocks at a
time.
TQ1_0 and TQ2_0 (`TQ10Weight`, `TQ20Weight`), ternary weights in {-1, 0,
1} times a per-256 fp16 d: the code (value + 1, 0..2) in the crumb plane
of Q2_K, and a = d repeated for each 32-group, fp16 [N, K/32] (exact: no
rounding), as `zllm/quant/repack.py::_rp_ternary` holds them;  w = (crumb -
1) * a.  TQ1_0's base-3 bytes and TQ2_0's crumbs are decoded at load.
The products that `zllm`'s repack rounds to fp16 (Q2_K's, Q3_K's, IQ4_XS's
and the IQ grid formats' a and b, as Q6_K's and Q5_K's) are rounded here
too, so every value is
`zllm`'s: ggml's own decoders use the unrounded ones.  The rounded planes
are what `params_from_jax` receives from `zllm`, whose d and 6-bit scales
are gone by then, so the port keeps them rather than the GGUF's smaller
scale bytes.

Every plane has one row per column, so `permute_n`, `concat_n` and `pad_n`
work on rows alike for every format; a padded column is all zeros and
dequantizes to zero.

A 32-block format's weight may have any K a multiple of 32, as zllm keeps
it (its fold 64 or 32): a last 32-block of K % 64 == 32 keeps, in the qs
plane's last 16 bytes, the GGUF's pairing of codes i and i + 16 (the 5-bit
formats' qh plane needs K % 64 == 0).  No kernel takes a weight whose K %
256 != 0: `ops/linear.py` multiplies it dequantized, as zllm does.
"""

from __future__ import annotations

import functools
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


def nibble_codes(qs: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The shared qs plane [N, K/2] -> uint8 [N, K] 4-bit codes in natural
    k order (a last 32-block of K % 64 == 32: byte i its codes i and i +
    16)."""
    main = k - k % 64
    b = qs[:, :main // 2].reshape(n, main // 64, 1, 32)
    codes = torch.cat([b & 0xF, b >> 4], dim=2).reshape(n, main)
    if main == k:
        return codes
    tail = qs[:, main // 2:]
    return torch.cat([codes, tail & 0xF, tail >> 4], dim=1)


def crumb_codes(qs: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The crumb plane [N, K/4] (order above) -> uint8 [N, K] 2-bit codes
    in natural k order."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=qs.device).reshape(1, 1, 4, 1)
    return ((qs.reshape(n, k // 16, 1, 4) >> shifts) & 3).reshape(n, k)


def pack_crumbs(codes):
    """uint8 [N, K] 2-bit codes in natural k order (numpy or torch) -> the
    crumb plane."""
    n, k = codes.shape
    c = codes.reshape(n, k // 16, 4, 4)
    return (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)).reshape(
        n, k // 4)


def pack_nibbles(codes):
    """uint8 [N, K] 4-bit codes in natural k order (numpy or torch) -> the
    nibble formats' qs plane [N, K/2]."""
    n, k = codes.shape
    main = k - k % 64
    c = codes[:, :main].reshape(n, main // 64, 2, 32)
    qs = (c[:, :, 0] | (c[:, :, 1] << 4)).reshape(n, main // 2)
    if main == k:
        return qs
    tail = codes[:, main:main + 16] | (codes[:, main + 16:] << 4)
    return (torch.cat if isinstance(codes, torch.Tensor) else np.concatenate)([qs, tail], 1)


def _f16_scaled(d: np.ndarray, sc: np.ndarray, per: int) -> np.ndarray:
    """fp16(f32(d) * sc): a superblock scale d [N, S] (fp16) times the
    integer scales sc [N, S * per] of its groups, rounded to fp16 as
    `zllm`'s repack rounds it (the product itself is exact in f32)."""
    return (d.astype(np.float32).repeat(per, axis=1) * sc).astype("<f2")


class NibbleWeight(QWeight):
    """A 4- or 5-bit format in the shared `qs` layout above (K1 and K3 take
    all of them, K12 and K11 the 4-bit ones): codes 0..15 (0..31), OFFSET
    subtracted from the integer codes first, then per-32-group w = (code -
    OFFSET) * a - b."""

    OFFSET: ClassVar[int] = 0

    def codes(self) -> torch.Tensor:
        """uint8 [N, K] codes in natural k order."""
        return nibble_codes(self.qs, *self.shape)

    def kernel_planes(self) -> list[torch.Tensor | None]:
        """The planes the nibble kernels' C entry points take as qs, s0, s1,
        ...: qs, then the scale planes in PLANES order."""
        return list(self.planes().values())

    def group_scales(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Per-32-group f32 (a, b) [N, K/32]; b is None for a format without
        a min term."""
        raise NotImplementedError

    def dequant_nk(self) -> torch.Tensor:
        """f32 [N, K]: w = (code - OFFSET) * a - b."""
        k, n = self.shape
        a, b = self.group_scales()
        q = self.codes().float().reshape(n, k // 32, 32)
        if self.OFFSET:
            q = q - self.OFFSET
        w = q * a[..., None]
        if b is not None:
            w = w - b[..., None]
        return w.reshape(n, k)

    @staticmethod
    def pair_legacy(qs: np.ndarray, n: int, k: int) -> np.ndarray:
        """Q4_0/Q4_1 nibbles (byte j of a 32-block holds codes j and j + 16)
        [N, K/2] -> the shared qs plane (byte 32c + i holds codes 64c + i
        and 64c + 32 + i; a last 32-block of K % 64 == 32 keeps its bytes)."""
        qs = qs.reshape(n, k // 2)
        main = k - k % 64
        b = qs[:, :main // 2].reshape(n, main // 64, 2, 16)
        c = np.concatenate([b & 0xF, b >> 4], axis=3)  # the codes of blocks 2c, 2c + 1
        paired = (c[:, :, 0] | (c[:, :, 1] << 4)).reshape(n, main // 2)
        return np.concatenate([paired, qs[:, main // 2:]], axis=1) if main < k else paired


@dataclass
class Q4KWeight(NibbleWeight):
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

    def group_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        """a = d*sc, b = dmin*mn (exact)."""
        a = self.d.float().repeat_interleave(8, dim=1) * self.sc.float()
        b = self.dmin.float().repeat_interleave(8, dim=1) * self.mn.float()
        return a, b

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


@dataclass
class Q40Weight(NibbleWeight):
    """A Q4_0 weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    d: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.Q4_0
    OFFSET: ClassVar[int] = 8
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "d": (torch.float16, 32)}

    def group_scales(self) -> tuple[torch.Tensor, None]:
        return self.d.float(), None

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        return {"qs": NibbleWeight.pair_legacy(np.ascontiguousarray(b[:, 2:]), n, k),
                "d": np.ascontiguousarray(b[:, :2]).view("<f2").reshape(n, k // 32)}


@dataclass
class Q41Weight(NibbleWeight):
    """A Q4_1 weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.Q4_1
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "a": (torch.float16, 32),
                              "b": (torch.float16, 32)}

    def group_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.a.float(), self.b.float()

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        m = np.ascontiguousarray(b[:, 2:4]).view("<f2").reshape(n, k // 32)
        return {"qs": NibbleWeight.pair_legacy(np.ascontiguousarray(b[:, 4:]), n, k),
                "a": np.ascontiguousarray(b[:, :2]).view("<f2").reshape(n, k // 32),
                "b": -m}  # negating an fp16 is exact


class Q5Weight(NibbleWeight):
    """A 5-bit nibble format: the qs plane of the low four bits and the qh
    plane of the fifth, in the order above."""

    def codes(self) -> torch.Tensor:
        """uint8 [N, K] codes 0..31 in natural k order."""
        k, n = self.shape
        bits = (self.qh.reshape(n, k // 64, 2, 2, 2, 1) >> torch.arange(
            8, dtype=torch.uint8, device=self.qh.device)) & 1  # [n, c, p, h, t, i]
        return super().codes() | (bits.transpose(2, 3).reshape(n, k) << 4)

    def kernel_planes(self) -> list[torch.Tensor | None]:
        """qs, the scale planes as s0 (and s1), and qh as s3 (K1 and K3)."""
        planes = [p for name, p in self.planes().items() if name != "qh"]
        return planes + [None] * (4 - len(planes)) + [self.qh]

    @staticmethod
    def pack_high(bits: np.ndarray) -> np.ndarray:
        """uint8 [N, K] fifth bits (0/1) in natural k order -> qh [N, K/8]."""
        n, k = bits.shape
        b = bits.astype(np.uint8).reshape(n, k // 64, 2, 2, 2, 8).transpose(0, 1, 3, 2, 4, 5)
        return np.packbits(b, axis=-1, bitorder="little").reshape(n, k // 8)

    @staticmethod
    def pack_codes(codes: np.ndarray) -> dict[str, np.ndarray]:
        """uint8 [N, K] codes 0..31 in natural k order -> the qs/qh planes."""
        n, k = codes.shape
        c = codes.astype(np.uint8).reshape(n, k // 64, 2, 32) & 0xF
        return {"qs": (c[:, :, 0] | (c[:, :, 1] << 4)).reshape(n, k // 2),
                "qh": Q5Weight.pack_high(codes >> 4)}

    @staticmethod
    def legacy_planes(b: np.ndarray, n: int, k: int, qh_at: int) -> dict[str, np.ndarray]:
        """The qs and qh planes of Q5_0/Q5_1 blocks [N * K/32, bytes], whose
        4 high-bit bytes start at byte `qh_at` and the 16 nibble bytes
        follow them."""
        return {"qs": NibbleWeight.pair_legacy(np.ascontiguousarray(b[:, qh_at + 4:]), n, k),
                "qh": Q5Weight.pack_high(qb._qh_bits32(
                    np.ascontiguousarray(b[:, qh_at:qh_at + 4])).reshape(n, k))}


@dataclass
class Q50Weight(Q5Weight):
    """A Q5_0 weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    qh: torch.Tensor
    d: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.Q5_0
    OFFSET: ClassVar[int] = 16
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "qh": (torch.uint8, 8),
                              "d": (torch.float16, 32)}

    def group_scales(self) -> tuple[torch.Tensor, None]:
        return self.d.float(), None

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        return {**Q5Weight.legacy_planes(b, n, k, 2),
                "d": np.ascontiguousarray(b[:, :2]).view("<f2").reshape(n, k // 32)}


@dataclass
class Q51Weight(Q5Weight):
    """A Q5_1 weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    qh: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.Q5_1
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "qh": (torch.uint8, 8),
                              "a": (torch.float16, 32), "b": (torch.float16, 32)}

    def group_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.a.float(), self.b.float()

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        m = np.ascontiguousarray(b[:, 2:4]).view("<f2").reshape(n, k // 32)
        return {**Q5Weight.legacy_planes(b, n, k, 4),
                "a": np.ascontiguousarray(b[:, :2]).view("<f2").reshape(n, k // 32),
                "b": -m}  # negating an fp16 is exact


@dataclass
class Q5KWeight(Q5Weight):
    """A Q5_K weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    qh: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.Q5_K
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "qh": (torch.uint8, 8),
                              "a": (torch.float16, 32), "b": (torch.float16, 32)}

    def group_scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.a.float(), self.b.float()

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        sc, mn = qb.unpack_kscales(b[:, 4:16])
        d = np.ascontiguousarray(b[:, 0:2]).view("<f2").reshape(n, k // QK_K)
        dmin = np.ascontiguousarray(b[:, 2:4]).view("<f2").reshape(n, k // QK_K)
        return {
            "qs": np.ascontiguousarray(b[:, 48:]).reshape(n, k // 2),
            "qh": Q5Weight.pack_high(qb._bits_unpack(np.ascontiguousarray(b[:, 16:48]), 1, 32)
                                     .reshape(n, k)),
            "a": _f16_scaled(d, sc.reshape(n, k // 32), 8),
            "b": _f16_scaled(dmin, mn.reshape(n, k // 32), 8),
        }


class IntWeight(QWeight):
    """A format whose weight is an integer code times one scale per
    GROUP-wide group, less a min per group where the format has one (Q2_K
    alone): w = int_codes * group_scale - group_min.  K4 and K5 take
    them."""

    GROUP: ClassVar[int]

    def int_codes(self) -> torch.Tensor:
        """int16 [N, K] codes in natural k order."""
        raise NotImplementedError

    def group_scale(self) -> torch.Tensor:
        """f32 [N, K/GROUP]."""
        raise NotImplementedError

    def group_min(self) -> torch.Tensor | None:
        """f32 [N, K/GROUP], or None for a format without a min term."""
        return None

    def dequant_nk(self) -> torch.Tensor:
        k, n = self.shape
        q = self.int_codes().float().reshape(n, k // self.GROUP, self.GROUP)
        w = q * self.group_scale()[..., None]
        b = self.group_min()
        if b is not None:
            w = w - b[..., None]
        return w.reshape(n, k)


@dataclass
class Q6KWeight(IntWeight):
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
            "a": _f16_scaled(d, sc, 16),
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
class Q80Weight(IntWeight):
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


def _crumbs_gguf(qs: np.ndarray, n: int, k: int) -> np.ndarray:
    """Q2_K/Q3_K blocks' 64 code bytes [N * K/256, 64] (ggml's order: in
    half h, byte j holds element 128h + 32i + j in crumb i) -> uint8 [N, K]
    codes in natural k order."""
    return np.concatenate([qb._bits_unpack(np.ascontiguousarray(qs[:, 32 * h:32 * (h + 1)]),
                                           2, 32) for h in range(2)], axis=1).reshape(n, k)


@dataclass
class Q2KWeight(IntWeight):
    """A Q2_K weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.Q2_K
    GROUP: ClassVar[int] = 16
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 4), "a": (torch.float16, 16),
                              "b": (torch.float16, 16)}

    def int_codes(self) -> torch.Tensor:
        return crumb_codes(self.qs, *self.shape).to(torch.int16)

    def group_scale(self) -> torch.Tensor:
        return self.a.float()

    def group_min(self) -> torch.Tensor:
        return self.b.float()

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        sc = np.ascontiguousarray(b[:, :16])
        d = np.ascontiguousarray(b[:, 80:82]).view("<f2").reshape(n, k // QK_K)
        dmin = np.ascontiguousarray(b[:, 82:84]).view("<f2").reshape(n, k // QK_K)
        return {"qs": pack_crumbs(_crumbs_gguf(b[:, 16:80], n, k)),
                "a": _f16_scaled(d, (sc & 0x0F).reshape(n, k // 16), 16),
                "b": _f16_scaled(dmin, (sc >> 4).reshape(n, k // 16), 16)}


@dataclass
class Q3KWeight(IntWeight):
    """A Q3_K weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    qh: torch.Tensor
    a: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.Q3_K
    GROUP: ClassVar[int] = 16
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 4), "qh": (torch.uint8, 8),
                              "a": (torch.float16, 16)}

    def high_bits(self) -> torch.Tensor:
        """uint8 [N, K] the third bits (the hmask) in natural k order."""
        k, n = self.shape
        shifts = torch.arange(8, dtype=torch.uint8, device=self.qh.device)
        return ((self.qh[..., None] >> shifts) & 1).reshape(n, k)

    def int_codes(self) -> torch.Tensor:
        lo = crumb_codes(self.qs, *self.shape)
        return (lo | (self.high_bits() << 2)).to(torch.int16) - 4

    def group_scale(self) -> torch.Tensor:
        return self.a.float()

    @staticmethod
    def pack_high(bits: np.ndarray) -> np.ndarray:
        """uint8 [N, K] bits in natural k order -> the qh plane [N, K/8]."""
        n, k = bits.shape
        return np.packbits(bits.astype(np.uint8).reshape(n, k // 8, 8), axis=-1,
                           bitorder="little").reshape(n, k // 8)

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        d = np.ascontiguousarray(b[:, 108:110]).view("<f2").reshape(n, k // QK_K)
        sc = qb.q3k_scales(np.ascontiguousarray(b[:, 96:108])).reshape(n, k // 16)
        hb = qb._bits_unpack(np.ascontiguousarray(b[:, :32]), 1, 32).reshape(n, k)
        return {"qs": pack_crumbs(_crumbs_gguf(b[:, 32:96], n, k)),
                "qh": Q3KWeight.pack_high(hb), "a": _f16_scaled(d, sc, 16)}


class _TableWeight(IntWeight):
    """A 4-bit index into TABLE (16 int8 values) a weight, in the nibble
    formats' qs order, and one scale a 32-group."""

    GROUP: ClassVar[int] = 32
    TABLE: ClassVar[np.ndarray]

    def int_codes(self) -> torch.Tensor:
        # a chain of selects with the values as scalars (zllm's `_iq4_lut`):
        # no host table to copy, so a CUDA graph can capture it
        idx = nibble_codes(self.qs, *self.shape)
        out = torch.full(idx.shape, int(self.TABLE[0]), dtype=torch.int16, device=idx.device)
        for i in range(1, 16):
            out = torch.where(idx == i, int(self.TABLE[i]), out)
        return out


@dataclass
class IQ4NLWeight(_TableWeight):
    """An IQ4_NL weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    d: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.IQ4_NL
    TABLE: ClassVar[np.ndarray] = qb.IQ4NL_VALUES
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "d": (torch.float16, 32)}

    def group_scale(self) -> torch.Tensor:
        return self.d.float()

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        return {"qs": NibbleWeight.pair_legacy(np.ascontiguousarray(b[:, 2:]), n, k),
                "d": np.ascontiguousarray(b[:, :2]).view("<f2").reshape(n, k // 32)}


@dataclass
class IQ4XSWeight(_TableWeight):
    """An IQ4_XS weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.IQ4_XS
    TABLE: ClassVar[np.ndarray] = qb.IQ4NL_VALUES
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "a": (torch.float16, 32)}

    def group_scale(self) -> torch.Tensor:
        return self.a.float()

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        d = np.ascontiguousarray(b[:, :2]).view("<f2").reshape(n, k // QK_K)
        sc = qb.iq4xs_scales(b[:, 2:4], np.ascontiguousarray(b[:, 4:8])).reshape(n, k // 32)
        # each superblock's 8 groups of 16 bytes pair codes j and j + 16, as
        # a Q4_0 block does
        qs = np.ascontiguousarray(b[:, 8:]).reshape(n, k // 2)
        return {"qs": NibbleWeight.pair_legacy(qs, n, k), "a": _f16_scaled(d, sc, 8)}


@dataclass
class MXFP4Weight(_TableWeight):
    """An MXFP4 weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    e: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.MXFP4
    TABLE: ClassVar[np.ndarray] = qb.MXFP4_VALUES
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "e": (torch.uint8, 32)}

    def group_scale(self) -> torch.Tensor:
        """2^(e - 128) from its bits, subnormal for e < 2 (zllm's
        `_dq_mxfp4` and `e8m0_half_to_f32`)."""
        e = self.e.to(torch.int32)
        bits = torch.where(e < 2, 0x00200000 << e, (e - 1) << 23)
        return bits.view(torch.float32)

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        return {"qs": NibbleWeight.pair_legacy(np.ascontiguousarray(b[:, 1:]), n, k),
                "e": np.ascontiguousarray(b[:, :1]).reshape(n, k // 32)}


# the IQ grid formats' value tables (index -> int8 value; zllm's
# IQ2_VALUES, IQ3XXS_VALUES and the IQ3_S decode (2 (i & 7) + 1) (1 - 2 (i >> 3)))
IQ2_MAGS = np.array([8, 25, 43], dtype=np.int8)
IQ2_VALUES = np.array([8, 25, 43, 0, -8, -25, -43, 0] + [0] * 8, dtype=np.int8)
IQ3XXS_MAGS = np.array([4, 12, 20, 28, 36, 44, 52, 62], dtype=np.int8)
IQ3XXS_VALUES = np.concatenate([IQ3XXS_MAGS, -IQ3XXS_MAGS]).astype(np.int8)
IQ3S_VALUES = np.array([(2 * (i & 7) + 1) * (1 - 2 * (i >> 3)) for i in range(16)], dtype=np.int8)

_FOLD_BLOCKS = 1 << 15  # superblocks folded at once (8 M weights)


@functools.lru_cache(maxsize=None)
def _grid_codes(name: str, device: str) -> torch.Tensor:
    """A grid's rows as value indexes without the sign, uint8 [rows, 8 or
    4] on `device`: the magnitude's index (IQ2, IQ3_XXS), (|v| - 1) / 2
    (IQ3_S), or v + 1 (IQ1)."""
    g = qb.iq_grids()[name]
    if name.startswith("iq2"):
        codes = np.searchsorted(IQ2_MAGS.astype(np.float32), g)
    elif name == "iq3_xxs_grid":
        codes = np.searchsorted(IQ3XXS_MAGS.astype(np.float32), g)
    elif name == "iq3_s_grid":
        codes = (g - 1) / 2
    else:
        codes = g + 1
    return torch.from_numpy(codes.astype(np.uint8)).to(device)


@functools.lru_cache(maxsize=None)
def _ksigns(device: str) -> torch.Tensor:
    return torch.from_numpy(qb._KSIGNS).to(device)


def _bits8(b: torch.Tensor) -> torch.Tensor:
    """uint8 [...] -> its 8 bits, uint8 [..., 8] (bit i at i)."""
    return (b[..., None] >> torch.arange(8, dtype=torch.uint8, device=b.device)) & 1


def _ksign_bits(codes: torch.Tensor) -> torch.Tensor:
    """7-bit sign codes (int) [...] -> the 8 sign bits, uint8 [..., 8]."""
    return _bits8(_ksigns(str(codes.device))[(codes & 127).long()])


def _shifts(x: torch.Tensor, shifts) -> torch.Tensor:
    """int32 [..., m] -> [..., m, len(shifts)]: x >> each shift."""
    return x[..., None] >> torch.tensor(shifts, dtype=torch.int32, device=x.device)


def _f16_f32(b: torch.Tensor) -> torch.Tensor:
    """uint8 [nb, 2] fp16 bytes -> f32 [nb, 1]."""
    return b.contiguous().view(torch.float16).float()


def _u16(b: torch.Tensor) -> torch.Tensor:
    """uint8 [nb, 2m] -> the m little-endian u16 words, int32 [nb, m]."""
    return b.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF


def _fold_iq2_xxs(b):
    nb = b.shape[0]
    d = _f16_f32(b[:, :2])
    aux = b[:, 2:].contiguous().view(torch.int32).reshape(nb, 8, 2)[:, :, 1]
    rows = b[:, 2:].reshape(nb, 8, 8)[:, :, :4]  # the grid rows' bytes
    db = d * (0.5 + ((aux >> 28) & 15).float()) * 0.25  # [nb, 8]
    neg = _ksign_bits(_shifts(aux, (0, 7, 14, 21)))  # [nb, 8, 4, 8]
    codes = _grid_codes("iq2_xxs_grid", str(b.device))[rows.long()] | (neg << 2)
    return codes.reshape(nb, QK_K), (db,)


def _fold_iq2_xs(b):
    nb = b.shape[0]
    d = _f16_f32(b[:, :2])
    qs = _u16(b[:, 2:66])  # [nb, 32]: grid row 9 bits, sign code 7
    sl = b[:, 66:74]
    sc = torch.stack([sl & 15, sl >> 4], dim=-1).reshape(nb, 16)
    db = d * (0.5 + sc.float()) * 0.25  # [nb, 16]
    codes = (_grid_codes("iq2_xs_grid", str(b.device))[(qs & 511).long()]
             | (_ksign_bits(qs >> 9) << 2))
    return codes.reshape(nb, QK_K), (db,)


def _fold_iq2_s(b):
    nb = b.shape[0]
    d = _f16_f32(b[:, :2])
    qs, sbytes, qh, sl = b[:, 2:34], b[:, 34:66], b[:, 66:74], b[:, 74:82]
    sc = torch.stack([sl & 15, sl >> 4], dim=-1).reshape(nb, 16)
    db = d * (0.5 + sc.float()) * 0.25  # [nb, 16]
    hi = (_shifts(qh.to(torch.int32), (0, 2, 4, 6)) & 3).reshape(nb, 32)
    idx = qs.to(torch.int32) | (hi << 8)
    codes = _grid_codes("iq2_s_grid", str(b.device))[idx.long()] | (_bits8(sbytes) << 2)
    return codes.reshape(nb, QK_K), (db,)


def _fold_iq3_xxs(b):
    nb = b.shape[0]
    d = _f16_f32(b[:, :2])
    aux = b[:, 66:98].contiguous().view(torch.int32)  # [nb, 8]
    db = d * (0.5 + ((aux >> 28) & 15).float()) * 0.5  # [nb, 8]
    neg = _ksign_bits(_shifts(aux, (0, 7, 14, 21))).reshape(nb, QK_K)
    codes = _grid_codes("iq3_xxs_grid", str(b.device))[b[:, 2:66].long()].reshape(nb, QK_K)
    return codes | (neg << 3), (db,)


def _fold_iq3_s(b):
    nb = b.shape[0]
    d = _f16_f32(b[:, :2])
    qs, qh, sbytes, sl = b[:, 2:66], b[:, 66:74], b[:, 74:106], b[:, 106:110]
    sc = torch.stack([sl & 15, sl >> 4], dim=-1).reshape(nb, 8)
    db = d * (1 + 2 * sc.float())  # [nb, 8]
    hi = _bits8(qh).reshape(nb, 64).to(torch.int32)
    idx = qs.to(torch.int32) | (hi << 8)
    codes = _grid_codes("iq3_s_grid", str(b.device))[idx.long()].reshape(nb, QK_K)
    return codes | (_bits8(sbytes).reshape(nb, QK_K) << 3), (db,)


def _fold_iq1_s(b):
    nb = b.shape[0]
    d = _f16_f32(b[:, :2])
    qh = _u16(b[:, 34:50])  # [nb, 8]: 4 grid rows' high bits, scale, delta sign
    dl = d * (2 * ((qh >> 12) & 7) + 1).float()  # [nb, 8]
    delta = torch.where((qh & 0x8000) == 0, 0.125, -0.125)
    idx = b[:, 2:34].to(torch.int32) | ((_shifts(qh, (0, 3, 6, 9)) & 7).reshape(nb, 32) << 8)
    codes = _grid_codes("iq1_s_grid", str(b.device))[idx.long()]
    return codes.reshape(nb, QK_K), (dl, -dl * delta)


def _fold_iq1_m(b):
    nb = b.shape[0]
    qh = b[:, 32:48]
    sraw = _u16(b[:, 48:56])  # [nb, 4]
    d16 = ((sraw & 0xF000) >> torch.tensor([12, 8, 4, 0], dtype=torch.int32,
                                           device=b.device)).sum(dim=1, keepdim=True)
    d = torch.where(d16 >= 32768, d16 - 65536, d16).to(torch.int16).view(torch.float16).float()
    sc = (_shifts(sraw, (0, 3, 6, 9)) & 7).reshape(nb, 16)
    dl = d * (2 * sc + 1).float()  # [nb, 16]
    hi = torch.stack([qh & 15, qh >> 4], dim=-1).reshape(nb, 32)
    idx = b[:, :32].to(torch.int32) | ((hi & 7).to(torch.int32) << 8)
    delta = torch.where((hi & 8) == 0, 0.125, -0.125)  # [nb, 32], one an 8-group
    codes = _grid_codes("iq1_m_grid", str(b.device))[idx.long()]
    return codes.reshape(nb, QK_K), (dl, -dl.repeat_interleave(2, dim=1) * delta)


class IQWeight(IntWeight):
    """An IQ grid format: the GGUF's grid rows and signs folded at load into
    per-weight value indexes (the layout above), on the target device.
    `fold(b)` takes the blocks (uint8 tensor [nb, block bytes]) to (codes
    uint8 [nb, 256], (scale planes f32 [nb, groups], ...)); `planes_from`
    lays them out."""

    fold: ClassVar

    @classmethod
    def from_blocks(cls, b: torch.Tensor, n: int, k: int) -> dict[str, torch.Tensor]:
        parts = [cls.fold(b[i:i + _FOLD_BLOCKS]) for i in range(0, b.shape[0], _FOLD_BLOCKS)]
        codes = torch.cat([c for c, _ in parts]).reshape(n, k)
        scales = [torch.cat([s[j] for _, s in parts]).to(torch.float16).reshape(n, -1)
                  for j in range(len(parts[0][1]))]
        return cls.planes_from(codes, scales)


class _IQTableWeight(_TableWeight, IQWeight):
    """IQ2_*, IQ3_*: 4-bit indexes into TABLE in the nibble formats' qs order,
    one fp16 scale a GROUP-wide group."""

    def group_scale(self) -> torch.Tensor:
        return self.a.float()

    @staticmethod
    def planes_from(codes, scales):
        return {"qs": pack_nibbles(codes), "a": scales[0]}


@dataclass
class IQ2XXSWeight(_IQTableWeight):
    """An IQ2_XXS weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.IQ2_XXS
    TABLE: ClassVar[np.ndarray] = IQ2_VALUES
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "a": (torch.float16, 32)}
    fold = staticmethod(_fold_iq2_xxs)


@dataclass
class IQ2XSWeight(_IQTableWeight):
    """An IQ2_XS weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.IQ2_XS
    GROUP: ClassVar[int] = 16
    TABLE: ClassVar[np.ndarray] = IQ2_VALUES
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "a": (torch.float16, 16)}
    fold = staticmethod(_fold_iq2_xs)


@dataclass
class IQ2SWeight(_IQTableWeight):
    """An IQ2_S weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.IQ2_S
    GROUP: ClassVar[int] = 16
    TABLE: ClassVar[np.ndarray] = IQ2_VALUES
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "a": (torch.float16, 16)}
    fold = staticmethod(_fold_iq2_s)


@dataclass
class IQ3XXSWeight(_IQTableWeight):
    """An IQ3_XXS weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.IQ3_XXS
    TABLE: ClassVar[np.ndarray] = IQ3XXS_VALUES
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "a": (torch.float16, 32)}
    fold = staticmethod(_fold_iq3_xxs)


@dataclass
class IQ3SWeight(_IQTableWeight):
    """An IQ3_S weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.IQ3_S
    TABLE: ClassVar[np.ndarray] = IQ3S_VALUES
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 2), "a": (torch.float16, 32)}
    fold = staticmethod(_fold_iq3_s)


@dataclass
class IQ1SWeight(IQWeight):
    """An IQ1_S weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.IQ1_S
    GROUP: ClassVar[int] = 32
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 4), "a": (torch.float16, 32),
                              "b": (torch.float16, 32)}
    fold = staticmethod(_fold_iq1_s)

    def int_codes(self) -> torch.Tensor:
        return crumb_codes(self.qs, *self.shape).to(torch.int16) - 1

    def group_scale(self) -> torch.Tensor:
        return self.a.float()

    def group_min(self) -> torch.Tensor:
        return self.b.float()

    @staticmethod
    def planes_from(codes, scales):
        return {"qs": pack_crumbs(codes), "a": scales[0], "b": scales[1]}


@dataclass
class IQ1MWeight(IQ1SWeight):
    """An IQ1_M weight in the layout above: a a 16-group, b an 8-group (K5
    alone takes it, as in zllm)."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.IQ1_M
    GROUP: ClassVar[int] = 16
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 4), "a": (torch.float16, 16),
                              "b": (torch.float16, 8)}
    fold = staticmethod(_fold_iq1_m)

    def dequant_nk(self) -> torch.Tensor:
        """w = (crumb - 1) * a - b, a per 16-group and b per 8-group."""
        k, n = self.shape
        q = self.int_codes().float().reshape(n, k // 8, 8)
        a = self.a.float().repeat_interleave(2, dim=1)
        return (q * a[..., None] - self.b.float()[..., None]).reshape(n, k)


class TernaryWeight(IntWeight):
    """TQ1_0, TQ2_0: crumb codes 0..2 (the value + 1) in the crumb plane,
    one fp16 scale a 32-group, the superblock's d repeated (K4 and K5 take
    both through one form)."""

    GROUP: ClassVar[int] = 32
    PLANES: ClassVar[dict] = {"qs": (torch.uint8, 4), "a": (torch.float16, 32)}

    def int_codes(self) -> torch.Tensor:
        return crumb_codes(self.qs, *self.shape).to(torch.int16) - 1

    def group_scale(self) -> torch.Tensor:
        return self.a.float()

    @staticmethod
    def from_codes(codes: np.ndarray, d: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        """codes uint8 [N * K/256, 256] and d fp16 [N * K/256, 1] -> the planes."""
        return {"qs": pack_crumbs(codes.reshape(n, k)),
                "a": np.ascontiguousarray(np.repeat(d.reshape(n, k // QK_K), 8, axis=1))}


@dataclass
class TQ10Weight(TernaryWeight):
    """A TQ1_0 weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.TQ1_0

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        codes = qb.tq1_0_codes(np.ascontiguousarray(b[:, :48]), np.ascontiguousarray(b[:, 48:52]))
        return TernaryWeight.from_codes(codes, np.ascontiguousarray(b[:, 52:54]).view("<f2"),
                                         n, k)


@dataclass
class TQ20Weight(TernaryWeight):
    """A TQ2_0 weight in the layout above."""

    shape: tuple[int, int]
    qs: torch.Tensor
    a: torch.Tensor
    fmt: ClassVar[GGMLType] = GGMLType.TQ2_0

    @staticmethod
    def from_gguf(b: np.ndarray, n: int, k: int) -> dict[str, np.ndarray]:
        codes = qb.tq2_0_codes(np.ascontiguousarray(b[:, :64]))
        return TernaryWeight.from_codes(codes, np.ascontiguousarray(b[:, 64:66]).view("<f2"),
                                         n, k)


WEIGHT_CLASSES: dict[GGMLType, type[QWeight]] = {
    cls.fmt: cls for cls in (Q4KWeight, Q40Weight, Q41Weight, Q50Weight, Q51Weight, Q5KWeight,
                             Q6KWeight, Q80Weight, Q2KWeight, Q3KWeight, IQ4NLWeight, IQ4XSWeight,
                             MXFP4Weight, IQ2XXSWeight, IQ2XSWeight, IQ2SWeight, IQ3XXSWeight,
                             IQ3SWeight, IQ1SWeight, IQ1MWeight, TQ10Weight, TQ20Weight)}


def _weight_class(fmt) -> type[QWeight]:
    cls = WEIGHT_CLASSES.get(GGMLType(fmt))
    if cls is None:
        raise NotImplementedError(f"zllm_torch keeps {', '.join(f.name for f in WEIGHT_CLASSES)} "
                                  f"quantized, not {GGMLType(fmt).name}")
    return cls


def from_planes(planes: dict[str, np.ndarray], shape: tuple[int, int], fmt, device) -> QWeight:
    """numpy (or torch) planes -> the format's QWeight on `device` (fp16
    planes as torch.float16)."""
    cls = _weight_class(fmt)

    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device).contiguous()
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
    blk = GGML_BLOCK_SIZES[cls.fmt][0]
    if k % blk:
        raise ValueError(f"{cls.fmt.name} row of {k} is not a multiple of {blk}")
    if issubclass(cls, Q5Weight) and k % 64:  # the qh plane's order is by 64-chunks
        raise ValueError(f"{cls.fmt.name} row of {k} is not a multiple of 64")
    b = np.ascontiguousarray(raw).reshape(-1, GGML_BLOCK_SIZES[cls.fmt][1])
    if issubclass(cls, IQWeight):  # folded in torch on the device
        planes = cls.from_blocks(torch.from_numpy(b.copy()).to(device), n, k)
    else:
        planes = cls.from_gguf(b, n, k)
    return from_planes(planes, (k, n), cls.fmt, device)


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


class QWeightE:
    """A stacked mixture-of-experts weight of logical shape (E, K, N), kept
    quantized (zllm's `QTensorE`, `zllm/quant/repack.py`): the planes of
    one format's `QWeight` with a leading expert axis, [E, N, K / kdiv],
    expert e's rows as the GGUF's [E, N, row_bytes] has them.  `expert(e)`
    is that format's QWeight over the views plane[e]: each is contiguous,
    so the matmul kernels read an expert's planes in place, with no copy."""

    def __init__(self, fmt, shape: tuple[int, int, int], planes: dict[str, torch.Tensor]):
        self.fmt = GGMLType(fmt)
        self.shape = tuple(shape)
        self.planes = planes
        self._experts: list[QWeight] | None = None
        cls, (e, k, n) = _weight_class(self.fmt), self.shape
        for name, (dtype, kdiv) in cls.PLANES.items():
            p = planes[name]
            if p.dtype != dtype or tuple(p.shape) != (e, n, k // kdiv) or not p.is_contiguous():
                raise ValueError(f"{self.fmt.name} expert plane {name}: {p.dtype} "
                                 f"{tuple(p.shape)}, want contiguous {dtype} {(e, n, k // kdiv)}")

    @property
    def device(self) -> torch.device:
        return next(iter(self.planes.values())).device

    @property
    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.planes.values())

    def expert(self, e: int) -> QWeight:
        """Expert e as a (K, N) QWeight of views into the stack's planes."""
        if self._experts is None:
            cls, k, n = _weight_class(self.fmt), self.shape[1], self.shape[2]
            self._experts = [cls((k, n), **{name: p[i] for name, p in self.planes.items()})
                             for i in range(self.shape[0])]
        return self._experts[e]

    def dequant_gather(self, idx, dtype=torch.float32) -> torch.Tensor:
        """The dense [..., K, N] weights of the experts idx [...] (zllm's
        `QTensorE.dequant_gather`)."""
        idx = torch.as_tensor(idx)
        flat = [self.expert(int(e)).dequant(dtype) for e in idx.reshape(-1).tolist()]
        k, n = self.shape[1:]
        if not flat:
            return torch.empty((*idx.shape, k, n), dtype=dtype, device=self.device)
        return torch.stack(flat).reshape(*idx.shape, k, n)

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """The dense [E, K, N] stack (zllm's `QTensorE.dequant`)."""
        return self.dequant_gather(torch.arange(self.shape[0]), dtype)


def repack_experts(raw: np.ndarray, gguf_shape: tuple[int, int, int], fmt: GGMLType,
                   device) -> QWeightE:
    """GGUF expert rows uint8 [E, N, row_bytes] -> QWeightE: every row is
    repacked on its own, so the whole stack goes through `repack` as E * N
    rows at once and its planes are cut into [E, N, ...]."""
    e, n, k = gguf_shape
    w = repack(np.ascontiguousarray(raw).reshape(e * n, -1), (e * n, k), fmt, device)
    return QWeightE(w.fmt, (e, k, n), {name: p.reshape(e, n, *p.shape[1:])
                                       for name, p in w.planes().items()})


def concat_experts(ws: list[QWeightE]) -> QWeightE:
    """Concatenate expert stacks of one format and K along N (gate|up ->
    gateup): each expert's rows of ws[0], then of ws[1], ..."""
    e, k = ws[0].shape[:2]
    if any(w.fmt != ws[0].fmt or w.shape[:2] != (e, k) for w in ws):
        raise ValueError("concat_experts needs one format, E and K")
    planes = {name: torch.cat([w.planes[name] for w in ws], dim=1).contiguous()
              for name in ws[0].planes}
    return QWeightE(ws[0].fmt, (e, k, sum(w.shape[2] for w in ws)), planes)
