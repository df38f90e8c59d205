"""Blockwise quantization codecs (numpy, host-side): the subset the port's
llama path needs.

A copy of `zllm.quant.blocks` restricted to F32/F16/BF16 and the Q4_0,
Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K, IQ4_NL, IQ4_XS,
MXFP4, TQ1_0 and TQ2_0 decoders and encoders, with zllm's
importance-weighted encoders (the K and legacy formats' weighted
least-squares scale searches, TQ1_0's weighted scale search), and the
IQ grid formats (IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, IQ1_M;
their grids, format constants, in `iq_grids.npz` beside this file):
decoded here, encoded by the grid fit of `iq_encode.py`, which runs on a
torch device (layouts: reference ggml/src/ggml-common.h; reference
kernels: ggml/src/ggml-quants.c).  Without the F64 and I8-I64 decoders.
The encoders' bytes are identical to `zllm`'s (the grid fit's up to the
near-ties its f32 products may order otherwise), so
`zllm_torch.testing.make_llama_gguf` and `zllm_torch.quantize` write the
same files.

All functions operate on `blocks: uint8[N, type_size] -> f32[N, block_size]`
(decode) and the reverse (encode).  Use `dequantize`/`quantize` for whole
tensors with arbitrary leading shape.
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import numpy as np

from ..gguf.constants import GGML_BLOCK_SIZES, QK_K, GGMLType

__all__ = ["GGML_BLOCK_SIZES", "IQ4NL_VALUES", "MXFP4_VALUES", "dequantize", "e8m0_half_to_f32",
           "quantize", "supported_decode", "supported_encode", "unpack_kscales"]


def _f16(b: np.ndarray) -> np.ndarray:
    """fp16 bytes -> f32 column vector."""
    return b.view("<f2").astype(np.float32)


def _to_f16_bytes(x: np.ndarray) -> np.ndarray:
    return x.astype("<f2").view(np.uint8)


def _nib_lo_hi(qs: np.ndarray, pair: int) -> np.ndarray:
    """Unpack ggml nibble pairing: within each run of `pair` bytes, low
    nibbles are elements [0, pair), high nibbles are elements [pair, 2*pair).
    qs: uint8[N, B] with B % pair == 0 -> uint8[N, 2*B] element-ordered."""
    n = qs.shape[0]
    g = qs.reshape(n, -1, pair)
    lo = g & np.uint8(0x0F)
    hi = g >> np.uint8(4)
    return np.stack([lo, hi], axis=2).reshape(n, -1)


def _nib_pack(q: np.ndarray, pair: int) -> np.ndarray:
    """Inverse of _nib_lo_hi: element-ordered 4-bit values -> packed bytes."""
    n = q.shape[0]
    g = q.reshape(n, -1, 2, pair).astype(np.uint8)
    return (g[:, :, 0, :] | (g[:, :, 1, :] << np.uint8(4))).reshape(n, -1)


def _bits_unpack(b: np.ndarray, nbits: int, stride: int) -> np.ndarray:
    """Unpack `nbits`-wide fields: element (k*stride + j) lives in byte j at
    bit position k*nbits.  b: uint8[N, stride] -> uint8[N, (8//nbits)*stride]."""
    n = b.shape[0]
    per = 8 // nbits
    shifts = (np.arange(per, dtype=np.uint8) * nbits).reshape(1, per, 1)
    vals = (b.reshape(n, 1, stride) >> shifts) & np.uint8((1 << nbits) - 1)
    return vals.reshape(n, per * stride)


def _bits_pack(q: np.ndarray, nbits: int, stride: int) -> np.ndarray:
    """Inverse of _bits_unpack."""
    n = q.shape[0]
    per = 8 // nbits
    g = q.reshape(n, per, stride).astype(np.uint8)
    shifts = (np.arange(per, dtype=np.uint8) * nbits).reshape(1, per, 1)
    return np.bitwise_or.reduce(g << shifts, axis=1)


def _round_away(x: np.ndarray) -> np.ndarray:
    """Round half away from zero (C roundf), unlike numpy's banker rounding."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def _signed_absmax(x: np.ndarray) -> np.ndarray:
    """Per-row value with the largest magnitude, sign preserved -> [N,1]."""
    idx = np.abs(x).argmax(axis=-1, keepdims=True)
    return np.take_along_axis(x, idx, axis=-1)


def _safe_inv(d: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(d != 0, 1.0 / d, 0.0)


def unpack_kscales(sb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Q4_K 12-byte packed 6-bit (scale, min) x 8 -> two uint8[N, 8]."""
    n = sb.shape[0]
    a, b, c = sb[:, 0:4], sb[:, 4:8], sb[:, 8:12]
    sc = np.concatenate([a & 0x3F, (c & 0x0F) | ((a >> 6) << 4)], axis=1)
    mn = np.concatenate([b & 0x3F, (c >> 4) | ((b >> 6) << 4)], axis=1)
    return sc.reshape(n, 8), mn.reshape(n, 8)


def _pack_kscales(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of unpack_kscales."""
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    a = (sc[:, :4] & 0x3F) | ((sc[:, 4:] >> 4) << 6)
    b = (mn[:, :4] & 0x3F) | ((mn[:, 4:] >> 4) << 6)
    c = (sc[:, 4:] & 0x0F) | ((mn[:, 4:] & 0x0F) << 4)
    return np.concatenate([a, b, c], axis=1)


def _dec_f32(b):
    return b.view("<f4").astype(np.float32)


def _dec_f16(b):
    return _f16(b)


def _enc_f16(x):
    return _to_f16_bytes(x)


def _dec_f64(b):
    return b.view("<f8").astype(np.float32)


def _dec_bf16(b):
    return (b.view("<u2").astype(np.uint32) << 16).view(np.float32)


def _enc_bf16(x):
    u = x.astype(np.float32).view(np.uint32)
    # quiet NaNs, then round-to-nearest-even into the top 16 bits
    u = np.where((u & 0x7FFFFFFF) > 0x7F800000,
                 (u & np.uint32(0xFFFF0000)) | np.uint32(0x00400000), u)
    u = ((u.astype(np.uint64) + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    return u.view(np.uint8)


def _dec_int(dt: str) -> Callable[[np.ndarray], np.ndarray]:
    return lambda b: b.view(dt).astype(np.float32)


def _dec_q8_0(b):
    d, qs = b[:, :2], b[:, 2:]
    return _f16(d) * qs.view(np.int8).astype(np.float32)


def _enc_q8_0(x):
    d = np.abs(x).max(axis=-1, keepdims=True) / 127.0
    q = _round_away(x * _safe_inv(d)).astype(np.int8)
    return np.concatenate([_to_f16_bytes(d), q.view(np.uint8)], axis=1)


def _dec_q4_0(b):
    d, qs = b[:, :2], b[:, 2:]
    q = _nib_lo_hi(qs, 16).astype(np.int8) - np.int8(8)
    return _f16(d) * q.astype(np.float32)


def _enc_q4_0(x):
    d = _signed_absmax(x) / -8.0
    q = np.trunc(x * _safe_inv(d) + 8.5).clip(0, 15).astype(np.uint8)
    return np.concatenate([_to_f16_bytes(d), _nib_pack(q, 16)], axis=1)


def _dec_q4_1(b):
    d, m, qs = b[:, :2], b[:, 2:4], b[:, 4:]
    q = _nib_lo_hi(qs, 16).astype(np.float32)
    return _f16(d) * q + _f16(m)


def _enc_q4_1(x):
    mx = x.max(axis=-1, keepdims=True)
    mn = x.min(axis=-1, keepdims=True)
    d = (mx - mn) / 15.0
    q = np.trunc((x - mn) * _safe_inv(d) + 0.5).clip(0, 15).astype(np.uint8)
    return np.concatenate([_to_f16_bytes(d), _to_f16_bytes(mn), _nib_pack(q, 16)], axis=1)


def _qh_bits32(qh_bytes: np.ndarray) -> np.ndarray:
    """Q5_0/Q5_1: the 32 high bits of a block from its 4 bytes (bit j ->
    code j) -> uint8[N, 32]."""
    return np.unpackbits(qh_bytes.reshape(qh_bytes.shape[0], 4), axis=-1, bitorder="little")


def _qh_pack32(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")


def _dec_q5_0(b):
    d, qh, qs = b[:, :2], b[:, 2:6], b[:, 6:]
    q = (_nib_lo_hi(qs, 16) | (_qh_bits32(qh) << np.uint8(4))).astype(np.int8) - np.int8(16)
    return _f16(d) * q.astype(np.float32)


def _enc_q5_0(x):
    d = _signed_absmax(x) / -16.0
    q = np.trunc(x * _safe_inv(d) + 16.5).clip(0, 31).astype(np.uint8)
    return np.concatenate([_to_f16_bytes(d), _qh_pack32(q >> 4), _nib_pack(q & np.uint8(0x0F), 16)],
                          axis=1)


def _dec_q5_1(b):
    d, m, qh, qs = b[:, :2], b[:, 2:4], b[:, 4:8], b[:, 8:]
    q = (_nib_lo_hi(qs, 16) | (_qh_bits32(qh) << np.uint8(4))).astype(np.float32)
    return _f16(d) * q + _f16(m)


def _enc_q5_1(x):
    mx = x.max(axis=-1, keepdims=True)
    mn = x.min(axis=-1, keepdims=True)
    d = (mx - mn) / 31.0
    q = np.trunc((x - mn) * _safe_inv(d) + 0.5).clip(0, 31).astype(np.uint8)
    return np.concatenate([_to_f16_bytes(d), _to_f16_bytes(mn), _qh_pack32(q >> 4),
                           _nib_pack(q & np.uint8(0x0F), 16)], axis=1)


# MXFP4 (OCP microscaling e2m1 with a shared E8M0 scale): the e2m1
# magnitudes doubled to integers; index = the 4-bit code (bit 3 = sign)
MXFP4_VALUES = np.array([0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12], dtype=np.int8)


def e8m0_half_to_f32(e: np.ndarray) -> np.ndarray:
    """2**(e-127)/2 as float32 bits, denormal-safe (ggml_e8m0_to_fp32_half)."""
    e = e.astype(np.uint32)
    bits = np.where(e < 2, np.uint32(0x00200000) << e, (e - 1) << np.uint32(23))
    return bits.view(np.float32)


def _dec_mxfp4(b):
    e, qs = b[:, :1], b[:, 1:]
    d = e8m0_half_to_f32(e)
    idx = _nib_lo_hi(qs, 16)
    return d * MXFP4_VALUES[idx].astype(np.float32)


def _enc_mxfp4(x):
    amax = np.abs(x).max(axis=-1, keepdims=True)
    with np.errstate(divide="ignore"):
        e = np.where(amax > 0, np.floor(np.log2(amax)) - 2 + 127, 0).astype(np.uint8)
    d = e8m0_half_to_f32(e)
    err = np.abs(d[:, :, None] * MXFP4_VALUES.astype(np.float32)[None, None, :] - x[:, :, None])
    idx = err.argmin(axis=-1).astype(np.uint8)
    return np.concatenate([e, _nib_pack(idx, 16)], axis=1)


def _dec_q2_k(b):
    n = b.shape[0]
    scales, qs, d, dmin = b[:, :16], b[:, 16:80], b[:, 80:82], b[:, 82:84]
    dl = _f16(d) * (scales & 0x0F).astype(np.float32)  # [N,16]
    ml = _f16(dmin) * (scales >> 4).astype(np.float32)
    q = np.concatenate(
        [_bits_unpack(qs[:, c * 32 : (c + 1) * 32], 2, 32) for c in range(2)], axis=1
    ).reshape(n, 16, 16)
    return (dl[:, :, None] * q.astype(np.float32) - ml[:, :, None]).reshape(n, QK_K)


def _enc_q2_k(x):
    n = x.shape[0]
    g = x.reshape(n, 16, 16)
    m_f = np.maximum(0.0, -g.min(axis=-1))  # [N,16]
    s_f = np.maximum(0.0, (g.max(axis=-1) + m_f)) / 3.0
    d = s_f.max(axis=-1, keepdims=True) / 15.0
    dmin = m_f.max(axis=-1, keepdims=True) / 15.0
    sc = _round_away(s_f * _safe_inv(d)).clip(0, 15).astype(np.uint8)
    mn = _round_away(m_f * _safe_inv(dmin)).clip(0, 15).astype(np.uint8)
    dl = d * sc.astype(np.float32)
    ml = dmin * mn.astype(np.float32)
    q = _round_away((g + ml[:, :, None]) * _safe_inv(dl)[:, :, None]).clip(0, 3)
    q = q.reshape(n, QK_K).astype(np.uint8)
    qs = np.concatenate([_bits_pack(q[:, c * 128 : (c + 1) * 128], 2, 32) for c in range(2)],
                        axis=1)
    scales = sc | (mn << np.uint8(4))
    return np.concatenate([scales, qs, _to_f16_bytes(d), _to_f16_bytes(dmin)], axis=1)


def q3k_scales(sb: np.ndarray) -> np.ndarray:
    """Q3_K's 12 scale bytes -> int8 [N, 16], the 6-bit scales less 32
    (low nibbles in bytes 0-7, the top 2 bits in bytes 8-11)."""
    lo = np.concatenate([sb[:, :8] & 0x0F, sb[:, :8] >> 4], axis=1)  # [N,16]
    hi = _bits_unpack(sb[:, 8:12], 2, 4)  # [N,16] order 4s+i
    return (lo | (hi << np.uint8(4))).astype(np.int8) - np.int8(32)


def _dec_q3_k(b):
    n = b.shape[0]
    hmask, qs, sb, d = b[:, :32], b[:, 32:96], b[:, 96:108], b[:, 108:110]
    dl = _f16(d) * q3k_scales(sb).astype(np.float32)  # [N,16]
    ql = np.concatenate(
        [_bits_unpack(qs[:, c * 32 : (c + 1) * 32], 2, 32) for c in range(2)], axis=1
    ).astype(np.int8)
    hb = _bits_unpack(hmask, 1, 32)  # element (32b + j) from byte j bit b
    q = ql - np.where(hb == 0, np.int8(4), np.int8(0))
    return (dl[:, :, None] * q.reshape(n, 16, 16).astype(np.float32)).reshape(n, QK_K)


def _enc_q3_k(x):
    n = x.shape[0]
    g = x.reshape(n, 16, 16)
    s_f = _signed_absmax(g.reshape(-1, 16)).reshape(n, 16) / -4.0
    d = np.abs(s_f).max(axis=-1, keepdims=True) / 31.0
    sc = _round_away(s_f * _safe_inv(d)).clip(-32, 31).astype(np.int8)
    dl = d * sc.astype(np.float32)
    q = _round_away(g * _safe_inv(dl)[:, :, None]).clip(-4, 3).astype(np.int8).reshape(n, QK_K)
    hbit = (q >= 0).astype(np.uint8)  # 1 -> no -4 offset
    ql = np.where(q >= 0, q, q + 4).astype(np.uint8)
    qs = np.concatenate([_bits_pack(ql[:, c * 128 : (c + 1) * 128], 2, 32) for c in range(2)],
                        axis=1)
    hmask = _bits_pack(hbit, 1, 32)
    s6 = (sc.astype(np.int16) + 32).astype(np.uint8)
    lo_bytes = (s6[:, :8] & 0x0F) | ((s6[:, 8:] & 0x0F) << 4)
    hi_bytes = _bits_pack(s6 >> 4, 2, 4)
    return np.concatenate([hmask, qs, lo_bytes, hi_bytes, _to_f16_bytes(d)], axis=1)


def _dec_q4_k(b):
    n = b.shape[0]
    d, dmin, sb, qs = b[:, :2], b[:, 2:4], b[:, 4:16], b[:, 16:]
    sc, mn = unpack_kscales(sb)
    dl = _f16(d) * sc.astype(np.float32)  # [N,8]
    ml = _f16(dmin) * mn.astype(np.float32)
    q = _nib_lo_hi(qs, 32).reshape(n, 8, 32)  # 64-element chunks: lo 0-31, hi 32-63
    return (dl[:, :, None] * q.astype(np.float32) - ml[:, :, None]).reshape(n, QK_K)


def _kscale_search(x: np.ndarray, qmax: int) -> tuple[np.ndarray, ...]:
    """Two-level (scale, min) search shared by Q4_K/Q5_K: 8 groups of 32
    per superblock."""
    n = x.shape[0]
    g = x.reshape(n, 8, 32)
    m_f = np.maximum(0.0, -g.min(axis=-1))  # [N,8]
    s_f = np.maximum(0.0, g.max(axis=-1) + m_f) / qmax
    d = s_f.max(axis=-1, keepdims=True) / 63.0
    dmin = m_f.max(axis=-1, keepdims=True) / 63.0
    sc = _round_away(s_f * _safe_inv(d)).clip(0, 63).astype(np.uint8)
    mn = _round_away(m_f * _safe_inv(dmin)).clip(0, 63).astype(np.uint8)
    dl = d * sc.astype(np.float32)
    ml = dmin * mn.astype(np.float32)
    q = _round_away((g + ml[:, :, None]) * _safe_inv(dl)[:, :, None]).clip(0, qmax)
    return d, dmin, sc, mn, q.reshape(n, QK_K).astype(np.uint8)


def _enc_q4_k(x):
    d, dmin, sc, mn, q = _kscale_search(x, 15)
    return np.concatenate(
        [_to_f16_bytes(d), _to_f16_bytes(dmin), _pack_kscales(sc, mn), _nib_pack(q, 32)], axis=1
    )


def _dec_q5_k(b):
    n = b.shape[0]
    d, dmin, sb, qh, qs = b[:, :2], b[:, 2:4], b[:, 4:16], b[:, 16:48], b[:, 48:]
    sc, mn = unpack_kscales(sb)
    dl = _f16(d) * sc.astype(np.float32)
    ml = _f16(dmin) * mn.astype(np.float32)
    hi = _bits_unpack(qh, 1, 32)  # code 32j + l from bit j of byte l
    q = (_nib_lo_hi(qs, 32) | (hi << np.uint8(4))).reshape(n, 8, 32)
    return (dl[:, :, None] * q.astype(np.float32) - ml[:, :, None]).reshape(n, QK_K)


def _enc_q5_k(x):
    d, dmin, sc, mn, q = _kscale_search(x, 31)
    return np.concatenate([_to_f16_bytes(d), _to_f16_bytes(dmin), _pack_kscales(sc, mn),
                           _bits_pack(q >> 4, 1, 32), _nib_pack(q & np.uint8(0x0F), 32)], axis=1)


def _dec_q6_k(b):
    n = b.shape[0]
    ql, qh, sb, d = b[:, :128], b[:, 128:192], b[:, 192:208], b[:, 208:210]
    scales = sb.view(np.int8).astype(np.float32)  # [N,16]
    dl = _f16(d) * scales
    lo = np.concatenate([_nib_lo_hi(ql[:, c * 64 : (c + 1) * 64], 64) for c in range(2)],
                        axis=1)
    hi = np.concatenate([_bits_unpack(qh[:, c * 32 : (c + 1) * 32], 2, 32) for c in range(2)],
                        axis=1)
    q = (lo | (hi << np.uint8(4))).astype(np.int8) - np.int8(32)
    return (dl[:, :, None] * q.reshape(n, 16, 16).astype(np.float32)).reshape(n, QK_K)


def _enc_q6_k(x):
    n = x.shape[0]
    g = x.reshape(n, 16, 16)
    s_f = _signed_absmax(g.reshape(-1, 16)).reshape(n, 16) / -32.0
    d = np.abs(s_f).max(axis=-1, keepdims=True) / 127.0
    sc = _round_away(s_f * _safe_inv(d)).clip(-128, 127).astype(np.int8)
    dl = d * sc.astype(np.float32)
    q = _round_away(g * _safe_inv(dl)[:, :, None]).clip(-32, 31).astype(np.int8)
    qb = (q.reshape(n, QK_K).astype(np.int16) + 32).astype(np.uint8)
    ql = np.concatenate([_nib_pack(qb[:, c * 128 : (c + 1) * 128] & 0x0F, 64)
                         for c in range(2)], axis=1)
    qh = np.concatenate([_bits_pack(qb[:, c * 128 : (c + 1) * 128] >> 4, 2, 32)
                         for c in range(2)], axis=1)
    return np.concatenate([ql, qh, sc.view(np.uint8), _to_f16_bytes(d)], axis=1)


# IQ4 (non-linear 4-bit codebook)
IQ4NL_VALUES = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113], dtype=np.int8
)


def _iq4_nearest(scaled: np.ndarray) -> np.ndarray:
    """Nearest IQ4 codebook index for already-scaled values."""
    err = np.abs(scaled[..., None] - IQ4NL_VALUES.astype(np.float32))
    return err.argmin(axis=-1).astype(np.uint8)


def _dec_iq4_nl(b):
    d, qs = b[:, :2], b[:, 2:]
    idx = _nib_lo_hi(qs, 16)
    return _f16(d) * IQ4NL_VALUES[idx].astype(np.float32)


def _enc_iq4_nl(x):
    d = _signed_absmax(x) / -127.0
    idx = _iq4_nearest(x * _safe_inv(d))
    return np.concatenate([_to_f16_bytes(d), _nib_pack(idx, 16)], axis=1)


def iq4xs_scales(sh: np.ndarray, sl: np.ndarray) -> np.ndarray:
    """IQ4_XS's scale bytes (2 of high bits, 4 of low nibbles) -> int8
    [N, 8], the 6-bit scales less 32."""
    n = sl.shape[0]
    lo = _nib_lo_hi(sl, 1).reshape(n, 8)  # byte i -> groups 2i, 2i+1
    # group g's top 2 bits live at bit 2g of the little-endian u16
    sh16 = np.ascontiguousarray(sh).view("<u2").astype(np.uint32)
    hi = np.stack([(sh16[:, 0] >> (2 * g)) & 3 for g in range(8)], axis=1).astype(np.uint8)
    return (lo | (hi << np.uint8(4))).astype(np.int8) - np.int8(32)


def _dec_iq4_xs(b):
    n = b.shape[0]
    d, sh, sl, qs = b[:, :2], b[:, 2:4], b[:, 4:8], b[:, 8:]
    dl = _f16(d) * iq4xs_scales(sh, sl).astype(np.float32)  # [N,8]
    idx = _nib_lo_hi(qs, 16).reshape(n, 8, 32)
    q = IQ4NL_VALUES[idx].astype(np.float32)
    return (dl[:, :, None] * q).reshape(n, QK_K)


def _enc_iq4_xs(x):
    n = x.shape[0]
    g = x.reshape(n, 8, 32)
    s_f = _signed_absmax(g.reshape(-1, 32)).reshape(n, 8) / -127.0
    d = np.abs(s_f).max(axis=-1, keepdims=True) / 31.0
    sc = _round_away(s_f * _safe_inv(d)).clip(-32, 31).astype(np.int8)
    dl = d * sc.astype(np.float32)
    idx = _iq4_nearest(g * _safe_inv(dl)[:, :, None]).reshape(n, QK_K)
    s6 = (sc.astype(np.int16) + 32).astype(np.uint8)
    sl = (s6[:, 0::2] & 0x0F) | ((s6[:, 1::2] & 0x0F) << 4)
    sh16 = np.zeros((n,), dtype=np.uint16)
    for gi in range(8):
        sh16 |= ((s6[:, gi] >> 4).astype(np.uint16)) << (2 * gi)
    return np.concatenate(
        [_to_f16_bytes(d), sh16.astype("<u2").view(np.uint8).reshape(n, 2), sl, _nib_pack(idx, 16)],
        axis=1,
    )


# IQ grid formats (decode only).  Each 8 (IQ3: 4) weights are one row of a
# grid of non-negative magnitudes (IQ1: of {-1, 0, 1}), picked by an index,
# times a sign, times a group scale.

# 7-bit sign codes: bit i = sign of element i, top bit = parity (format
# constant ksigns_iq2xs from ggml-common.h)
_KSIGNS = np.array([i | (128 if bin(i).count("1") % 2 else 0) for i in range(128)], dtype=np.uint8)


@functools.lru_cache(maxsize=1)
def iq_grids() -> dict[str, np.ndarray]:
    """The seven grids (ggml-common.h iq2xxs_grid ... iq1m grid), f32:
    iq2_xxs [256, 8], iq2_xs [512, 8], iq2_s [1024, 8], iq3_xxs [256, 4],
    iq3_s [512, 4], iq1_s and iq1_m [2048, 8]."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "iq_grids.npz")
    with np.load(path) as z:
        return {name: z[name] for name in z.files}


def _sign_bits(codes: np.ndarray) -> np.ndarray:
    """7-bit sign codes [...] -> +-1 f32 [..., 8]."""
    return _raw_sign_bits(_KSIGNS[codes & 0x7F])


def _raw_sign_bits(bytes_: np.ndarray) -> np.ndarray:
    """Sign bytes [...] (bit i set: element i negative) -> +-1 f32 [..., 8]."""
    bits = (bytes_[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    return np.where(bits == 0, np.float32(1), np.float32(-1))


def _u32(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view("<u4")


def _dec_iq2_xxs(b):
    n = b.shape[0]
    d = _f16(b[:, :2])
    u32 = _u32(b[:, 2:]).reshape(n, 8, 2)
    codes = np.ascontiguousarray(u32[:, :, 0]).view(np.uint8).reshape(n, 8, 4)  # grid rows
    aux = u32[:, :, 1]
    db = d * (0.5 + (aux >> 28).astype(np.float32)) * 0.25  # [n, 8]
    signs = _sign_bits((aux[:, :, None] >> np.array([0, 7, 14, 21], np.uint32)).astype(np.uint8))
    grid = iq_grids()["iq2_xxs_grid"][codes]  # [n, 8, 4, 8]
    return (db[:, :, None, None] * grid * signs).reshape(n, QK_K)


def _dec_iq2_xs(b):
    n = b.shape[0]
    d = _f16(b[:, :2])
    qs = np.ascontiguousarray(b[:, 2:66]).view("<u2").reshape(n, 32)
    sl = b[:, 66:74]
    sc = np.stack([sl & 0x0F, sl >> 4], axis=-1).reshape(n, 16)
    db = (d * (0.5 + sc.astype(np.float32)) * 0.25).repeat(2, axis=1)  # [n, 32]
    signs = _sign_bits((qs >> 9).astype(np.uint8))
    grid = iq_grids()["iq2_xs_grid"][qs & 511]  # [n, 32, 8]
    return (db[:, :, None] * grid * signs).reshape(n, QK_K)


def _dec_iq2_s(b):
    n = b.shape[0]
    d = _f16(b[:, :2])
    qs, sbytes, qh, sl = b[:, 2:34], b[:, 34:66], b[:, 66:74], b[:, 74:82]
    sc = np.stack([sl & 0x0F, sl >> 4], axis=-1).reshape(n, 16)
    db = (d * (0.5 + sc.astype(np.float32)) * 0.25).repeat(2, axis=1)  # [n, 32]
    hi = ((qh[:, :, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3).reshape(n, 32)
    idx = qs.astype(np.uint16) | (hi.astype(np.uint16) << 8)
    signs = _raw_sign_bits(sbytes).reshape(n, 32, 8)
    grid = iq_grids()["iq2_s_grid"][idx]
    return (db[:, :, None] * grid * signs).reshape(n, QK_K)


def _dec_iq3_xxs(b):
    n = b.shape[0]
    d = _f16(b[:, :2])
    qs = b[:, 2:66]  # 64 grid rows of 4 values
    aux = _u32(b[:, 66:98]).reshape(n, 8)
    db = d * (0.5 + (aux >> 28).astype(np.float32)) * 0.5  # [n, 8]
    signs = _sign_bits(
        (aux[:, :, None] >> np.array([0, 7, 14, 21], np.uint32)).astype(np.uint8)
    ).reshape(n, 32, 8)
    grid = iq_grids()["iq3_xxs_grid"][qs].reshape(n, 32, 8)
    return (db.repeat(4, axis=1)[:, :, None] * grid * signs).reshape(n, QK_K)


def _dec_iq3_s(b):
    n = b.shape[0]
    d = _f16(b[:, :2])
    qs, qh, sbytes, sl = b[:, 2:66], b[:, 66:74], b[:, 74:106], b[:, 106:110]
    sc = np.stack([sl & 0x0F, sl >> 4], axis=-1).reshape(n, 8)
    db = (d * (1 + 2 * sc.astype(np.float32))).repeat(8, axis=1)  # [n, 64]
    hi = ((qh[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1).reshape(n, 64)
    idx = qs.astype(np.uint16) | (hi.astype(np.uint16) << 8)
    signs = _raw_sign_bits(sbytes).reshape(n, 64, 4)
    grid = iq_grids()["iq3_s_grid"][idx].reshape(n, 64, 4)
    return (db[:, :, None] * grid * signs).reshape(n, QK_K)


def _dec_iq1_s(b):
    n = b.shape[0]
    d = _f16(b[:, :2])
    qs = b[:, 2:34]  # 32 grid rows' low bytes
    qh = np.ascontiguousarray(b[:, 34:50]).view("<u2").reshape(n, 8)  # 4 rows each
    dl = (d * (2 * ((qh >> 12) & 7) + 1).astype(np.float32)).repeat(4, axis=1)  # [n, 32]
    delta = np.where((qh & 0x8000) == 0, np.float32(0.125), np.float32(-0.125)).repeat(4, axis=1)
    hi = ((qh[:, :, None] >> np.array([0, 3, 6, 9], np.uint16)) & 7).reshape(n, 32)
    idx = qs.astype(np.uint16) | (hi << 8)
    grid = iq_grids()["iq1_s_grid"][idx]  # [n, 32, 8]
    return (dl[:, :, None] * (grid + delta[:, :, None])).reshape(n, QK_K)


def iq1m_d(sraw: np.ndarray) -> np.ndarray:
    """IQ1_M's superblock scale: the fp16 whose four nibbles are the top
    nibbles of the four u16 scale words sraw [N, 4] (word i's bits 12-15 ->
    bits 4i..4i+3) -> f32 [N]."""
    d16 = (sraw & np.uint16(0xF000)) >> np.array([12, 8, 4, 0], np.uint16)
    return (d16[:, 0] | d16[:, 1] | d16[:, 2] | d16[:, 3]).astype("<u2").view("<f2").astype(
        np.float32)


def _dec_iq1_m(b):
    n = b.shape[0]
    qs, qh = b[:, :32], b[:, 32:48]  # qh: 16 bytes, a nibble a grid row
    sraw = np.ascontiguousarray(b[:, 48:56]).view("<u2").reshape(n, 4)
    d = iq1m_d(sraw)
    sc = ((sraw[:, :, None] >> np.array([0, 3, 6, 9], np.uint16)) & 7).reshape(n, 16)
    dl = (d[:, None] * (2 * sc.astype(np.float32) + 1)).repeat(2, axis=1)  # [n, 32]
    hi = np.stack([qh & 0x0F, qh >> 4], axis=-1).reshape(n, 32)
    idx = qs.astype(np.uint16) | ((hi.astype(np.uint16) & 7) << 8)
    delta = np.where((hi & 0x08) == 0, np.float32(0.125), np.float32(-0.125))
    grid = iq_grids()["iq1_m_grid"][idx]
    return (dl[:, :, None] * (grid + delta[:, :, None])).reshape(n, QK_K)


def tq1_0_codes(qs: np.ndarray, qh: np.ndarray) -> np.ndarray:
    """TQ1_0's base-3 bytes (qs [N, 48], qh [N, 4]) -> uint8 [N, 256]
    codes 0..2 (the value plus 1) in element order.  Digit j of a byte is
    ((byte * 3^j mod 256) * 3) >> 8: the products stay uint8, wrapping
    as ggml's do."""
    n = qs.shape[0]
    m5 = np.array([1, 3, 9, 27, 81], dtype=np.uint8).reshape(1, 1, 5, 1)
    q0 = (qs[:, :32].reshape(n, 1, 1, 32) * m5).reshape(n, 160)
    q1 = (qs[:, 32:48].reshape(n, 1, 1, 16) * m5).reshape(n, 80)
    m4 = np.array([1, 3, 9, 27], dtype=np.uint8).reshape(1, 1, 4, 1)
    q2 = (qh.reshape(n, 1, 1, 4) * m4).reshape(n, 16)
    q = np.concatenate([q0, q1, q2], axis=1)
    return ((q.astype(np.uint16) * 3) >> 8).astype(np.uint8)


def tq2_0_codes(qs: np.ndarray) -> np.ndarray:
    """TQ2_0's 64 crumb bytes [N, 64] -> uint8 [N, 256] codes 0..2 in
    element order (byte j of half c holds element 128c + 32i + j in crumb
    i)."""
    return np.concatenate([_bits_unpack(qs[:, c * 32:(c + 1) * 32], 2, 32) for c in range(2)],
                          axis=1)


def _dec_tq1_0(b):
    q = tq1_0_codes(b[:, :48], b[:, 48:52]).astype(np.int8) - np.int8(1)
    return _f16(b[:, 52:54]) * q.astype(np.float32)


def _dec_tq2_0(b):
    q = tq2_0_codes(b[:, :64]).astype(np.int8) - np.int8(1)
    return _f16(b[:, 64:66]) * q.astype(np.float32)


def _enc_tq2_0(x):
    d = np.abs(x).max(axis=-1, keepdims=True)
    q = (_round_away(x * _safe_inv(d)).astype(np.int8) + 1).astype(np.uint8)
    qs = np.concatenate([_bits_pack(q[:, c * 128:(c + 1) * 128], 2, 32) for c in range(2)], axis=1)
    return np.concatenate([qs, _to_f16_bytes(d)], axis=1)


def _enc_tq1_0(x, w=None):
    n = x.shape[0]
    d = np.abs(x).max(axis=-1, keepdims=True)
    if w is not None:
        # weighted least-squares ternary scale (zllm's: the reference's
        # quantize_tq1_0 ignores quant_weights)
        wg = _wg(w, x.shape)
        for _ in range(3):
            q = _round_away(x * _safe_inv(d)).clip(-1, 1)
            num = (wg * x * q).sum(-1, keepdims=True)
            den = (wg * q * q).sum(-1, keepdims=True)
            d = np.where(den > 1e-12, num / np.maximum(den, 1e-12), d)
        d = np.abs(d)
    t = (_round_away(x * _safe_inv(d)).clip(-1, 1) + 1).astype(np.uint32)  # 0..2
    # fixed-point base-3 packing: byte = ceil(v * 256 / 3^k), whose digit j
    # tq1_0_codes recovers

    def pack(digits, k):  # digits [n, m, k], the most significant first
        p3 = 3 ** np.arange(k - 1, -1, -1, dtype=np.uint32)
        v = (digits * p3).sum(-1)
        return ((v * 256 + (3 ** k - 1)) // (3 ** k)).astype(np.uint8)

    # elements 0..159: byte i's digit j is element j*32 + i (5 digits);
    # 160..239: 16 bytes of 5 digits; 240..255: 4 bytes of 4 digits
    d0 = t[:, :160].reshape(n, 5, 32).transpose(0, 2, 1)
    d1 = t[:, 160:240].reshape(n, 5, 16).transpose(0, 2, 1)
    d2 = t[:, 240:256].reshape(n, 4, 4).transpose(0, 2, 1)
    qs = np.concatenate([pack(d0, 5), pack(d1, 5)], axis=1)  # [n, 48]
    return np.concatenate([qs, pack(d2, 4), _to_f16_bytes(d)], axis=1)


_DECODERS: dict[GGMLType, Callable[[np.ndarray], np.ndarray]] = {
    GGMLType.F32: _dec_f32,
    GGMLType.F16: _dec_f16,
    GGMLType.BF16: _dec_bf16,
    GGMLType.F64: _dec_f64,
    GGMLType.I8: _dec_int("<i1"),
    GGMLType.I16: _dec_int("<i2"),
    GGMLType.I32: _dec_int("<i4"),
    GGMLType.I64: _dec_int("<i8"),
    GGMLType.Q4_0: _dec_q4_0,
    GGMLType.Q4_1: _dec_q4_1,
    GGMLType.Q5_0: _dec_q5_0,
    GGMLType.Q5_1: _dec_q5_1,
    GGMLType.Q8_0: _dec_q8_0,
    GGMLType.MXFP4: _dec_mxfp4,
    GGMLType.Q2_K: _dec_q2_k,
    GGMLType.Q3_K: _dec_q3_k,
    GGMLType.Q4_K: _dec_q4_k,
    GGMLType.Q5_K: _dec_q5_k,
    GGMLType.Q6_K: _dec_q6_k,
    GGMLType.IQ4_NL: _dec_iq4_nl,
    GGMLType.IQ4_XS: _dec_iq4_xs,
    GGMLType.IQ2_XXS: _dec_iq2_xxs,
    GGMLType.IQ2_XS: _dec_iq2_xs,
    GGMLType.IQ2_S: _dec_iq2_s,
    GGMLType.IQ3_XXS: _dec_iq3_xxs,
    GGMLType.IQ3_S: _dec_iq3_s,
    GGMLType.IQ1_S: _dec_iq1_s,
    GGMLType.IQ1_M: _dec_iq1_m,
    GGMLType.TQ1_0: _dec_tq1_0,
    GGMLType.TQ2_0: _dec_tq2_0,
}
_ENCODERS: dict[GGMLType, Callable[[np.ndarray], np.ndarray]] = {
    GGMLType.F16: _enc_f16,
    GGMLType.BF16: _enc_bf16,
    GGMLType.Q4_0: _enc_q4_0,
    GGMLType.Q4_1: _enc_q4_1,
    GGMLType.Q5_0: _enc_q5_0,
    GGMLType.Q5_1: _enc_q5_1,
    GGMLType.Q8_0: _enc_q8_0,
    GGMLType.MXFP4: _enc_mxfp4,
    GGMLType.Q2_K: _enc_q2_k,
    GGMLType.Q3_K: _enc_q3_k,
    GGMLType.Q4_K: _enc_q4_k,
    GGMLType.Q5_K: _enc_q5_k,
    GGMLType.Q6_K: _enc_q6_k,
    GGMLType.IQ4_NL: _enc_iq4_nl,
    GGMLType.IQ4_XS: _enc_iq4_xs,
    GGMLType.TQ1_0: _enc_tq1_0,
    GGMLType.TQ2_0: _enc_tq2_0,
}


def supported_decode() -> set[GGMLType]:
    return set(_DECODERS)


def supported_encode() -> set[GGMLType]:
    return set(_ENCODERS) | _GRID_TYPES


def dequantize(data: np.ndarray, gtype: GGMLType) -> np.ndarray:
    """uint8[..., row_bytes] (or typed scalar array) -> f32[..., n_elements]."""
    gtype = GGMLType(gtype)
    if gtype not in _DECODERS:
        raise NotImplementedError(f"no decoder for {gtype.name} in zllm_torch")
    blk, bsz = GGML_BLOCK_SIZES[gtype]
    if data.dtype != np.uint8:
        data = np.ascontiguousarray(data).view(np.uint8)
    lead = data.shape[:-1]
    blocks = data.reshape(-1, bsz)
    out = _DECODERS[gtype](blocks)
    return np.ascontiguousarray(out, dtype=np.float32).reshape(*lead, -1)


def quantize(data: np.ndarray, gtype: GGMLType, weights: np.ndarray | None = None,
             device="cuda") -> np.ndarray:
    """f32[..., n] -> uint8[..., row_bytes].

    `weights` (importance-matrix column weights, broadcast against `data`:
    one per input column, or one per element) steers the scale search of
    the formats that take them (the K and legacy formats, TQ1_0 and the IQ
    grid formats) and is ignored by the others, as zllm routes them.  The
    IQ grid formats' fit runs on `device` (`iq_encode.py`: cuda unless the
    caller passes cpu; it raises without a card); every other format is
    encoded here on the host and never touches the device."""
    gtype = GGMLType(gtype)
    blk, bsz = GGML_BLOCK_SIZES[gtype]
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.shape[-1] % blk != 0:
        raise ValueError(f"last dim {data.shape[-1]} not divisible by {gtype.name} block {blk}")
    if gtype not in supported_encode():
        raise NotImplementedError(f"no encoder for {gtype.name} in zllm_torch")
    lead = data.shape[:-1]
    blocks = data.reshape(-1, blk)
    if gtype in _GRID_TYPES:
        from .iq_encode import encode

        out = encode(blocks, gtype, weights, device, data.shape)
    elif weights is not None and gtype in _WEIGHTED_ENCODERS:
        wcols = np.broadcast_to(np.asarray(weights, np.float32), data.shape).reshape(-1, blk)
        out = _WEIGHTED_ENCODERS[gtype](blocks, wcols)
    else:
        out = _ENCODERS[gtype](blocks)
    return np.ascontiguousarray(out, dtype=np.uint8).reshape(*lead, -1)


# -- importance-weighted encoders (zllm's; reference: quantize_<type>
# quant_weights paths in ggml-quants.c) ---------------------------------------

def _wls_affine(g: np.ndarray, wg: np.ndarray, qmax: int, iters: int = 4):
    """Weighted alternating least-squares for x ~= a*q - b per group (the
    reference's make_qkx2_quants/make_qkx3_quants imatrix search): fix the
    integer codes, refit (scale, min) by weighted LS, re-round, iterate.
    g/wg: [..., group]; returns (a, b) over the leading dims."""
    m_f = np.maximum(0.0, -g.min(axis=-1))
    s_f = np.maximum(0.0, g.max(axis=-1) + m_f) / qmax
    a, b = s_f, m_f
    for _ in range(iters):
        q = _round_away((g + b[..., None]) * _safe_inv(a)[..., None]).clip(0, qmax)
        sw = wg.sum(-1)
        swq = (wg * q).sum(-1)
        swq2 = (wg * q * q).sum(-1)
        swx = (wg * g).sum(-1)
        swxq = (wg * g * q).sum(-1)
        det = swq2 * sw - swq * swq
        safe = np.where(det > 1e-12, det, 1)
        new_a = np.where(det > 1e-12, (swxq * sw - swx * swq) / safe, a)
        new_b = np.where(det > 1e-12, -(swx * swq2 - swxq * swq) / safe, b)
        ok = (new_a > 0) & (new_b >= 0)
        a = np.where(ok, new_a, a)
        b = np.where(ok, new_b, b)
    return a, b


def _wls_sym(g: np.ndarray, wg: np.ndarray, qmin: int, qmax: int, iters: int = 4):
    """Weighted LS for symmetric x ~= d*q (reference make_qx_quants with
    quant_weights).  g/wg: [..., group]; returns d."""
    d = _signed_absmax(g.reshape(-1, g.shape[-1])).reshape(g.shape[:-1]) / qmin
    for _ in range(iters):
        q = _round_away(g * _safe_inv(d)[..., None]).clip(qmin, qmax)
        num = (wg * g * q).sum(-1)
        den = (wg * q * q).sum(-1)
        d = np.where(den > 1e-12, num / np.where(den > 1e-12, den, 1), d)
    return d


def _wg(w: np.ndarray, shape) -> np.ndarray:
    return np.maximum(w.reshape(shape), 1e-12)


def _kpack_affine(x, a, b, qmax):
    """Two-level 6-bit scale/min quantization + requantize (Q4_K/Q5_K)."""
    n = x.shape[0]
    g = x.reshape(n, 8, 32)
    d = a.max(axis=-1, keepdims=True) / 63.0
    dmin = b.max(axis=-1, keepdims=True) / 63.0
    sc = _round_away(a * _safe_inv(d)).clip(0, 63).astype(np.uint8)
    mn = _round_away(b * _safe_inv(dmin)).clip(0, 63).astype(np.uint8)
    dl = d * sc.astype(np.float32)
    ml = dmin * mn.astype(np.float32)
    q = _round_away((g + ml[:, :, None]) * _safe_inv(dl)[:, :, None]).clip(0, qmax)
    return d, dmin, sc, mn, q.reshape(n, QK_K).astype(np.uint8)


def _enc_q4_k_weighted(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    a, b = _wls_affine(x.reshape(n, 8, 32), _wg(w, (n, 8, 32)), 15)
    d, dmin, sc, mn, q = _kpack_affine(x, a, b, 15)
    return np.concatenate(
        [_to_f16_bytes(d), _to_f16_bytes(dmin), _pack_kscales(sc, mn), _nib_pack(q, 32)], axis=1
    )


def _enc_q5_k_weighted(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    a, b = _wls_affine(x.reshape(n, 8, 32), _wg(w, (n, 8, 32)), 31)
    d, dmin, sc, mn, q = _kpack_affine(x, a, b, 31)
    qs = _nib_pack(q & np.uint8(0x0F), 32)
    qh = _bits_pack(q >> 4, 1, 32)
    return np.concatenate(
        [_to_f16_bytes(d), _to_f16_bytes(dmin), _pack_kscales(sc, mn), qh, qs], axis=1
    )


def _enc_q2_k_weighted(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    g = x.reshape(n, 16, 16)
    a, b = _wls_affine(g, _wg(w, (n, 16, 16)), 3)
    d = a.max(axis=-1, keepdims=True) / 15.0
    dmin = b.max(axis=-1, keepdims=True) / 15.0
    sc = _round_away(a * _safe_inv(d)).clip(0, 15).astype(np.uint8)
    mn = _round_away(b * _safe_inv(dmin)).clip(0, 15).astype(np.uint8)
    dl = d * sc.astype(np.float32)
    ml = dmin * mn.astype(np.float32)
    q = _round_away((g + ml[:, :, None]) * _safe_inv(dl)[:, :, None]).clip(0, 3)
    q = q.reshape(n, QK_K).astype(np.uint8)
    qs = np.concatenate([_bits_pack(q[:, c * 128:(c + 1) * 128], 2, 32) for c in range(2)], axis=1)
    return np.concatenate([sc | (mn << np.uint8(4)), qs, _to_f16_bytes(d), _to_f16_bytes(dmin)],
                          axis=1)


def _enc_q6_k_weighted(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    g = x.reshape(n, 16, 16)
    s_f = _wls_sym(g, _wg(w, (n, 16, 16)), -32, 31)
    d = np.abs(s_f).max(axis=-1, keepdims=True) / 127.0
    sc = _round_away(s_f * _safe_inv(d)).clip(-128, 127).astype(np.int8)
    dl = d * sc.astype(np.float32)
    q = _round_away(g * _safe_inv(dl)[:, :, None]).clip(-32, 31).astype(np.int8)
    qb = (q.reshape(n, QK_K).astype(np.int16) + 32).astype(np.uint8)
    ql = np.concatenate([_nib_pack(qb[:, c * 128:(c + 1) * 128] & 0x0F, 64) for c in range(2)],
                        axis=1)
    qh = np.concatenate([_bits_pack(qb[:, c * 128:(c + 1) * 128] >> 4, 2, 32) for c in range(2)],
                        axis=1)
    return np.concatenate([ql, qh, sc.view(np.uint8), _to_f16_bytes(d)], axis=1)


def _enc_q3_k_weighted(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    g = x.reshape(n, 16, 16)
    s_f = _wls_sym(g, _wg(w, (n, 16, 16)), -4, 3)
    d = np.abs(s_f).max(axis=-1, keepdims=True) / 31.0
    sc = _round_away(s_f * _safe_inv(d)).clip(-32, 31).astype(np.int8)
    dl = d * sc.astype(np.float32)
    q = _round_away(g * _safe_inv(dl)[:, :, None]).clip(-4, 3).astype(np.int8).reshape(n, QK_K)
    hbit = (q >= 0).astype(np.uint8)
    ql = np.where(q >= 0, q, q + 4).astype(np.uint8)
    qs = np.concatenate([_bits_pack(ql[:, c * 128:(c + 1) * 128], 2, 32) for c in range(2)],
                        axis=1)
    hmask = _bits_pack(hbit, 1, 32)
    s6 = (sc.astype(np.int16) + 32).astype(np.uint8)
    lo_bytes = (s6[:, :8] & 0x0F) | ((s6[:, 8:] & 0x0F) << 4)
    hi_bytes = _bits_pack(s6 >> 4, 2, 4)
    return np.concatenate([hmask, qs, lo_bytes, hi_bytes, _to_f16_bytes(d)], axis=1)


def _enc_q4_0_weighted(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    d = _wls_sym(x, _wg(w, x.shape), -8, 7)[:, None]
    q = (_round_away(x * _safe_inv(d)).clip(-8, 7) + 8).astype(np.uint8)
    return np.concatenate([_to_f16_bytes(d), _nib_pack(q, 16)], axis=1)


def _enc_q5_0_weighted(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    d = _wls_sym(x, _wg(w, x.shape), -16, 15)[:, None]
    q = (_round_away(x * _safe_inv(d)).clip(-16, 15) + 16).astype(np.uint8)
    return np.concatenate([_to_f16_bytes(d), _qh_pack32(q >> 4), _nib_pack(q & np.uint8(0x0F), 16)],
                          axis=1)


def _enc_q4_1_weighted(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    a, b = _wls_affine(x, _wg(w, x.shape), 15)
    d, mn = a[:, None], -b[:, None]
    q = _round_away((x - mn) * _safe_inv(d)).clip(0, 15).astype(np.uint8)
    return np.concatenate([_to_f16_bytes(d), _to_f16_bytes(mn), _nib_pack(q, 16)], axis=1)


def _enc_q5_1_weighted(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    a, b = _wls_affine(x, _wg(w, x.shape), 31)
    d, mn = a[:, None], -b[:, None]
    q = _round_away((x - mn) * _safe_inv(d)).clip(0, 31).astype(np.uint8)
    return np.concatenate([_to_f16_bytes(d), _to_f16_bytes(mn), _qh_pack32(q >> 4),
                           _nib_pack(q & np.uint8(0x0F), 16)], axis=1)


_WEIGHTED_ENCODERS: dict[GGMLType, Callable[[np.ndarray, np.ndarray], np.ndarray]] = {
    GGMLType.Q4_K: _enc_q4_k_weighted,
    GGMLType.Q5_K: _enc_q5_k_weighted,
    GGMLType.Q2_K: _enc_q2_k_weighted,
    GGMLType.Q3_K: _enc_q3_k_weighted,
    GGMLType.Q6_K: _enc_q6_k_weighted,
    GGMLType.Q4_0: _enc_q4_0_weighted,
    GGMLType.Q5_0: _enc_q5_0_weighted,
    GGMLType.Q4_1: _enc_q4_1_weighted,
    GGMLType.Q5_1: _enc_q5_1_weighted,
    GGMLType.TQ1_0: _enc_tq1_0,
}
# the IQ grid formats, encoded weighted or not by iq_encode.encode on a
# torch device
_GRID_TYPES = frozenset({GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ3_XXS,
                         GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.IQ1_M})
