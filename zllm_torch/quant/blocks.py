"""Blockwise quantization codecs (numpy, host-side): the subset the port's
llama path needs.

A copy of `zllm.quant.blocks` restricted to F32/F16 and the Q4_K, Q6_K and
Q8_0 decoders and encoders (layouts: reference ggml/src/ggml-common.h;
reference kernels: ggml/src/ggml-quants.c).  The encoders' bytes are
identical to `zllm`'s, so `zllm_torch.testing.make_llama_gguf` and
`zllm_torch.quantize` write the same files.

All functions operate on `blocks: uint8[N, type_size] -> f32[N, block_size]`
(decode) and the reverse (encode).  Use `dequantize`/`quantize` for whole
tensors with arbitrary leading shape.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..gguf.constants import GGML_BLOCK_SIZES, QK_K, GGMLType

__all__ = ["GGML_BLOCK_SIZES", "dequantize", "quantize", "supported_decode", "supported_encode",
           "unpack_kscales"]


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


def _dec_q8_0(b):
    d, qs = b[:, :2], b[:, 2:]
    return _f16(d) * qs.view(np.int8).astype(np.float32)


def _enc_q8_0(x):
    d = np.abs(x).max(axis=-1, keepdims=True) / 127.0
    q = _round_away(x * _safe_inv(d)).astype(np.int8)
    return np.concatenate([_to_f16_bytes(d), q.view(np.uint8)], axis=1)


def _dec_q4_k(b):
    n = b.shape[0]
    d, dmin, sb, qs = b[:, :2], b[:, 2:4], b[:, 4:16], b[:, 16:]
    sc, mn = unpack_kscales(sb)
    dl = _f16(d) * sc.astype(np.float32)  # [N,8]
    ml = _f16(dmin) * mn.astype(np.float32)
    q = _nib_lo_hi(qs, 32).reshape(n, 8, 32)  # 64-element chunks: lo 0-31, hi 32-63
    return (dl[:, :, None] * q.astype(np.float32) - ml[:, :, None]).reshape(n, QK_K)


def _kscale_search(x: np.ndarray, qmax: int) -> tuple[np.ndarray, ...]:
    """Two-level (scale, min) search: 8 groups of 32 per superblock."""
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


_DECODERS: dict[GGMLType, Callable[[np.ndarray], np.ndarray]] = {
    GGMLType.F32: _dec_f32,
    GGMLType.F16: _dec_f16,
    GGMLType.Q8_0: _dec_q8_0,
    GGMLType.Q4_K: _dec_q4_k,
    GGMLType.Q6_K: _dec_q6_k,
}
_ENCODERS: dict[GGMLType, Callable[[np.ndarray], np.ndarray]] = {
    GGMLType.F16: _enc_f16,
    GGMLType.Q8_0: _enc_q8_0,
    GGMLType.Q4_K: _enc_q4_k,
    GGMLType.Q6_K: _enc_q6_k,
}


def supported_decode() -> set[GGMLType]:
    return set(_DECODERS)


def supported_encode() -> set[GGMLType]:
    return set(_ENCODERS)


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


def quantize(data: np.ndarray, gtype: GGMLType) -> np.ndarray:
    """f32[..., n] -> uint8[..., row_bytes]."""
    gtype = GGMLType(gtype)
    blk, bsz = GGML_BLOCK_SIZES[gtype]
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.shape[-1] % blk != 0:
        raise ValueError(f"last dim {data.shape[-1]} not divisible by {gtype.name} block {blk}")
    if gtype not in _ENCODERS:
        raise NotImplementedError(f"no encoder for {gtype.name} in zllm_torch")
    lead = data.shape[:-1]
    blocks = data.reshape(-1, blk)
    out = _ENCODERS[gtype](blocks)
    return np.ascontiguousarray(out, dtype=np.uint8).reshape(*lead, -1)
