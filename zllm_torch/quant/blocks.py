"""Blockwise quantization codecs (numpy, host-side): the subset the Q4_K
llama path needs.

A copy of `zllm.quant.blocks` restricted to F32/F16 decode and the Q4_K
decoder and encoder (layouts: reference ggml/src/ggml-common.h; reference
kernels: ggml/src/ggml-quants.c).  The encoder's bytes are identical to
`zllm`'s, so `zllm_torch.testing.make_llama_gguf` writes the same files.

All functions operate on `blocks: uint8[N, type_size] -> f32[N, block_size]`
(decode) and the reverse (encode).  Use `dequantize`/`quantize` for whole
tensors with arbitrary leading shape.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..gguf.constants import GGML_BLOCK_SIZES, QK_K, GGMLType

__all__ = ["GGML_BLOCK_SIZES", "dequantize", "quantize", "supported_decode", "unpack_kscales"]


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


def _round_away(x: np.ndarray) -> np.ndarray:
    """Round half away from zero (C roundf), unlike numpy's banker rounding."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


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


_DECODERS: dict[GGMLType, Callable[[np.ndarray], np.ndarray]] = {
    GGMLType.F32: _dec_f32,
    GGMLType.F16: _dec_f16,
    GGMLType.Q4_K: _dec_q4_k,
}
_ENCODERS: dict[GGMLType, Callable[[np.ndarray], np.ndarray]] = {
    GGMLType.Q4_K: _enc_q4_k,
}


def supported_decode() -> set[GGMLType]:
    return set(_DECODERS)


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
