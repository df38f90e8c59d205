"""Core transformer ops as plain PyTorch (the counterpart of
`zllm.ops.layers`).  Semantics and rounding points follow the JAX versions
so the same GGUF weights give the same numbers."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF_REF = -1e30  # masked-logit filler of the reference attention


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight in f32, cast back to x's dtype.
    The mean of squares is summed in f64 and rounded to f32: a reduction's
    order depends on how many rows it has, and f64 keeps that from showing
    in the f32 mean (the squares are exact in f64), so a row's bits do not
    depend on the rows beside it."""
    xf = x.float()
    var = torch.mean(xf.double().square(), dim=-1, keepdim=True).float()
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
               eps: float) -> torch.Tensor:
    """(x - mu) * rsqrt(var + eps) * weight (+ bias) in f32, cast back to
    x's dtype (zllm's `layer_norm`).  The mean and the two-pass variance
    (the mean of (x - mu)^2) are summed in f64 and rounded to f32, as
    `rms_norm` sums its mean, so a row's bits do not depend on the rows
    beside it."""
    xf = x.float()
    x64 = xf.double()
    mu64 = torch.mean(x64, dim=-1, keepdim=True)
    var = torch.mean((x64 - mu64).square(), dim=-1, keepdim=True).float()
    out = (xf - mu64.float()) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


class RopeParams(NamedTuple):
    """Static rotary-embedding configuration (ggml rope NORM/NEOX modes with
    linear / yarn / llama3 frequency scaling)."""

    dim: int  # number of rotated dims (<= head_dim)
    base: float = 10000.0
    style: str = "norm"  # "norm": adjacent pairs; "neox": split halves
    scaling: str = "none"  # none | linear | yarn | llama3
    scale_factor: float = 1.0
    orig_ctx: int = 0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    attn_factor: float = 1.0


def _rope_freqs(p: RopeParams, device=None) -> tuple[torch.Tensor, float]:
    """Per-pair inverse frequencies [dim/2] (f32) and magnitude scale."""
    half = p.dim // 2
    exponents = torch.arange(half, dtype=torch.float32, device=device) * (2.0 / p.dim)
    # torch.full, not torch.tensor: no host copy, so a CUDA graph can capture a step
    base = torch.full((), p.base, dtype=torch.float32, device=device)
    inv_freq = 1.0 / torch.pow(base, exponents)
    mscale = 1.0
    if p.scaling == "linear":
        inv_freq = inv_freq / p.scale_factor
    elif p.scaling == "llama3":
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = p.orig_ctx / p.low_freq_factor
        high_wl = p.orig_ctx / p.high_freq_factor
        smooth = (p.orig_ctx / wavelen - p.low_freq_factor) / (
            p.high_freq_factor - p.low_freq_factor
        )
        smooth = smooth.clamp(0.0, 1.0)
        scaled = inv_freq / p.scale_factor
        mid = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(wavelen > low_wl, scaled,
                               torch.where(wavelen < high_wl, inv_freq, mid))
    elif p.scaling == "yarn":
        def corr_dim(n_rot):
            return p.dim * math.log(p.orig_ctx / (n_rot * 2 * math.pi)) / (2 * math.log(p.base))

        lo = max(0.0, math.floor(corr_dim(p.beta_fast)))
        hi = min(p.dim - 1.0, math.ceil(corr_dim(p.beta_slow)))
        ramp = ((torch.arange(half, dtype=torch.float32, device=device) - lo)
                / max(hi - lo, 0.001)).clamp(0.0, 1.0)
        inv_freq = inv_freq * (ramp / p.scale_factor + (1.0 - ramp))
        mscale = (p.attn_factor * (1.0 + 0.1 * math.log(p.scale_factor))
                  if p.scale_factor > 1 else p.attn_factor)
    return inv_freq, mscale


def apply_rope(x: torch.Tensor, positions: torch.Tensor, p: RopeParams) -> torch.Tensor:
    """x: [..., T, H, D]; positions: broadcastable to [..., T]."""
    inv_freq, mscale = _rope_freqs(p, x.device)
    theta = positions[..., :, None].float() * inv_freq  # [..., T, dim/2]
    cos = (torch.cos(theta) * mscale)[..., :, None, :]
    sin = (torch.sin(theta) * mscale)[..., :, None, :]
    rot, rest = x[..., : p.dim], x[..., p.dim :]
    rotf = rot.float()
    if p.style == "neox":
        x1, x2 = rotf.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:  # "norm": rotate adjacent (even, odd) pairs
        x1, x2 = rotf[..., 0::2], rotf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(rotf.shape)
    out = out.to(x.dtype)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


class RopeTable(NamedTuple):
    """Per-row rope as cos/sin tables [B, R/2] (R rotated dims, R = 0 for
    NoPE); what `rope_rot_matrix` encodes as a [D, D] matrix."""

    cos: torch.Tensor
    sin: torch.Tensor
    neox: bool

    @property
    def rot_dims(self) -> int:
        return 2 * self.cos.shape[-1]


def rope_table(positions: torch.Tensor, p: RopeParams | None, head_dim: int) -> RopeTable:
    """positions [B] -> RopeTable (f32)."""
    b = positions.shape[0]
    if p is None or p.dim == 0:
        z = torch.zeros((b, 0), dtype=torch.float32, device=positions.device)
        return RopeTable(z, z, True)
    inv_freq, mscale = _rope_freqs(p, positions.device)
    theta = positions.float()[:, None] * inv_freq
    return RopeTable((torch.cos(theta) * mscale).contiguous(),
                     (torch.sin(theta) * mscale).contiguous(), p.style == "neox")


def rope_apply_table(x: torch.Tensor, rt: RopeTable) -> torch.Tensor:
    """x [B, H, D] f32 -> roped by the per-row table (plain version of the
    decode kernel's rope; equals apply_rope at that position)."""
    r = rt.rot_dims
    if r == 0:
        return x
    cos, sin = rt.cos[:, None, :], rt.sin[:, None, :]
    rot, rest = x[..., :r], x[..., r:]
    if rt.neox:
        x1, x2 = rot.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(rot.shape)
    return torch.cat([out, rest], dim=-1)


def rope_rot_matrix(positions: torch.Tensor, p: RopeParams | None, head_dim: int) -> torch.Tensor:
    """Per-position rope as a [D, D] matrix: x @ R == apply_rope(x) at that
    position; positions [B] -> R [B, D, D] f32; p=None -> identity."""
    b = positions.shape[0]
    eye = torch.eye(head_dim, dtype=torch.float32, device=positions.device)
    if p is None or p.dim == 0:
        return eye.expand(b, head_dim, head_dim).clone()
    rt = rope_table(positions, p, head_dim)
    half = p.dim // 2
    j = np.arange(half)
    i1, i2 = (j, j + half) if p.style == "neox" else (2 * j, 2 * j + 1)
    rows = np.concatenate([i1, i2, i2, i1])
    cols = np.concatenate([i1, i2, i1, i2])
    vals = torch.cat([rt.cos, rt.cos, -rt.sin, rt.sin], dim=-1)
    if p.dim < head_dim:
        rest = np.arange(p.dim, head_dim)
        rows = np.concatenate([rows, rest])
        cols = np.concatenate([cols, rest])
        vals = torch.cat([vals, torch.ones((b, head_dim - p.dim), device=positions.device)], dim=-1)
    out = torch.zeros((b, head_dim, head_dim), dtype=torch.float32, device=positions.device)
    out[:, torch.as_tensor(rows), torch.as_tensor(cols)] = vals
    return out


def attention_ref(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    mask: torch.Tensor,  # bool [B, T, S]; True = attend
    scale: float,
    logit_softcap: float = 0.0,
    sinks: torch.Tensor | None = None,  # [Hq]
) -> torch.Tensor:
    """Reference attention (materialized softmax, all in f32)."""
    b, t, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qf = q.float().reshape(b, t, hkv, g, d)
    logits = torch.einsum("bthgd,bhsd->bhgts", qf, k.float()) * scale
    if logit_softcap > 0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF_REF)
    if sinks is not None:
        sink = sinks.float().reshape(1, hkv, g, 1, 1).expand(b, hkv, g, t, 1)
        probs = torch.softmax(torch.cat([logits, sink], dim=-1), dim=-1)[..., :-1]
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bhsd->bthgd", probs, v.float())
    return out.reshape(b, t, hq, -1).to(q.dtype)


def causal_mask(positions: torch.Tensor, kv_len: int, window: int = 0) -> torch.Tensor:
    """bool[B, T, kv_len]: slot s attendable from query position p iff
    s <= p (and p - s < window when sliding-window attention is on)."""
    s = torch.arange(kv_len, dtype=torch.int32, device=positions.device)[None, None, :]
    p = positions[:, :, None]
    m = s <= p
    if window > 0:
        m = m & (s > p - window)
    return m


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Gemma's gated FFN: the tanh-approximate gelu of the f32 gate, rounded
    to the gate's dtype, times up (zllm's `geglu`)."""
    return F.gelu(gate.float(), approximate="tanh").to(gate.dtype) * up


def swiglu_oai(gate: torch.Tensor, up: torch.Tensor, alpha: float = 1.702,
               limit: float = 7.0) -> torch.Tensor:
    """gpt-oss's clamped SwiGLU (zllm's `swiglu_oai`): in f32, the gate
    clamped above at `limit` and up to [-limit, limit], then g * sigmoid(alpha
    g) * (u + 1), kept in f32 whatever the inputs' dtype (zllm casts the
    product back to its clamped up's dtype, which is f32)."""
    g = gate.float().clamp(max=limit)
    u = up.float().clamp(-limit, limit)
    return g * torch.sigmoid(alpha * g) * (u + 1.0)


def gelu(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """The non-gated MLP's activation: the gelu of the f32 values, exact
    (erf: GPT-NeoX) or tanh-approximate (StarCoder2), rounded to x's dtype
    (zllm's `jax.nn.gelu` in `_ffn_core`)."""
    return F.gelu(x.float(), approximate="none" if exact else "tanh").to(x.dtype)
