"""Attention kernels: the whole decode attention block (K2) and prefill
attention (K6), each a hand-written CUDA kernel with its plain PyTorch
version beside it.

  * `attn_decode_qkv` replaces `zllm/ops/attention.py::_attn_decode_qkv_kernel`
    (via `attn_decode_qkv`): split the fused [B, Hq+2Hkv, D] projection row,
    optional per-head RMS q/k norms, rope, write the new K/V row into the
    cache in place, GQA attention with causal/window mask and softcap.
    Source: `zllm_torch/csrc/attn_decode.cu`.
  * `flash_attention` replaces `zllm/ops/attention.py::_attn_kernel` (via
    `flash_attention`): multi-token GQA attention, causal from a base
    position, window, softcap, sinks in the denominator.
    Source: `zllm_torch/csrc/flash_attn.cu`.

The TPU tiling gates of `zllm` (`use_decode_qkv`, `use_fused`) are not
carried over: on the card these kernels take every shape they are given.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each wrapper counts launches in
`.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda
from .layers import RopeTable, rope_apply_table

NEG_INF = -2.4e38  # sub-f32-max filler for masked logits (as zllm's kernels)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _head_rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS over D, in the kernel's order: (x * rsqrt(ms)) * w."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.float()


# ---------------------------------------------------------------------------
# K2: decode attention block
# ---------------------------------------------------------------------------

def attn_decode_qkv_plain(qkv3, kc, vc, positions, rope: RopeTable, qw=None, kw=None, *,
                          scale: float, softcap: float = 0.0, window: int = 0,
                          eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K2.  Updates kc/vc in place; returns att [B, 1, Hq, D].
    Rounding points: the roped q and the new K/V rows are cast to the cache
    dtype, and the probabilities to the cache dtype before P.V."""
    b, hh, d = qkv3.shape
    hkv, s = kc.shape[1], kc.shape[2]
    hq = hh - 2 * hkv
    g = hq // hkv
    dtype = kc.dtype
    pos = positions.reshape(b).long()
    pw = pos.clamp(max=s - 1)
    full = qkv3.float()
    q, kn, vn = full[:, :hq], full[:, hq:hq + hkv], full[:, hq + hkv:]
    if qw is not None:
        q = _head_rms(q, qw, eps)
        kn = _head_rms(kn, kw, eps)
    q = rope_apply_table(q, rope).to(dtype)
    kn = rope_apply_table(kn, rope).to(dtype)
    rows = torch.arange(b, device=kc.device)
    kc[rows, :, pw] = kn
    vc[rows, :, pw] = vn.to(dtype)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float().reshape(b, hkv, g, d), kc.float()) * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    cols = torch.arange(s, device=kc.device)[None, :]
    mask = cols <= pos[:, None]
    if window > 0:
        mask = mask & (cols > pos[:, None] - window)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(dtype)
    out = torch.einsum("bhgs,bhsd->bhgd", probs.float(), vc.float())
    return out.reshape(b, 1, hq, d).to(qkv3.dtype)


def attn_decode_qkv(qkv3: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    positions: torch.Tensor, rope: RopeTable,
                    qw: torch.Tensor | None = None, kw: torch.Tensor | None = None, *,
                    scale: float, softcap: float = 0.0, window: int = 0,
                    eps: float = 1e-5) -> torch.Tensor:
    """The whole T=1 attention block for one layer.  qkv3 [B, Hq+2Hkv, D]
    raw projection rows; kc/vc [B, Hkv, S, D] caches, updated in place at
    row min(pos, S-1); positions [B] or [B, 1]; rope a per-row cos/sin table.
    Returns att [B, 1, Hq, D] in qkv3's dtype."""
    b, hh, d = qkv3.shape
    hkv, s = kc.shape[1], kc.shape[2]
    hq = hh - 2 * hkv
    if hq <= 0 or hq % hkv or kc.shape != vc.shape or kc.shape[0] != b or kc.shape[3] != d:
        raise ValueError(f"bad shapes qkv3 {tuple(qkv3.shape)} cache {tuple(kc.shape)}")
    if (qw is None) != (kw is None):
        raise ValueError("qw and kw go together")
    if qkv3.device.type == "cpu":
        return attn_decode_qkv_plain(qkv3, kc, vc, positions, rope, qw, kw, scale=scale,
                                     softcap=softcap, window=window, eps=eps)
    if qkv3.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv3.device}")
    if qkv3.dtype not in cuda.DTYPE_CODE or kc.dtype not in cuda.DTYPE_CODE or vc.dtype != kc.dtype:
        raise ValueError(f"dtypes {qkv3.dtype} / {kc.dtype} / {vc.dtype}")
    if d not in (64, 128) or rope.rot_dims > d:
        raise ValueError(f"head_dim {d} (rope dims {rope.rot_dims}) not supported")
    pos = positions.reshape(b)
    if pos.dtype != torch.int32:
        raise ValueError("positions must be int32")
    extra = [rope.cos, rope.sin] + ([qw, kw] if qw is not None else [])
    if any(t.dtype != torch.float32 for t in extra):
        raise ValueError("rope table and q/k norm weights must be float32")
    cuda.require_cuda(qkv3, kc, vc, pos, *extra, aligned=(kc, vc))
    out = torch.empty((b, 1, hq, d), dtype=qkv3.dtype, device=qkv3.device)
    scratch = torch.empty((b, hq, s), dtype=torch.float32, device=qkv3.device)
    fn = cuda.bind("attn_decode", "zt_attn_decode_qkv",
                   [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _F, _P])
    err = fn(qkv3.data_ptr(), cuda.DTYPE_CODE[qkv3.dtype], kc.data_ptr(), vc.data_ptr(),
             cuda.DTYPE_CODE[kc.dtype], pos.data_ptr(), rope.cos.data_ptr(),
             rope.sin.data_ptr(), cuda.ptr(qw), cuda.ptr(kw), out.data_ptr(),
             scratch.data_ptr(), b, hq, hkv, s, d, rope.rot_dims, int(rope.neox),
             float(scale), float(softcap), int(window), float(eps), cuda.stream())
    cuda.check(err, "attn_decode_qkv")
    attn_decode_qkv.launches += 1
    return out


attn_decode_qkv.launches = 0


# ---------------------------------------------------------------------------
# K6: prefill attention
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, positions, *, scale: float, softcap: float = 0.0,
                          window: int = 0, sinks: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K6 (zllm `_attn_kernel` math): f32 scores, exact
    softmax with optional sink logit, probabilities cast to V's dtype."""
    b, t, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, t, hkv, g, d)
    scores = torch.einsum("bthgd,bhsd->bhgts", qf, k.float()) * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    qp = positions[:, :1].long() + torch.arange(t, device=q.device)[None, :]  # [B, T]
    cols = torch.arange(s, device=q.device)[None, None, :]
    mask = cols <= qp[:, :, None]
    if window > 0:
        mask = mask & (cols > qp[:, :, None] - window)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sink = sinks.float().reshape(1, hkv, g, 1, 1)
        m = torch.maximum(m, sink)
        e = torch.exp(scores - m)
        denom = e.sum(dim=-1, keepdim=True) + torch.exp(sink - m)
    else:
        e = torch.exp(scores - m)
        denom = e.sum(dim=-1, keepdim=True)
    probs = (e / denom).to(v.dtype).float()
    out = torch.einsum("bhgts,bhsd->bthgd", probs, v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                    *, scale: float, softcap: float = 0.0, window: int = 0,
                    sinks: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, T, Hq, D]; k/v [B, Hkv, S, D]; positions [B, T] consecutive per
    row (only positions[:, 0] is read).  Returns [B, T, Hq, D] in q's dtype."""
    b, t, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, positions, scale=scale, softcap=softcap,
                                     window=window, sinks=sinks)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in cuda.DTYPE_CODE or k.dtype not in cuda.DTYPE_CODE or v.dtype != k.dtype:
        raise ValueError(f"dtypes {q.dtype} / {k.dtype} / {v.dtype}")
    if d not in (64, 128):
        raise ValueError(f"head_dim {d} not supported")
    pos0 = positions[:, 0].contiguous()
    if pos0.dtype != torch.int32:
        raise ValueError("positions must be int32")
    if sinks is not None and (sinks.dtype != torch.float32 or sinks.numel() != hq):
        raise ValueError("sinks must be float32 [Hq]")
    cuda.require_cuda(q, k, v, pos0, *([sinks] if sinks is not None else []))
    out = torch.empty_like(q)
    fn = cuda.bind("flash_attn", "zt_flash_attention",
                   [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P])
    err = fn(q.data_ptr(), cuda.DTYPE_CODE[q.dtype], k.data_ptr(), v.data_ptr(),
             cuda.DTYPE_CODE[k.dtype], pos0.data_ptr(), cuda.ptr(sinks), out.data_ptr(),
             b, t, hq, hkv, s, d, float(scale), float(softcap), int(window), cuda.stream())
    cuda.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
