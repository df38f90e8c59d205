"""Attention kernels: the whole decode attention block (K2), prefill
attention (K6), blockwise attention over bf16 or int8 K/V (K7), the
contiguous decode step (K8), paged multi-token attention (K10) and the
paged decode step (K9), each a hand-written CUDA kernel with its plain
PyTorch version beside it.

  * `attn_decode_qkv` replaces `zllm/ops/attention.py::_attn_decode_qkv_kernel`
    (via `attn_decode_qkv`): split the fused [B, Hq+2Hkv, D] projection row,
    optional per-head RMS q/k norms, rope, write the new K/V row into the
    cache in place, GQA attention with causal/window mask and softcap, and
    in its sinks form a per-head sink logit in each softmax (zllm runs no
    kernel there: a decode step with sinks is its `attention_ref`).
    Source: `zllm_torch/csrc/attn_decode.cu` (a block a (row, kv head,
    8 query heads) and chunk of the span, scores and P.V on mma.sync,
    programmatic dependent launch; a span of several chunks finished by
    the last of its blocks).
  * `flash_attention` replaces `zllm/ops/attention.py::_attn_kernel` (via
    `flash_attention`): multi-token GQA attention, causal from a base
    position, window, softcap, sinks in the denominator; the probabilities
    normalized, then rounded to V's dtype.  Source:
    `zllm_torch/csrc/flash_attn.cu` (bf16 or f16 K/V: two passes on the
    tensor cores, the row's max and sum, then P.V; f32 K/V: the tile loop
    `csrc/attn_tile.cuh`, shared with K10's f32 pools).
  * `paged_attention` replaces `zllm/ops/attention.py::_paged_attn_kernel`
    (via `paged_attention`): multi-token attention with K/V read from a
    paged pool through the page table; causal from positions[:, 0], window,
    softcap; zllm's page-by-page online softmax, exp(s - running max)
    rounded to the pool dtype.  Source: `zllm_torch/csrc/paged_attn.cu`
    (bf16 or f16 pools: the tensor-core loop `csrc/attn_mma.cuh`, shared with K7;
    f32 pools: the tile loop `csrc/attn_tile.cuh`, shared with K6's f32
    form; a page-table addressor for either).
  * `paged_attn_decode_update` replaces
    `zllm/ops/attention.py::_paged_decode_kernel` (via
    `paged_attn_decode_update`): T=1, insert the new K/V row into its page in
    place, attend over the page table.  Source: `zllm_torch/csrc/paged_decode.cu`
    (one thread-block-cluster launch of `csrc/decode_cluster.cuh`, shared
    with K7's split form).
  * `attn_decode_update` replaces `zllm/ops/attention.py::_attn_decode_kernel`
    (via `attn_decode_update`): T=1, insert the roped new K/V row into the
    contiguous cache in place at min(pos, S-1), attend.  Source:
    `zllm_torch/csrc/attn_decode_update.cu` (one thread-block-cluster launch
    of `csrc/decode_cluster.cuh`, shared with K7's split form and K9; p
    normalized, then rounded to the cache dtype).
  * `flash_attention_blockwise` replaces
    `zllm/ops/attention.py::_attnb_kernel` (via `flash_attention_blockwise`):
    multi-token GQA attention with an online softmax over KV blocks, causal
    from positions[:, 0], window, softcap, sinks; K/V in bf16, or int8
    codes (`QuantKV`, the q8 KV cache) whose per-vector scales multiply the
    scores (K) and the probabilities (V).  The probabilities stay f32.
    Source: `zllm_torch/csrc/attn_blockwise.cu` (up to 32 query rows a kv
    head: one cluster launch of `csrc/decode_cluster.cuh`, shared with K9;
    more: the tensor-core loop `csrc/attn_mma.cuh`, shared with K10).

The paged pools are token-major, [Hkv, P * ps, D] (zllm's are token-minor;
see `runtime/paged.py`).  The TPU tiling gates of `zllm` (`use_decode_qkv`,
`use_fused`, `use_decode_fused`, `use_paged_decode_fused`) are not carried
over: on the card these kernels take every shape they are given.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each wrapper counts launches in
`.launches`; K6, K7 and K10 also count in `.mma_launches` those of their
tensor-core form, K2, K6, K8, K9 and K10 in `.f16_launches` those of
their f16 form (an f16 cache or pool), and K2, K6 and K7 in
`.sinks_launches` those given per-head sink logits (gpt-oss's).

KV caches and pools may be float32, bfloat16 or float16 (the f16 KV cache,
llama.cpp's default `-ctk/-ctv f16`); q, the new K/V rows and the outputs
are float32 or bfloat16.  Head dims on the card: 64 and 128 everywhere;
256 (Gemma's) in K2, K6 and K10, and in K9 over bf16 or f16 pools (an
f32 pool's two 128-slot chunks of 1 KB rows exceed a block's shared
memory); K7 and K8 raise a ValueError at 256 (ROADMAP queue 2: Gemma-1
with the q8 cache reaches K7; no Gemma path reaches K8).  On the card K2, K6, K8, K9 and K10 have f16
forms (f16 x f16 mma.sync; an f32 or bf16 q is scaled a row at a time by
a power of two before its f16 split, see `csrc/attn_mma.cuh`); K7 takes
bf16 or int8 K/V.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda
from .layers import RopeTable, rope_apply_table

NEG_INF = -2.4e38  # sub-f32-max filler for masked logits (as zllm's kernels)

# the K/V dtypes of K6's and K10's tensor-core forms (f32 K/V: the tile loop)
MMA_KV = (torch.bfloat16, torch.float16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

HEAD_DIMS = (64, 128, 256)  # K2's, K6's, K9's and K10's forms on the card
_NO_256 = "ROADMAP queue 2: no head_dim 256 form yet"


def _head_rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS over D, in the kernel's order: (x * rsqrt(ms)) * w."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.float()


# ---------------------------------------------------------------------------
# K2: decode attention block
# ---------------------------------------------------------------------------

def attn_decode_qkv_plain(qkv3, kc, vc, positions, rope: RopeTable, qw=None, kw=None, *,
                          scale: float, softcap: float = 0.0, window: int = 0,
                          eps: float = 1e-5, sinks: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K2.  Updates kc/vc in place; returns att [B, 1, Hq, D].
    Rounding points: the roped q and the new K/V rows are cast to the cache
    dtype, and the probabilities to the cache dtype before P.V.  `sinks`
    [Hq] f32 (gpt-oss): head h's sink logit joins its softmax, the row max
    max(m, s_h) and the denominator plus exp(s_h - max), as zllm's
    `attention_ref` takes it."""
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
    if sinks is None:
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = (e / e.sum(dim=-1, keepdim=True)).to(dtype)
    else:
        sink = sinks.float().reshape(1, hkv, g, 1)
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), sink)
        e = torch.exp(scores - m)
        probs = (e / (e.sum(dim=-1, keepdim=True) + torch.exp(sink - m))).to(dtype)
    out = torch.einsum("bhgs,bhsd->bhgd", probs.float(), vc.float())
    return out.reshape(b, 1, hq, d).to(qkv3.dtype)


_K2_CHUNK: dict[tuple[int, int], int] = {}
_K2_COUNTERS: dict[torch.device, torch.Tensor] = {}
_K2_RETIRED: list[torch.Tensor] = []


def _k2_chunk(c_code: int, d: int) -> int:
    """Slots a K2 chunk for a cache dtype code and head dim (the kernel's
    own rule, asked once)."""
    key = (c_code, d)
    if key not in _K2_CHUNK:
        fn = cuda.bind("attn_decode", "zt_attn_decode_chunk", [_I, _I])
        chunk = fn(c_code, d)
        if chunk <= 0:
            raise ValueError(f"K2 takes no cache dtype code {c_code} at head_dim {d}")
        _K2_CHUNK[key] = chunk
    return _K2_CHUNK[key]


def _k2_counters(dev: torch.device, n: int) -> torch.Tensor:
    """K2's per-(row, head group) tickets: zero, and left zero by every
    launch, so one buffer a device serves every call (grown outside graph
    capture, the old one kept alive for the graphs that captured it; a
    capture that needs more gets its own zeroed buffer)."""
    buf = _K2_COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        fresh = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        if torch.cuda.is_current_stream_capturing():
            return fresh
        if buf is not None:
            _K2_RETIRED.append(buf)
        _K2_COUNTERS[dev] = buf = fresh
    return buf


def attn_decode_qkv(qkv3: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    positions: torch.Tensor, rope: RopeTable,
                    qw: torch.Tensor | None = None, kw: torch.Tensor | None = None, *,
                    scale: float, softcap: float = 0.0, window: int = 0,
                    eps: float = 1e-5, sinks: torch.Tensor | None = None) -> torch.Tensor:
    """The whole T=1 attention block for one layer.  qkv3 [B, Hq+2Hkv, D]
    raw projection rows; kc/vc [B, Hkv, S, D] caches, updated in place at
    row min(pos, S-1); positions [B] or [B, 1]; rope a per-row cos/sin table;
    sinks [Hq] f32 or None (the sinks form, gpt-oss's).  Returns att [B, 1,
    Hq, D] in qkv3's dtype."""
    b, hh, d = qkv3.shape
    hkv, s = kc.shape[1], kc.shape[2]
    hq = hh - 2 * hkv
    if hq <= 0 or hq % hkv or kc.shape != vc.shape or kc.shape[0] != b or kc.shape[3] != d:
        raise ValueError(f"bad shapes qkv3 {tuple(qkv3.shape)} cache {tuple(kc.shape)}")
    if (qw is None) != (kw is None):
        raise ValueError("qw and kw go together")
    if qkv3.device.type == "cpu":
        return attn_decode_qkv_plain(qkv3, kc, vc, positions, rope, qw, kw, scale=scale,
                                     softcap=softcap, window=window, eps=eps, sinks=sinks)
    if qkv3.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv3.device}")
    if qkv3.dtype not in cuda.ACT_DTYPES or kc.dtype not in cuda.DTYPE_CODE or vc.dtype != kc.dtype:
        raise ValueError(f"dtypes {qkv3.dtype} / {kc.dtype} / {vc.dtype}")
    if d not in HEAD_DIMS or rope.rot_dims > d:
        raise ValueError(f"head_dim {d} (rope dims {rope.rot_dims}) not supported")
    pos = positions.reshape(b)
    if pos.dtype != torch.int32:
        raise ValueError("positions must be int32")
    extra = ([rope.cos, rope.sin] + ([qw, kw] if qw is not None else [])
             + ([sinks] if sinks is not None else []))
    if any(t.dtype != torch.float32 for t in extra):
        raise ValueError("rope table, q/k norm weights and sinks must be float32")
    if sinks is not None and sinks.numel() != hq:
        raise ValueError(f"sinks must be [Hq] = [{hq}], not {tuple(sinks.shape)}")
    cuda.require_cuda(qkv3, kc, vc, pos, *extra, aligned=(kc, vc))
    out = torch.empty((b, 1, hq, d), dtype=qkv3.dtype, device=qkv3.device)
    c_code = cuda.DTYPE_CODE[kc.dtype]
    chunk = _k2_chunk(c_code, d)
    splits, groups = -(-s // chunk), hkv * -(-(hq // hkv) // 8)
    gsc = gst = None
    if splits > 1:  # rows whose span is more than one chunk
        gsc = torch.empty((b, groups, 8, s), dtype=torch.float32, device=qkv3.device)
        gst = torch.empty((b, groups, splits, 8, 2), dtype=torch.float32, device=qkv3.device)
    fn = cuda.bind("attn_decode", "zt_attn_decode_qkv",
                   [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _F, _P])
    err = fn(qkv3.data_ptr(), cuda.DTYPE_CODE[qkv3.dtype], kc.data_ptr(), vc.data_ptr(),
             c_code, pos.data_ptr(), rope.cos.data_ptr(), rope.sin.data_ptr(), cuda.ptr(qw),
             cuda.ptr(kw), cuda.ptr(sinks), out.data_ptr(), cuda.ptr(gsc), cuda.ptr(gst),
             _k2_counters(qkv3.device, b * groups).data_ptr(), b, hq, hkv, s, d,
             rope.rot_dims, int(rope.neox), float(scale), float(softcap), int(window),
             float(eps), cuda.stream())
    cuda.check(err, "attn_decode_qkv")
    attn_decode_qkv.launches += 1
    attn_decode_qkv.f16_launches += kc.dtype == torch.float16
    attn_decode_qkv.sinks_launches += sinks is not None
    return out


attn_decode_qkv.launches = 0
attn_decode_qkv.f16_launches = 0  # of them, launches of the f16 form (an f16 cache)
attn_decode_qkv.sinks_launches = 0  # of them, launches of the sinks form


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
    if q.dtype not in cuda.ACT_DTYPES or k.dtype not in cuda.DTYPE_CODE or v.dtype != k.dtype:
        raise ValueError(f"dtypes {q.dtype} / {k.dtype} / {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported")
    pos0 = positions[:, 0].contiguous()
    if pos0.dtype != torch.int32:
        raise ValueError("positions must be int32")
    if sinks is not None and (sinks.dtype != torch.float32 or sinks.numel() != hq):
        raise ValueError("sinks must be float32 [Hq]")
    cuda.require_cuda(q, k, v, pos0, *([sinks] if sinks is not None else []), aligned=(k, v))
    out = torch.empty_like(q)
    mma = k.dtype in MMA_KV  # the tensor-core form (bf16 or f16); f32 K/V the tile loop
    fn = cuda.bind("flash_attn", "zt_flash_attention_mma" if mma else "zt_flash_attention",
                   [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P])
    err = fn(q.data_ptr(), cuda.DTYPE_CODE[q.dtype], k.data_ptr(), v.data_ptr(),
             cuda.DTYPE_CODE[k.dtype], pos0.data_ptr(), cuda.ptr(sinks), out.data_ptr(),
             b, t, hq, hkv, s, d, float(scale), float(softcap), int(window), cuda.stream())
    cuda.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.mma_launches += mma
    flash_attention.f16_launches += k.dtype == torch.float16
    flash_attention.sinks_launches += sinks is not None
    return out


flash_attention.launches = 0
flash_attention.mma_launches = 0  # of them, launches of the tensor-core form (bf16/f16 K/V)
flash_attention.f16_launches = 0  # of them, launches of the f16 form (f16 K/V)
flash_attention.sinks_launches = 0  # of them, launches with sinks


# ---------------------------------------------------------------------------
# K10: paged multi-token attention
# ---------------------------------------------------------------------------

def _check_paged(q, k_pool, v_pool, table, page_size: int):
    b, hq, d = q.shape[0], q.shape[2], q.shape[3]
    hkv = k_pool.shape[0]
    if (k_pool.dim() != 3 or k_pool.shape != v_pool.shape or k_pool.shape[2] != d
            or hq % hkv or k_pool.shape[1] % page_size or table.dim() != 2
            or table.shape[0] != b or table.shape[1] < 2):
        raise ValueError(f"bad shapes q {tuple(q.shape)} pool {tuple(k_pool.shape)} "
                         f"table {tuple(table.shape)} page {page_size}")


def _paged_cuda_checks(q, k_pool, v_pool, table, page_size: int, tile: int):
    if q.dtype not in cuda.ACT_DTYPES or k_pool.dtype not in cuda.DTYPE_CODE \
            or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"dtypes {q.dtype} / {k_pool.dtype} / {v_pool.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]} not supported")
    if page_size % tile:
        raise ValueError(f"page_size {page_size} is not a multiple of {tile}")
    if table.dtype != torch.int32:
        raise ValueError("the page table must be int32")


def paged_online_plain(q, k, v, pos0, *, page_size: int, scale: float, softcap: float = 0.0,
                       window: int = 0) -> torch.Tensor:
    """zllm's page-by-page online softmax (`_paged_attn_kernel`,
    `_paged_decode_kernel`) over the gathered K/V [B, Hkv, S, D] in the pool
    dtype: query t of row b sits at pos0[b] + t.  Page j runs for row b if
    some query of the row sees a slot of it; it does m' = max(m, page max),
    alpha = exp(m - m'), p = exp(s - m'), l = l * alpha + sum(p) from the
    unrounded p, acc = acc * alpha + p.to(pool dtype) @ V; the output is
    acc / l.  Masked scores are the finite NEG_INF, so a page masked for a
    whole row before the row's first seen slot adds the junk zllm adds
    (p = 1), which the first seen page's alpha = 0 wipes.  Every page is
    computed and kept only where it runs (no host sync, so a CUDA graph can
    capture this)."""
    b, t, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g, ps = hq // hkv, page_size
    dev = q.device
    qf = q.float().reshape(b, t, hkv, g, d)
    p0 = pos0.reshape(b).long()
    qp = p0[:, None] + torch.arange(t, device=dev)[None, :]  # [B, T]
    m = torch.full((b, hkv, g, t, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, t, d), dtype=torch.float32, device=dev)
    for j in range(s // ps):
        col0 = j * ps
        run = col0 <= p0 + (t - 1)
        if window > 0:
            run = run & (col0 + ps > p0 - window + 1)
        sc = torch.einsum("bthgd,bhsd->bhgts", qf, k[:, :, col0:col0 + ps].float()) * scale
        if softcap > 0:
            sc = torch.tanh(sc / softcap) * softcap
        cols = col0 + torch.arange(ps, device=dev)[None, None, :]
        mask = cols <= qp[:, :, None]
        if window > 0:
            mask = mask & (cols > qp[:, :, None] - window)
        sc = sc.masked_fill(~mask[:, None, None], NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhgts,bhsd->bhgtd", p.to(v.dtype).float(),
                          v[:, :, col0:col0 + ps].float())
        keep = run.reshape(b, 1, 1, 1, 1)
        m = torch.where(keep, m_new, m)
        l = torch.where(keep, l_new, l)
        acc = torch.where(keep, acc * alpha + pv, acc)
    out = (acc / l).permute(0, 3, 1, 2, 4)  # [B, T, Hkv, G, D]
    return out.reshape(b, t, hq, d).to(q.dtype)


def paged_attention_plain(q, k_pool, v_pool, table, positions, *, page_size: int,
                          scale: float, softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Plain version of K10: gather the pages into [B, Hkv, S, D], then
    zllm's page-by-page online softmax (`paged_online_plain`: f32 scores,
    exp(s - running max) rounded to the pool dtype before P.V, one division
    at the end)."""
    from ..runtime.paged import PagedKV

    k, v = PagedKV(k_pool, v_pool, table, page_size).gather()
    return paged_online_plain(q, k, v, positions[:, 0], page_size=page_size, scale=scale,
                              softcap=softcap, window=window)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    table: torch.Tensor, positions: torch.Tensor, *, page_size: int,
                    scale: float, softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """q [B, T, Hq, D]; pools [Hkv, P * ps, D]; table int32 [B, LP + 1];
    positions [B, T] consecutive per row (only positions[:, 0] is read).
    Returns [B, T, Hq, D] in q's dtype."""
    _check_paged(q, k_pool, v_pool, table, page_size)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, table, positions, page_size=page_size,
                                     scale=scale, softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _paged_cuda_checks(q, k_pool, v_pool, table, page_size, 64)
    pos0 = positions[:, 0].contiguous()
    if pos0.dtype != torch.int32:
        raise ValueError("positions must be int32")
    q = q.contiguous()
    cuda.require_cuda(q, k_pool, v_pool, table, pos0, aligned=(k_pool, v_pool))
    b, t, hq, d = q.shape
    out = torch.empty_like(q)
    mma = k_pool.dtype in MMA_KV  # the tensor-core loop (bf16 or f16); f32 pools the tile loop
    fn = cuda.bind("paged_attn", "zt_paged_attention_mma" if mma else "zt_paged_attention",
                   [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                    _P])
    err = fn(q.data_ptr(), cuda.DTYPE_CODE[q.dtype], k_pool.data_ptr(), v_pool.data_ptr(),
             cuda.DTYPE_CODE[k_pool.dtype], table.data_ptr(), pos0.data_ptr(), out.data_ptr(),
             b, t, hq, k_pool.shape[0], d, k_pool.shape[1], table.shape[1], page_size,
             float(scale), float(softcap), int(window), cuda.stream())
    cuda.check(err, "paged_attention")
    paged_attention.launches += 1
    paged_attention.mma_launches += mma
    paged_attention.f16_launches += k_pool.dtype == torch.float16
    return out


paged_attention.launches = 0
paged_attention.mma_launches = 0  # of them, launches of the tensor-core loop (bf16/f16 pools)
paged_attention.f16_launches = 0  # of them, launches of the f16 form (f16 pools)


# ---------------------------------------------------------------------------
# K9: paged decode step (insert + attend)
# ---------------------------------------------------------------------------

# K9, K8 and K7's split form run as one thread-block-cluster launch
# (csrc/decode_cluster.cuh): a cluster of DECODE_CLUSTER blocks a (row, kv
# head, group of 8 query rows), chunks of at most DECODE_CLUSTER_CHUNK slots
# (K9: a page)
DECODE_CLUSTER = 8
DECODE_CLUSTER_CHUNK = 128

def paged_attn_decode_update_plain(q, k_new, v_new, k_pool, v_pool, table, positions, *,
                                   page_size: int, scale: float, softcap: float = 0.0,
                                   window: int = 0) -> torch.Tensor:
    """Plain version of K9.  Rows with pos < horizon write their new K/V
    (cast to the pool dtype) into the pools in place; then gather and
    zllm's page-by-page online softmax at T=1 (`paged_online_plain`).
    Returns att [B, 1, Hq, D]."""
    from ..runtime.paged import PagedKV

    b = q.shape[0]
    view = PagedKV(k_pool, v_pool, table, page_size)
    pos = positions.reshape(b).long()
    # a row past the horizon addresses the trash page through the pinned
    # last column and writes back what is there (no host sync, so a CUDA
    # graph can capture this too)
    live = (pos < view.shape[2])[None, :, None]
    lp = (pos // page_size).clamp(max=table.shape[1] - 1)
    rows = table.long().gather(1, lp[:, None])[:, 0] * page_size + pos % page_size
    k_pool[:, rows] = torch.where(live, k_new[:, 0].transpose(0, 1).to(k_pool.dtype), k_pool[:, rows])
    v_pool[:, rows] = torch.where(live, v_new[:, 0].transpose(0, 1).to(v_pool.dtype), v_pool[:, rows])
    k, v = view.gather()
    return paged_online_plain(q, k, v, pos, page_size=page_size, scale=scale, softcap=softcap,
                              window=window)


def paged_attn_decode_update(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                             k_pool: torch.Tensor, v_pool: torch.Tensor, table: torch.Tensor,
                             positions: torch.Tensor, *, page_size: int, scale: float,
                             softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """One layer's T=1 paged step.  q [B, 1, Hq, D] and k_new/v_new
    [B, 1, Hkv, D] roped, one dtype; pools [Hkv, P * ps, D] updated in place;
    table int32 [B, LP + 1]; positions int32 [B, 1] (rows at or past the
    horizon LP * ps insert nothing).  Returns att [B, 1, Hq, D] in q's
    dtype.  On the card: one cluster launch, pages of at most 128 slots."""
    _check_paged(q, k_pool, v_pool, table, page_size)
    b, _, hq, d = q.shape
    hkv = k_pool.shape[0]
    if q.shape[1] != 1 or k_new.shape != (b, 1, hkv, d) or v_new.shape != k_new.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_new {tuple(k_new.shape)}")
    if q.device.type == "cpu":
        return paged_attn_decode_update_plain(q, k_new, v_new, k_pool, v_pool, table, positions,
                                              page_size=page_size, scale=scale, softcap=softcap,
                                              window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _paged_cuda_checks(q, k_pool, v_pool, table, page_size, 1)
    if d == 256 and k_pool.dtype == torch.float32:
        raise ValueError("head_dim 256 over an f32 pool: the kernel's two chunks of 128 "
                         "1 KB rows exceed a block's shared memory (bf16 or f16 pools)")
    if page_size > DECODE_CLUSTER_CHUNK:
        raise ValueError(f"page_size {page_size}: the kernel takes pages of at most "
                         f"{DECODE_CLUSTER_CHUNK} slots")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError("q, k_new and v_new must share one dtype")
    pos = positions.reshape(b).contiguous()
    if pos.dtype != torch.int32:
        raise ValueError("positions must be int32")
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    cuda.require_cuda(q, k_new, v_new, k_pool, v_pool, table, pos, aligned=(k_pool, v_pool))
    out = torch.empty_like(q)
    fn = cuda.bind("paged_decode", "zt_paged_attn_decode_update",
                   [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                    _I, _P])
    err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cuda.DTYPE_CODE[q.dtype],
             k_pool.data_ptr(), v_pool.data_ptr(), cuda.DTYPE_CODE[k_pool.dtype],
             table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, hq, hkv, d,
             k_pool.shape[1], table.shape[1], page_size, float(scale), float(softcap),
             int(window), cuda.stream())
    cuda.check(err, "paged_attn_decode_update")
    paged_attn_decode_update.launches += 1
    paged_attn_decode_update.f16_launches += k_pool.dtype == torch.float16
    return out


paged_attn_decode_update.launches = 0
paged_attn_decode_update.f16_launches = 0  # of them, launches of the f16 form (f16 pools)


# ---------------------------------------------------------------------------
# K8: contiguous decode step (insert + attend)
# ---------------------------------------------------------------------------

def attn_decode_update_plain(q, k_new, v_new, kc, vc, positions, *, scale: float,
                             softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Plain version of K8 (zllm `_attn_decode_kernel` math).  Writes the
    new rows, cast to the cache dtype, at min(pos, S-1) of kc/vc in place;
    f32 scores of the unrounded q, causal/window mask from pos, softcap,
    probabilities normalized and cast to the cache dtype before P.V (f32
    accumulate).  Returns att [B, 1, Hq, D] in q's dtype."""
    b, _, hq, d = q.shape
    hkv, s = kc.shape[1], kc.shape[2]
    g = hq // hkv
    pos = positions.reshape(b).long()
    rows = torch.arange(b, device=kc.device)
    pw = pos.clamp(max=s - 1)
    kc[rows, :, pw] = k_new[:, 0].to(kc.dtype)
    vc[rows, :, pw] = v_new[:, 0].to(vc.dtype)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float().reshape(b, hkv, g, d), kc.float()) * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    cols = torch.arange(s, device=kc.device)[None, :]
    mask = cols <= pos[:, None]
    if window > 0:
        mask = mask & (cols > pos[:, None] - window)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(vc.dtype)
    out = torch.einsum("bhgs,bhsd->bhgd", probs.float(), vc.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def attn_decode_update(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                       kc: torch.Tensor, vc: torch.Tensor, positions: torch.Tensor, *,
                       scale: float, softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """One layer's T=1 step over a contiguous cache.  q [B, 1, Hq, D] and
    k_new/v_new [B, 1, Hkv, D] roped, one dtype; kc/vc [B, Hkv, S, D],
    updated in place at row min(pos, S-1); positions int32 [B, 1] (pos ==
    S is a trash row: it writes slot S-1 and attends all S slots).  Returns
    att [B, 1, Hq, D] in q's dtype."""
    b, t, hq, d = q.shape
    hkv, s = kc.shape[1], kc.shape[2]
    if (t != 1 or hq % hkv or k_new.shape != (b, 1, hkv, d) or v_new.shape != k_new.shape
            or kc.shape != (b, hkv, s, d) or vc.shape != kc.shape or positions.numel() != b):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_new {tuple(k_new.shape)} "
                         f"cache {tuple(kc.shape)} positions {tuple(positions.shape)}")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype or vc.dtype != kc.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k/v_new {k_new.dtype}/{v_new.dtype}, "
                         f"cache {kc.dtype}/{vc.dtype}: q, k_new and v_new share one, the "
                         "caches another")
    if q.device.type == "cpu":
        return attn_decode_update_plain(q, k_new, v_new, kc, vc, positions, scale=scale,
                                        softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in cuda.ACT_DTYPES or kc.dtype not in cuda.DTYPE_CODE:
        raise ValueError(f"dtypes q {q.dtype}, cache {kc.dtype}: the kernel takes an f32/bf16 q "
                         "and an f32/bf16/f16 cache")
    if d not in (64, 128):
        raise ValueError(f"head_dim {d} not supported by K8 ({_NO_256})")
    pos = positions.reshape(b).contiguous()
    if pos.dtype != torch.int32:
        raise ValueError("positions must be int32")
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    cuda.require_cuda(q, k_new, v_new, kc, vc, pos, aligned=(kc, vc))
    out = torch.empty_like(q)
    fn = cuda.bind("attn_decode_update", "zt_attn_decode_update",
                   [_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P])
    err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cuda.DTYPE_CODE[q.dtype],
             kc.data_ptr(), vc.data_ptr(), cuda.DTYPE_CODE[kc.dtype], pos.data_ptr(),
             out.data_ptr(), b, hq, hkv, d, s, float(scale), float(softcap), int(window),
             cuda.stream())
    cuda.check(err, "attn_decode_update")
    attn_decode_update.launches += 1
    attn_decode_update.f16_launches += kc.dtype == torch.float16
    return out


attn_decode_update.launches = 0
attn_decode_update.f16_launches = 0  # of them, launches of the f16 form (an f16 cache)


def attn_decode_update_clusters(q_dtype, cache_dtype, b: int, hq: int, hkv: int, d: int,
                                s: int) -> int:
    """The clusters of one K8 call's shape that the card holds at once
    (`cudaOccupancyMaxActiveClusters` for its instantiation); a call
    launches hkv * ceil(hq / hkv / 8) * b of them."""
    n = ctypes.c_int(0)
    fn = cuda.bind("attn_decode_update", "zt_attn_decode_update_clusters",
                   [_I, _I, _I, _I, _I, _I, _I, _P])
    cuda.check(fn(cuda.DTYPE_CODE[q_dtype], cuda.DTYPE_CODE[cache_dtype], b, hq, hkv, d, s,
                  ctypes.addressof(n)), "attn_decode_update_clusters")
    return n.value


# ---------------------------------------------------------------------------
# K7: blockwise attention, bf16/f32 or int8 (q8) K/V
# ---------------------------------------------------------------------------

class QuantKV(NamedTuple):
    """One half of the q8 KV cache as an attention input: int8 codes and
    per-vector f32 scales (zllm's `QuantKV`; `KVCacheQ8.layer` makes them)."""

    q: torch.Tensor  # int8 [B, Hkv, S, D]
    s: torch.Tensor  # f32 [B, Hkv, S, 1]

    @property
    def shape(self):
        return self.q.shape

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        return self.q.to(dtype) * self.s.to(dtype)


# a decode-shaped call (T * G query rows of a kv head at most this) deals
# the slots to the blocks of a cluster (csrc/decode_cluster.cuh); more rows
# take the tensor-core loop (csrc/attn_mma.cuh)
BLOCKWISE_SPLIT_ROWS = 32
KV_CODE = {torch.bfloat16: 1, torch.int8: 2}  # the K/V the kernel takes


def flash_attention_blockwise_plain(q, k, v, positions, *, scale: float, softcap: float = 0.0,
                                    window: int = 0, sinks: torch.Tensor | None = None,
                                    ks: torch.Tensor | None = None,
                                    vs: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K7 (zllm `_attnb_kernel` math): f32 scores
    (q . k) * scale, times the key's scale for int8 K, softcap, the causal
    / window mask from positions[:, 0] + t, an exact softmax with the sink
    logit in its max and denominator; the unnormalized probabilities times
    the value's scale for int8 V, then P.V in f32 over the denominator.
    The probabilities are never rounded."""
    b, t, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, t, hkv, g, d)
    scores = torch.einsum("bthgd,bhsd->bhgts", qf, k.float()) * scale
    if ks is not None:
        scores = scores * ks.float().reshape(b, hkv, 1, 1, s)
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
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        denom = denom + torch.exp(sink - m)
    if vs is not None:
        p = p * vs.float().reshape(b, hkv, 1, 1, s)
    out = torch.einsum("bhgts,bhsd->bthgd", p, v.float()) / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, hq, d).to(q.dtype)


def flash_attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              positions: torch.Tensor, *, scale: float, softcap: float = 0.0,
                              window: int = 0, sinks: torch.Tensor | None = None,
                              ks: torch.Tensor | None = None,
                              vs: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, T, Hq, D]; k/v [B, Hkv, S, D] bf16, or int8 codes with ks/vs
    f32 [B, Hkv, S, 1] (the plain version also takes f32 K/V); positions
    [B, T] (only positions[:, 0] is read: query t of row b sits at
    positions[b, 0] + t); any S >= 1.  Returns [B, T, Hq, D] in q's
    dtype."""
    b, t, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if (ks is None) != (vs is None) or (ks is not None) != (k.dtype == torch.int8):
        raise ValueError("int8 K/V go with their scales ks/vs, and only they do")
    if ks is not None and (ks.shape != (b, hkv, s, 1) or vs.shape != ks.shape):
        raise ValueError(f"bad scale shapes {tuple(ks.shape)} / {tuple(vs.shape)}")
    if q.device.type == "cpu":
        return flash_attention_blockwise_plain(q, k, v, positions, scale=scale, softcap=softcap,
                                               window=window, sinks=sinks, ks=ks, vs=vs)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in cuda.ACT_DTYPES or k.dtype not in KV_CODE or v.dtype != k.dtype:
        raise ValueError(f"dtypes {q.dtype} / {k.dtype} / {v.dtype}: the kernel takes f32/bf16 q "
                         "and bf16 or int8 K/V")
    if d not in (64, 128, 256):
        raise ValueError(f"head_dim {d} not supported by K7 (64, 128 or 256)")
    pos0 = positions[:, 0].contiguous()
    if pos0.dtype != torch.int32:
        raise ValueError("positions must be int32")
    if sinks is not None and (sinks.dtype != torch.float32 or sinks.numel() != hq):
        raise ValueError("sinks must be float32 [Hq]")
    scales = [] if ks is None else [ks, vs]
    if any(x.dtype != torch.float32 for x in scales):
        raise ValueError("ks/vs must be float32")
    q = q.contiguous()
    cuda.require_cuda(q, k, v, pos0, *scales, *([sinks] if sinks is not None else []),
                      aligned=(k, v))
    out = torch.empty_like(q)
    # more than 32 rows a kv head: the multi-row form (the tensor-core loop);
    # else the split form (one cluster launch); one signature
    mma = t * (hq // hkv) > BLOCKWISE_SPLIT_ROWS
    fn = cuda.bind("attn_blockwise", "zt_attn_blockwise_mma" if mma else "zt_attn_blockwise",
                   [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                    _P])
    err = fn(q.data_ptr(), cuda.DTYPE_CODE[q.dtype], k.data_ptr(), v.data_ptr(),
             KV_CODE[k.dtype], cuda.ptr(ks), cuda.ptr(vs), pos0.data_ptr(), cuda.ptr(sinks),
             out.data_ptr(), b, t, hq, hkv, s, d, float(scale), float(softcap), int(window),
             cuda.stream())
    cuda.check(err, "flash_attention_blockwise")
    flash_attention_blockwise.launches += 1
    flash_attention_blockwise.mma_launches += mma
    flash_attention_blockwise.sinks_launches += sinks is not None
    return out


flash_attention_blockwise.launches = 0
flash_attention_blockwise.mma_launches = 0  # of them, launches of the multi-row (tensor-core) form
flash_attention_blockwise.sinks_launches = 0  # of them, launches with sinks
