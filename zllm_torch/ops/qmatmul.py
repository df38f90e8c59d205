"""Quantized matmuls on `QWeight`s: the decode matvecs (K1, K4) and the
prefill GEMMs (K3, K5), each a hand-written CUDA kernel with its plain
PyTorch version beside it.  `matvec` and `gemm` dispatch on the weight's
format: Q4_K to K1/K3, Q6_K and Q8_0 to K4/K5.

  * `q4k_matvec` (K1) replaces `zllm/ops/qmatmul.py::_w4a8np_kernel` (via
    `_qmm_w4a8np_call`): M=1, activations quantized to int8 per 32-group
    after an optional RMS-norm (`fuse="norm"`) or SwiGLU (`fuse="glu"`)
    prologue, integer group dots, then `pi*a*dx - b*dx*sum(xq)` in f32.
    Source: `zllm_torch/csrc/q4k_matvec.cu`.
  * `int8_matvec` (K4) replaces `zllm/ops/qmatmul.py::_w4a8_kernel` (via
    `_qmm_w4a8_call`) for Q6_K and Q8_0: the same prologues, with int8
    groups of the format's width (16 for Q6_K, 32 for Q8_0), integer group
    dots against the signed codes, then `pi*a*dx` in f32 (no min term).
    Source: `zllm_torch/csrc/int8_matvec.cu`.
  * `q4k_gemm` (K3) replaces `zllm/ops/qmatmul.py::_qmm_np_kernel` (via
    `_qmm_np_call`) and `dequant_gemm` (K5) replaces `_qmm_kernel` (via
    `_qmm_call`) for Q6_K and Q8_0: [M, K] x dequant(W) with x and the
    dequantized weight both rounded to bf16 in the kernel and products
    accumulated in f32.  Sources: `zllm_torch/csrc/q4k_gemm.cu`,
    `dequant_gemm.cu` (one tile loop, `gemm_tile.cuh`).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each wrapper counts its launches in
`.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from ..gguf.constants import GGMLType
from ..quant.repack import Q4KWeight, QWeight
from . import cuda

FUSE_CODE = {"q": 0, "norm": 1, "glu": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# ---------------------------------------------------------------------------
# K1: decode matvec
# ---------------------------------------------------------------------------

def _prologue(x: torch.Tensor, k: int, fuse: str, aux, eps: float) -> torch.Tensor:
    """The f32 activation row the matvec quantizes (zllm _prologue_quant)."""
    if fuse == "norm":
        xf = x.reshape(k).float()
        r = torch.rsqrt(torch.mean(xf * xf) + eps)
        return xf * aux.reshape(k).float() * r
    if fuse == "glu":
        g = x.reshape(2 * k)[:k].float()
        u = x.reshape(2 * k)[k:].float()
        return g * torch.sigmoid(g) * u
    return x.reshape(k).float()


def quantize_groups(xf: torch.Tensor, group: int = 32):
    """f32 [K] -> (xq f32 integer codes [G, group], dx [G], sx [G]):
    symmetric int8 per group, dx = max(max|x|/127, 1e-12),
    xq = clip(rint(x/dx))."""
    xg = xf.reshape(-1, group)
    dx = torch.clamp_min(xg.abs().amax(dim=-1) / 127.0, 1e-12)
    xq = torch.clamp(torch.round(xg / dx[:, None]), -127, 127)
    return xq, dx, xq.sum(dim=-1)


def q4k_matvec_plain(x, w: Q4KWeight, fuse="q", aux=None, eps=0.0) -> torch.Tensor:
    """Plain version of K1: y [1, N] f32."""
    k, n = w.shape
    xq, dx, sx = quantize_groups(_prologue(x, k, fuse, aux, eps))
    codes = w.codes().float().reshape(n, k // 32, 32)
    # |partial sums| <= 32*15*127 < 2^24: the f32 group dots are exact integers
    pi = (codes * xq[None]).sum(dim=-1)  # [N, G]
    a, b = w.group_scales()
    c = pi * a * dx - b * (dx * sx)
    return c.sum(dim=-1).reshape(1, n)


def _check_qweight(w: QWeight, dev):
    planes = list(w.planes().values())
    cuda.require_cuda(*planes, aligned=planes)
    if w.device != dev:
        raise ValueError(f"weight on {w.device}, activations on {dev}")
    w.validate()
    if w.shape[0] % 256:
        raise ValueError(f"K={w.shape[0]} is not a multiple of 256")


def _require_q4k(w: QWeight):
    if w.fmt != GGMLType.Q4_K:
        raise NotImplementedError(f"K1/K3 take Q4_K, not {w.fmt.name}")


def _check_matvec_args(x, k, fuse, aux):
    if fuse not in FUSE_CODE:
        raise ValueError(f"fuse={fuse!r}")
    want = 2 * k if fuse == "glu" else k
    if x.numel() != want or (x.dim() == 2 and x.shape[0] != 1):
        raise ValueError(f"matvec wants one row of {want}, got {tuple(x.shape)}")
    if fuse == "norm" and (aux is None or aux.numel() != k):
        raise ValueError("fuse='norm' needs the norm weight [K]")


def _check_cuda_x(x, fuse, aux):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in cuda.DTYPE_CODE:
        raise ValueError(f"activation dtype {x.dtype}")
    if fuse == "norm" and aux.dtype != torch.float32:
        raise ValueError("norm weight must be float32")


def q4k_matvec(x: torch.Tensor, w: Q4KWeight, fuse: str = "q", aux: torch.Tensor | None = None,
               eps: float = 0.0) -> torch.Tensor:
    """y[1, N] f32 = prologue(x) @ dequant(w) on the int8 path.

    fuse="q": x [1, K];  "norm": x is the raw residual [1, K], aux the RMS
    weight [K];  "glu": x is the fused gate|up row [1, 2K]."""
    _require_q4k(w)
    k, n = w.shape
    _check_matvec_args(x, k, fuse, aux)
    if x.device.type == "cpu":
        return q4k_matvec_plain(x, w, fuse, aux, eps)
    _check_cuda_x(x, fuse, aux)
    _check_qweight(w, x.device)
    cuda.require_cuda(x, *([aux] if fuse == "norm" else []))
    y = torch.empty((1, n), dtype=torch.float32, device=x.device)
    fn = cuda.bind("q4k_matvec", "zt_q4k_matvec", [_P, _I, _P, _P, _P, _P, _P, _P, _P,
                                                   _I, _I, _I, _F, _P])
    err = fn(x.data_ptr(), cuda.DTYPE_CODE[x.dtype], cuda.ptr(aux) if fuse == "norm" else None,
             w.qs.data_ptr(), w.sc.data_ptr(), w.mn.data_ptr(), w.d.data_ptr(),
             w.dmin.data_ptr(), y.data_ptr(), k, n, FUSE_CODE[fuse], float(eps), cuda.stream())
    cuda.check(err, "q4k_matvec")
    q4k_matvec.launches += 1
    return y


q4k_matvec.launches = 0


# ---------------------------------------------------------------------------
# K4: decode matvec for Q6_K and Q8_0
# ---------------------------------------------------------------------------

INT8_FMT_CODE = {GGMLType.Q6_K: 0, GGMLType.Q8_0: 1}


def int8_matvec_plain(x, w: QWeight, fuse="q", aux=None, eps=0.0) -> torch.Tensor:
    """Plain version of K4: y [1, N] f32."""
    k, n = w.shape
    xq, dx, _ = quantize_groups(_prologue(x, k, fuse, aux, eps), w.GROUP)
    codes = w.int_codes().float().reshape(n, k // w.GROUP, w.GROUP)
    # |partial sums| <= 32*128*127 < 2^24: the f32 group dots are exact integers
    pi = (codes * xq[None]).sum(dim=-1)  # [N, G]
    return (pi * w.group_scale() * dx).sum(dim=-1).reshape(1, n)


def _plane_ptrs(w: QWeight) -> list[int | None]:
    """K4/K5's three plane pointers: Q6_K ql, qh, a; Q8_0 qs, d, (none)."""
    ptrs = [p.data_ptr() for p in w.planes().values()]
    return ptrs + [None] * (3 - len(ptrs))


def _check_int8_shape(w: QWeight):
    if w.fmt not in INT8_FMT_CODE:
        raise NotImplementedError(f"K4/K5 take Q6_K and Q8_0, not {w.fmt.name}")
    k, n = w.shape
    if k % 256 or n % 128:
        raise ValueError(f"K4/K5 take K % 256 == 0 and N % 128 == 0, not (K, N) = {w.shape}")


def int8_matvec(x: torch.Tensor, w: QWeight, fuse: str = "q", aux: torch.Tensor | None = None,
                eps: float = 0.0) -> torch.Tensor:
    """y[1, N] f32 = prologue(x) @ dequant(w) on the int8 path, w Q6_K or
    Q8_0; x and fuse as for `q4k_matvec`."""
    _check_int8_shape(w)
    k, n = w.shape
    _check_matvec_args(x, k, fuse, aux)
    if x.device.type == "cpu":
        return int8_matvec_plain(x, w, fuse, aux, eps)
    _check_cuda_x(x, fuse, aux)
    _check_qweight(w, x.device)
    cuda.require_cuda(x, *([aux] if fuse == "norm" else []))
    y = torch.empty((1, n), dtype=torch.float32, device=x.device)
    fn = cuda.bind("int8_matvec", "zt_int8_matvec", [_I, _P, _I, _P, _P, _P, _P, _P,
                                                     _I, _I, _I, _F, _P])
    err = fn(INT8_FMT_CODE[w.fmt], x.data_ptr(), cuda.DTYPE_CODE[x.dtype],
             cuda.ptr(aux) if fuse == "norm" else None, *_plane_ptrs(w),
             y.data_ptr(), k, n, FUSE_CODE[fuse], float(eps), cuda.stream())
    cuda.check(err, "int8_matvec")
    int8_matvec.launches += 1
    return y


int8_matvec.launches = 0


# ---------------------------------------------------------------------------
# K3 / K5: prefill GEMMs
# ---------------------------------------------------------------------------

def dequant_gemm_plain(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """Plain version of K3 and K5: bf16(x) @ bf16(dequant(w)), f32 accumulate."""
    xb = x.to(torch.bfloat16).float()
    wb = w.dequant_nk().to(torch.bfloat16).float()
    return xb @ wb.t()


q4k_gemm_plain = dequant_gemm_plain


def _check_gemm_x(x: torch.Tensor, k: int):
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"gemm wants [M, {k}], got {tuple(x.shape)}")


def _gemm_cuda_x(x: torch.Tensor, w: QWeight):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in cuda.DTYPE_CODE:
        raise ValueError(f"activation dtype {x.dtype}")
    _check_qweight(w, x.device)
    cuda.require_cuda(x, aligned=(x,))
    return torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)


def q4k_gemm(x: torch.Tensor, w: Q4KWeight) -> torch.Tensor:
    """y[M, N] f32 = x[M, K] @ dequant(w), through bf16 operands (Q4_K)."""
    _require_q4k(w)
    k, n = w.shape
    _check_gemm_x(x, k)
    if x.device.type == "cpu":
        return dequant_gemm_plain(x, w)
    y = _gemm_cuda_x(x, w)
    fn = cuda.bind("q4k_gemm", "zt_q4k_gemm", [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
    err = fn(x.data_ptr(), cuda.DTYPE_CODE[x.dtype], w.qs.data_ptr(), w.sc.data_ptr(),
             w.mn.data_ptr(), w.d.data_ptr(), w.dmin.data_ptr(), y.data_ptr(), x.shape[0], k, n,
             cuda.stream())
    cuda.check(err, "q4k_gemm")
    q4k_gemm.launches += 1
    return y


q4k_gemm.launches = 0


def dequant_gemm(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """y[M, N] f32 = x[M, K] @ dequant(w), through bf16 operands (Q6_K, Q8_0)."""
    _check_int8_shape(w)
    k, n = w.shape
    _check_gemm_x(x, k)
    if x.device.type == "cpu":
        return dequant_gemm_plain(x, w)
    y = _gemm_cuda_x(x, w)
    fn = cuda.bind("dequant_gemm", "zt_dequant_gemm", [_I, _P, _I, _P, _P, _P, _P,
                                                       _I, _I, _I, _P])
    err = fn(INT8_FMT_CODE[w.fmt], x.data_ptr(), cuda.DTYPE_CODE[x.dtype], *_plane_ptrs(w),
             y.data_ptr(), x.shape[0], k, n, cuda.stream())
    cuda.check(err, "dequant_gemm")
    dequant_gemm.launches += 1
    return y


dequant_gemm.launches = 0


# ---------------------------------------------------------------------------
# format dispatch
# ---------------------------------------------------------------------------

def matvec(x: torch.Tensor, w: QWeight, fuse: str = "q", aux: torch.Tensor | None = None,
           eps: float = 0.0) -> torch.Tensor:
    """The decode matvec for w's format: Q4_K -> K1, Q6_K/Q8_0 -> K4."""
    if w.fmt == GGMLType.Q4_K:
        return q4k_matvec(x, w, fuse, aux, eps)
    return int8_matvec(x, w, fuse, aux, eps)


def gemm(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """The prefill GEMM for w's format: Q4_K -> K3, Q6_K/Q8_0 -> K5."""
    if w.fmt == GGMLType.Q4_K:
        return q4k_gemm(x, w)
    return dequant_gemm(x, w)
