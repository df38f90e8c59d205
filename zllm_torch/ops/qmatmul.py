"""Quantized matmuls on `QWeight` (Q4_K): the decode matvec (K1) and the
prefill GEMM (K3), each a hand-written CUDA kernel with its plain PyTorch
version beside it.

  * `q4k_matvec` replaces `zllm/ops/qmatmul.py::_w4a8np_kernel` (via
    `_qmm_w4a8np_call`): M=1, activations quantized to int8 per 32-group
    after an optional RMS-norm (`fuse="norm"`) or SwiGLU (`fuse="glu"`)
    prologue, integer group dots, then `pi*a*dx - b*dx*sum(xq)` in f32.
    Source: `zllm_torch/csrc/q4k_matvec.cu`.
  * `q4k_gemm` replaces `zllm/ops/qmatmul.py::_qmm_np_kernel` (via
    `_qmm_np_call`): [M, K] x dequant(W) with x and the dequantized weight
    both rounded to bf16 in the kernel and products accumulated in f32.
    Source: `zllm_torch/csrc/q4k_gemm.cu`.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each wrapper counts its launches in
`.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.repack import QWeight
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


def quantize_groups(xf: torch.Tensor):
    """f32 [K] -> (xq f32 integer codes [G, 32], dx [G], sx [G]): symmetric
    int8 per 32-group, dx = max(max|x|/127, 1e-12), xq = clip(rint(x/dx))."""
    xg = xf.reshape(-1, 32)
    dx = torch.clamp_min(xg.abs().amax(dim=-1) / 127.0, 1e-12)
    xq = torch.clamp(torch.round(xg / dx[:, None]), -127, 127)
    return xq, dx, xq.sum(dim=-1)


def q4k_matvec_plain(x, w: QWeight, fuse="q", aux=None, eps=0.0) -> torch.Tensor:
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
    cuda.require_cuda(w.qs, w.sc, w.mn, w.d, w.dmin, aligned=(w.qs,))
    if w.qs.device != dev:
        raise ValueError(f"weight on {w.qs.device}, activations on {dev}")
    if w.qs.dtype != torch.uint8 or w.d.dtype != torch.float16 or w.dmin.dtype != torch.float16:
        raise ValueError("QWeight planes must be uint8 / float16")
    k, n = w.shape
    if k % 256 or tuple(w.qs.shape) != (n, k // 2):
        raise ValueError(f"bad QWeight planes for shape {w.shape}")


def q4k_matvec(x: torch.Tensor, w: QWeight, fuse: str = "q", aux: torch.Tensor | None = None,
               eps: float = 0.0) -> torch.Tensor:
    """y[1, N] f32 = prologue(x) @ dequant(w) on the int8 path.

    fuse="q": x [1, K];  "norm": x is the raw residual [1, K], aux the RMS
    weight [K];  "glu": x is the fused gate|up row [1, 2K]."""
    k, n = w.shape
    if fuse not in FUSE_CODE:
        raise ValueError(f"fuse={fuse!r}")
    want = 2 * k if fuse == "glu" else k
    if x.numel() != want or (x.dim() == 2 and x.shape[0] != 1):
        raise ValueError(f"matvec wants one row of {want}, got {tuple(x.shape)}")
    if fuse == "norm" and (aux is None or aux.numel() != k):
        raise ValueError("fuse='norm' needs the norm weight [K]")
    if x.device.type == "cpu":
        return q4k_matvec_plain(x, w, fuse, aux, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in cuda.DTYPE_CODE:
        raise ValueError(f"activation dtype {x.dtype}")
    if fuse == "norm" and aux.dtype != torch.float32:
        raise ValueError("norm weight must be float32")
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
# K3: prefill GEMM
# ---------------------------------------------------------------------------

def q4k_gemm_plain(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """Plain version of K3: bf16(x) @ bf16(dequant(w)), f32 accumulate."""
    xb = x.to(torch.bfloat16).float()
    wb = w.dequant_nk().to(torch.bfloat16).float()
    return xb @ wb.t()


def q4k_gemm(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """y[M, N] f32 = x[M, K] @ dequant(w), through bf16 operands."""
    k, n = w.shape
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"gemm wants [M, {k}], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return q4k_gemm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in cuda.DTYPE_CODE:
        raise ValueError(f"activation dtype {x.dtype}")
    _check_qweight(w, x.device)
    cuda.require_cuda(x, aligned=(x,))
    m = x.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = cuda.bind("q4k_gemm", "zt_q4k_gemm", [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
    err = fn(x.data_ptr(), cuda.DTYPE_CODE[x.dtype], w.qs.data_ptr(), w.sc.data_ptr(),
             w.mn.data_ptr(), w.d.data_ptr(), w.dmin.data_ptr(), y.data_ptr(), m, k, n,
             cuda.stream())
    cuda.check(err, "q4k_gemm")
    q4k_gemm.launches += 1
    return y


q4k_gemm.launches = 0
