"""Linear-layer dispatch: dense tensors or quantized `QWeight`s.

A `QWeight` goes to the decode matvec kernel (K1) for one row and to the
prefill GEMM kernel (K3) for more; both return f32, as `zllm`'s kernels
do.  The fused decode hooks put the RMS norm or the SwiGLU gating into the
matvec's prologue (counterpart of `zllm/ops/linear.py`'s
fused_norm_linear / fused_glu_linear, without the global hook registry:
the port always has its kernels)."""

from __future__ import annotations

import torch

from ..quant.repack import QWeight
from .qmatmul import q4k_gemm, q4k_matvec


def linear(x: torch.Tensor, w, bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w (+ bias).  x: [..., K]; w: QWeight or a dense [K, N] tensor."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QWeight):
        y2 = q4k_matvec(x2, w) if x2.shape[0] == 1 else q4k_gemm(x2, w)
    else:
        y2 = x2 @ w.to(x.dtype)
    y = y2.reshape(*lead, -1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def fused_norm_linear(x2: torch.Tensor, wn: torch.Tensor, eps: float, w):
    """rms_norm(x2, wn, eps) @ w in one kernel, or None (fallback)."""
    if not isinstance(w, QWeight) or x2.shape[0] != 1:
        return None
    return q4k_matvec(x2, w, fuse="norm", aux=wn, eps=eps)


def fused_glu_linear(gup2: torch.Tensor, w):
    """swiglu(gup2 halves) @ w in one kernel, or None (fallback)."""
    if not isinstance(w, QWeight) or gup2.shape[0] != 1 or gup2.shape[1] != 2 * w.shape[0]:
        return None
    return q4k_matvec(gup2, w, fuse="glu")
