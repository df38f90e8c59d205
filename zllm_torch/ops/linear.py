"""Linear-layer dispatch: dense tensors or quantized `QWeight`s.

A `QWeight` goes to its format's decode matvec kernel for one row (K1 for
Q4_K, K4 for Q6_K and Q8_0) and to its prefill GEMM kernel for more (K3,
K5); all return f32, as `zllm`'s kernels do.  The fused decode hooks put
the RMS norm or the SwiGLU gating into the matvec's prologue (counterpart
of `zllm/ops/linear.py`'s fused_norm_linear / fused_glu_linear, without
the global hook registry: the port always has its kernels).  A format the
port has no kernel for raises NotImplementedError."""

from __future__ import annotations

import torch

from ..quant.repack import QWeight
from . import qmatmul as qmm


def linear(x: torch.Tensor, w, bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w (+ bias).  x: [..., K]; w: QWeight or a dense [K, N] tensor."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QWeight):
        y2 = qmm.matvec(x2, w) if x2.shape[0] == 1 else qmm.gemm(x2, w)
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
    return qmm.matvec(x2, w, fuse="norm", aux=wn, eps=eps)


def fused_glu_linear(gup2: torch.Tensor, w):
    """swiglu(gup2 halves) @ w in one kernel, or None (fallback)."""
    if not isinstance(w, QWeight) or gup2.shape[0] != 1 or gup2.shape[1] != 2 * w.shape[0]:
        return None
    return qmm.matvec(gup2, w, fuse="glu")
