"""Linear-layer dispatch: dense tensors or quantized `QWeight`s.

A `QWeight` that zllm's kernels do not take (`ops/qmatmul.py::supports`:
K % 256 != 0, as a 32-block format's weight may have, or N % 128 != 0)
takes zllm's fallback, `dequant_linear`: x @ dequant(w, x's dtype) by
`torch.matmul`, as f32, the weight dequantized at each call.  Any other
`QWeight` goes to its format's decode matvec kernel for one row (K1 for
the nibble formats Q4_K, Q4_0, Q4_1, Q5_0, Q5_1 and Q5_K, or K12 / K11
under the switches `ops/qmatmul.py::matvec` names; K4 for Q6_K, Q8_0,
Q2_K, Q3_K, IQ4_NL, IQ4_XS, MXFP4, TQ1_0, TQ2_0 and the IQ grid formats
but IQ1_M, whose matvec is K5's) and to its prefill GEMM kernel for more (K3, K5);
all return f32, as `zllm`'s kernels do.  The fused decode hooks put the
RMS norm or the SwiGLU gating into the matvec's prologue (counterpart of
`zllm/ops/linear.py`'s fused_norm_linear / fused_glu_linear, without the
global hook registry: the port always has its kernels); for an IQ1_M
weight they decline, and the caller norms or gates first, as zllm's
hooks decline a format outside `_INT_FMT`.  A dense weight (F32, F16,
BF16) is cast to x's dtype and multiplied by `torch.matmul`, as zllm's
`w.astype(x.dtype)` product outside any Pallas kernel.  A format the port
has no kernel for raises NotImplementedError."""

from __future__ import annotations

import torch

from ..quant.repack import QWeight
from . import qmatmul as qmm


# a dense product of the dequantizing route takes its rows in blocks of
# this many on the card (`rows_matmul`)
DENSE_ROWS = 16


def rows_matmul(x2: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """x2 [M, K] @ wd [K, N] (one dtype) by `torch.matmul`; on the card x2
    in blocks of DENSE_ROWS rows (the last zero-padded), one matmul shape
    for every M: the library picks its kernel by shape, so a row's bits
    then do not depend on the rows beside it, as K3's and K5's do not (the
    engine batches rows of many requests)."""
    if x2.device.type == "cpu":
        return x2 @ wd
    m, pad = x2.shape[0], (-x2.shape[0]) % DENSE_ROWS
    xp = torch.cat([x2, x2.new_zeros((pad, x2.shape[1]))]) if pad else x2
    return torch.cat([xp[i:i + DENSE_ROWS] @ wd for i in range(0, m + pad, DENSE_ROWS)])[:m]


def dequant_linear(x2: torch.Tensor, w: QWeight) -> torch.Tensor:
    """zllm's fallback for a weight its kernels do not take (`qmm.supports`
    false): x2 [M, K] @ dequant(w, x2's dtype) by `torch.matmul`, as f32.
    The weight stays quantized on the device and is dequantized at each
    call (zllm's values: f32, then x2's dtype), read as the transpose of
    its [N, K] rows."""
    dequant_linear.calls += 1
    return rows_matmul(x2, w.dequant_nk().to(x2.dtype).t()).float()


dequant_linear.calls = 0


def linear(x: torch.Tensor, w, bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w (+ bias).  x: [..., K]; w: QWeight or a dense [K, N] tensor."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QWeight) and not qmm.supports(w):
        y2 = dequant_linear(x2, w)
    elif isinstance(w, QWeight):
        # the kernels read x row-major: a step's last column (logits_for=
        # "last" at B > 1, T > 1) is a strided view
        x2 = x2.contiguous()
        y2 = qmm.matvec(x2, w) if x2.shape[0] == 1 else qmm.gemm(x2, w)
    else:
        y2 = x2 @ w.to(x.dtype)
    y = y2.reshape(*lead, -1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def fused_norm_linear(x2: torch.Tensor, wn: torch.Tensor, eps: float, w):
    """rms_norm(x2, wn, eps) @ w in one kernel, or None (fallback)."""
    if not isinstance(w, QWeight) or x2.shape[0] != 1 or not qmm.fuses(w):
        return None
    return qmm.matvec(x2, w, fuse="norm", aux=wn, eps=eps)


def fused_glu_linear(gup2: torch.Tensor, w):
    """swiglu(gup2 halves) @ w in one kernel, or None (fallback)."""
    if (not isinstance(w, QWeight) or gup2.shape[0] != 1 or gup2.shape[1] != 2 * w.shape[0]
            or not qmm.fuses(w)):
        return None
    return qmm.matvec(gup2, w, fuse="glu")
