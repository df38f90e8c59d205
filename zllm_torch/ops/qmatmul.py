"""Quantized matmuls on `QWeight`s: the decode matvecs (K1, K12, K11, K4)
and the prefill GEMMs (K3, K5), each a hand-written CUDA kernel with its
plain PyTorch version beside it.  `matvec` and `gemm` dispatch on the
weight's format: the nibble formats Q4_K, Q4_0, Q4_1, Q5_0, Q5_1 and Q5_K
to K1/K3 (K12 or K11 instead of K1 under the switches `matvec` names, for
the formats those take), Q6_K, Q8_0, Q2_K, Q3_K, IQ4_NL, IQ4_XS, MXFP4 and
the IQ grid formats IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S and IQ1_S, and
the ternary TQ1_0 and TQ2_0 to K4/K5, and IQ1_M to K5 alone (its matvec
too, as zllm runs it).

  * `q4k_matvec` (K1) replaces `zllm/ops/qmatmul.py::_w4a8np_kernel` (via
    `_qmm_w4a8np_call`) for the six nibble formats: M=1, activations
    quantized to int8 per 32-group after an optional RMS-norm
    (`fuse="norm"`) or SwiGLU (`fuse="glu"`) prologue, integer group dots
    against the 4- or 5-bit codes, then zllm's epilogue in f32: Q4_K, Q4_1,
    Q5_1 and Q5_K `pi*a*dx - b*(dx*sum(xq))`, Q4_0 `(pi - 8*sum(xq))*d*dx`
    and Q5_0 `(pi - 16*sum(xq))*d*dx` (the offset in integers).  Source:
    `zllm_torch/csrc/q4k_matvec.cu`.
  * `q4k_matvec_hbm` (K12) replaces `zllm/ops/qmatmul.py::_w4a8np_hbm_kernel`
    (via `_qmm_w4a8np_hbm_call`, which zllm takes when `ZLLM_QMM_HBM=1`)
    for Q4_K, Q4_0 and Q4_1 (zllm's refuses a 5-bit weight): K1's maths,
    prologues and launch machinery, the packed nibbles streamed into a ring
    of shared-memory stages a warp by bulk copies completed on mbarriers
    (the scales loaded as K1 loads them), bit-identical to K1.
    Its plain version is K1's.  Source: `zllm_torch/csrc/q4k_matvec_hbm.cu`.
  * `w4a8dd_matvec` (K11) replaces `zllm/ops/qmatmul.py::_w4a8dd_kernel`
    (via `_qmm_w4a8dd_call`, under `ZLLM_QMM_DUALDOT=1`) for Q4_0 and Q4_1:
    one launch a call, each block quantizing the activation row (int8
    codes, dx and e = dx*sum(xq) per 32-group, as zllm's `_quant_acts`),
    then each packed byte dotted whole through two signed views; epilogue
    Q4_0 `(pi - 8*s)*d*dx`, Q4_1 `pi*a*dx - b*e`.  `quantize_acts` is that
    quantize as an op of its own.  Source: `zllm_torch/csrc/w4a8dd_matvec.cu`.
  * `int8_matvec` (K4) replaces `zllm/ops/qmatmul.py::_w4a8_kernel` (via
    `_qmm_w4a8_call`) for Q6_K, Q8_0, Q2_K, Q3_K, IQ4_NL, IQ4_XS, MXFP4,
    IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, TQ1_0 and TQ2_0: the
    same prologues,
    with int8 groups of the format's width (16 for Q6_K, Q2_K, Q3_K, IQ2_XS
    and IQ2_S, 32 for the others), integer group dots against the integer
    codes (`_int_qtile`'s: Q2_K's unsigned, IQ4's, MXFP4's and the IQ grid
    formats' table values, IQ1_S's, TQ1_0's and TQ2_0's crumb - 1), then
    `pi*a*dx` in f32, less
    `b*(dx*sum(xq))` for Q2_K's and IQ1_S's min.  Source:
    `zllm_torch/csrc/int8_matvec.cu`.
  * `q4k_gemm` (K3) replaces `zllm/ops/qmatmul.py::_qmm_np_kernel` (via
    `_qmm_np_call`) for the six nibble formats and `dequant_gemm` (K5)
    replaces `_qmm_kernel` (via `_qmm_call`) for K4's fifteen and IQ1_M
    (at any M, M = 1 included): [M, K] x
    dequant(W) with x and the dequantized weight both rounded to bf16 in
    the kernel and products accumulated in f32.  Sources: `zllm_torch/csrc/q4k_gemm.cu`
    and `dequant_gemm.cu`, a weight decoder per format on one loop, the
    sliced loop `gemm_slice.cuh`: zllm's k-slice sum order (`_qmm_kernel`'s;
    zllm's K3 moves its own k-step with M), so a row's bits do not depend
    on M; `slice_plan` picks its form and split.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each wrapper counts its launches in
`.launches`.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import os

import torch

from ..gguf.constants import GGMLType
from ..quant.repack import IntWeight, NibbleWeight, QWeight
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
    amax = xg.abs().amax(dim=-1)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # product with its reciprocal, which can miss the quotient by an ulp
    dx = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    xq = torch.clamp(torch.round(xg / dx[:, None]), -127, 127)
    return xq, dx, xq.sum(dim=-1)


def _nibble_epilogue(pi, w: NibbleWeight, dx, sx, e=None):
    """zllm's per-group f32 epilogue of the nibble formats over exact
    integer group dots `pi` [N, G] (f32): Q4_0 (pi - 8*sx)*d*dx and Q5_0
    (pi - 16*sx)*d*dx, the offset applied to the integers; Q4_K, Q4_1, Q5_1
    and Q5_K pi*a*dx - b*e, e = dx*sx unless given."""
    if w.OFFSET:
        pi = pi - w.OFFSET * sx
    a, b = w.group_scales()
    c = pi * a * dx
    if b is not None:
        c = c - b * (dx * sx if e is None else e)
    return c


def q4k_matvec_plain(x, w: NibbleWeight, fuse="q", aux=None, eps=0.0) -> torch.Tensor:
    """Plain version of K1: y [1, N] f32."""
    k, n = w.shape
    xq, dx, sx = quantize_groups(_prologue(x, k, fuse, aux, eps))
    codes = w.codes().float().reshape(n, k // 32, 32)
    # |partial sums| <= 32*31*127 < 2^24: the f32 group dots are exact integers
    pi = (codes * xq[None]).sum(dim=-1)  # [N, G]
    return _nibble_epilogue(pi, w, dx, sx).sum(dim=-1).reshape(1, n)


def _check_qweight(w: QWeight, dev):
    planes = list(w.planes().values())
    cuda.require_cuda(*planes, aligned=planes)
    if w.device != dev:
        raise ValueError(f"weight on {w.device}, activations on {dev}")
    w.validate()
    if w.shape[0] % 256:
        raise ValueError(f"K={w.shape[0]} is not a multiple of 256")


# the nibble formats K1 and K3 take (the `fmt` argument of their C entry
# points, and of K12's and K11's), those K12 takes and those K11 takes:
# zllm sends no 5-bit weight to either of those two
NIBBLE_FMT_CODE = {GGMLType.Q4_K: 0, GGMLType.Q4_0: 1, GGMLType.Q4_1: 2, GGMLType.Q5_0: 3,
                   GGMLType.Q5_1: 4, GGMLType.Q5_K: 5}
HBM_FMTS = (GGMLType.Q4_K, GGMLType.Q4_0, GGMLType.Q4_1)
DUALDOT_FMTS = (GGMLType.Q4_0, GGMLType.Q4_1)


def _require_nibble(w: QWeight, formats=NIBBLE_FMT_CODE, what="K1/K3"):
    if w.fmt not in formats:
        raise NotImplementedError(f"{what} take {', '.join(f.name for f in formats)}, "
                                  f"not {w.fmt.name}")


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
    if x.dtype not in cuda.ACT_DTYPES:
        raise ValueError(f"activation dtype {x.dtype}")
    if fuse == "norm" and aux.dtype != torch.float32:
        raise ValueError("norm weight must be float32")


# the C entry points zt_q4k_matvec (K1) and zt_q4k_matvec_hbm (K12)
NIBBLE_MATVEC_ARGTYPES = [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]


def nibble_matvec_call(fn, x, w: NibbleWeight, fuse, aux, eps) -> tuple[int, torch.Tensor]:
    """One call of a K1/K12 entry point `fn` on checked inputs: (CUDA
    error code, y [1, N] f32)."""
    k, n = w.shape
    y = torch.empty((1, n), dtype=torch.float32, device=x.device)
    err = fn(NIBBLE_FMT_CODE[w.fmt], x.data_ptr(), cuda.DTYPE_CODE[x.dtype],
             cuda.ptr(aux) if fuse == "norm" else None, *_plane_ptrs(w, 5), y.data_ptr(), k, n,
             FUSE_CODE[fuse], float(eps), cuda.stream())
    return err, y


def _nibble_matvec(name: str, x, w: NibbleWeight, fuse, aux, eps) -> torch.Tensor:
    """Launch K1 or K12 (C entry point zt_<name>) after the common checks."""
    _check_cuda_x(x, fuse, aux)
    _check_qweight(w, x.device)
    cuda.require_cuda(x, *([aux] if fuse == "norm" else []))
    err, y = nibble_matvec_call(cuda.bind(name, f"zt_{name}", NIBBLE_MATVEC_ARGTYPES), x, w,
                                fuse, aux, eps)
    cuda.check(err, name)
    return y


def q4k_matvec(x: torch.Tensor, w: NibbleWeight, fuse: str = "q",
               aux: torch.Tensor | None = None, eps: float = 0.0) -> torch.Tensor:
    """y[1, N] f32 = prologue(x) @ dequant(w) on the int8 path, w Q4_K, Q4_0,
    Q4_1, Q5_0, Q5_1 or Q5_K.

    fuse="q": x [1, K];  "norm": x is the raw residual [1, K], aux the RMS
    weight [K];  "glu": x is the fused gate|up row [1, 2K]."""
    _require_nibble(w)
    _check_matvec_args(x, w.shape[0], fuse, aux)
    if x.device.type == "cpu":
        return q4k_matvec_plain(x, w, fuse, aux, eps)
    y = _nibble_matvec("q4k_matvec", x, w, fuse, aux, eps)
    q4k_matvec.launches += 1
    return y


q4k_matvec.launches = 0


# ---------------------------------------------------------------------------
# K12: decode matvec with the packed nibbles streamed through shared memory
# ---------------------------------------------------------------------------

q4k_matvec_hbm_plain = q4k_matvec_plain


def q4k_matvec_hbm(x: torch.Tensor, w: NibbleWeight, fuse: str = "q",
                   aux: torch.Tensor | None = None, eps: float = 0.0) -> torch.Tensor:
    """K1's function (y[1, N] f32; x, w and fuse as for `q4k_matvec`)
    through K12, whose nibble fetch is a ring of bulk-copied stages in
    shared memory; w Q4_K, Q4_0 or Q4_1."""
    _require_nibble(w, HBM_FMTS, "K12")
    _check_matvec_args(x, w.shape[0], fuse, aux)
    if x.device.type == "cpu":
        return q4k_matvec_hbm_plain(x, w, fuse, aux, eps)
    y = _nibble_matvec("q4k_matvec_hbm", x, w, fuse, aux, eps)
    q4k_matvec_hbm.launches += 1
    return y


q4k_matvec_hbm.launches = 0


def q4k_matvec_hbm_layout(k: int) -> tuple[int, int]:
    """(stages a warp's ring holds, dynamic shared memory of a block in
    bytes) of a K12 launch with K = k, as the kernel library reports them
    (builds it on first use)."""
    stages, smem = ctypes.c_int(), ctypes.c_longlong()
    fn = cuda.bind("q4k_matvec_hbm", "zt_q4k_matvec_hbm_layout",
                   [_I, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)])
    cuda.check(fn(k, ctypes.byref(stages), ctypes.byref(smem)), "q4k_matvec_hbm_layout")
    return stages.value, smem.value


# ---------------------------------------------------------------------------
# K11: dual-view decode matvec (each packed byte dotted whole), the
# activation quantize in the same launch
# ---------------------------------------------------------------------------

def quantize_acts_plain(x: torch.Tensor):
    """zllm's `_quant_acts` for one row x [1, K]: (xq int8 [K], dx f32
    [K/32], e = dx*sum(xq) f32 [K/32])."""
    xq, dx, sx = quantize_groups(x.reshape(-1).float())
    return xq.reshape(-1).to(torch.int8), dx, dx * sx


def quantize_acts(x: torch.Tensor):
    """(xq, dx, e) of `quantize_acts_plain`; on a CUDA tensor one launch of
    the quantize kernel in `csrc/w4a8dd_matvec.cu` (one block), bit-equal to
    the plain version.  K11 quantizes inside its own launch and does not
    call this."""
    k = x.numel()
    if k % 256 or (x.dim() == 2 and x.shape[0] != 1):
        raise ValueError(f"quantize_acts wants one row of K % 256 == 0, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_acts_plain(x)
    _check_cuda_x(x, "q", None)
    cuda.require_cuda(x)
    xq = torch.empty(k, dtype=torch.int8, device=x.device)
    dx = torch.empty(k // 32, dtype=torch.float32, device=x.device)
    e = torch.empty_like(dx)
    fn = cuda.bind("w4a8dd_matvec", "zt_quantize_acts", [_P, _I, _P, _P, _P, _I, _P])
    err = fn(x.data_ptr(), cuda.DTYPE_CODE[x.dtype], xq.data_ptr(), dx.data_ptr(), e.data_ptr(),
             k, cuda.stream())
    cuda.check(err, "quantize_acts")
    return xq, dx, e


def w4a8dd_matvec_plain(xq: torch.Tensor, dx: torch.Tensor, e: torch.Tensor,
                        w: NibbleWeight) -> torch.Tensor:
    """Plain version of K11's dot: y [1, N] f32 from the quantized row."""
    k, n = w.shape
    xg = xq.float().reshape(k // 32, 32)
    codes = w.codes().float().reshape(n, k // 32, 32)
    pi = (codes * xg[None]).sum(dim=-1)  # exact integers, as in K1
    return _nibble_epilogue(pi, w, dx, xg.sum(dim=-1), e).sum(dim=-1).reshape(1, n)


# the C entry point zt_w4a8dd_matvec: fmt, x, x_dtype, qs, s0, s1, y, K, N, stream
W4A8DD_ARGTYPES = [_I, _P, _I, _P, _P, _P, _P, _I, _I, _P]


def w4a8dd_matvec(x: torch.Tensor, w: NibbleWeight) -> torch.Tensor:
    """y[1, N] f32 = x @ dequant(w) for a Q4_0 or Q4_1 weight: x [1, K]
    quantized as `quantize_acts` does, then K11's dual-view dot, in one
    launch (no prologue: zllm's norm and glu prologues never reach K11)."""
    _require_nibble(w, DUALDOT_FMTS, "K11")
    k, n = w.shape
    _check_matvec_args(x, k, "q", None)
    if x.device.type == "cpu":
        return w4a8dd_matvec_plain(*quantize_acts_plain(x), w)
    _check_cuda_x(x, "q", None)
    _check_qweight(w, x.device)
    cuda.require_cuda(x)
    y = torch.empty((1, n), dtype=torch.float32, device=x.device)
    fn = cuda.bind("w4a8dd_matvec", "zt_w4a8dd_matvec", W4A8DD_ARGTYPES)
    err = fn(NIBBLE_FMT_CODE[w.fmt], x.data_ptr(), cuda.DTYPE_CODE[x.dtype],
             *_plane_ptrs(w, 3), y.data_ptr(), k, n, cuda.stream())
    cuda.check(err, "w4a8dd_matvec")
    w4a8dd_matvec.launches += 1
    return y


w4a8dd_matvec.launches = 0


# ---------------------------------------------------------------------------
# K4: decode matvec for the integer-code formats
# ---------------------------------------------------------------------------

# the formats K5 takes, and K4 all but K5_ONLY (the `fmt` argument of
# their C entry points); zllm's `_INT_FMT` leaves IQ1_M out (its a and b
# have two group widths), so its matvec runs on K5
INT8_FMT_CODE = {GGMLType.Q6_K: 0, GGMLType.Q8_0: 1, GGMLType.Q2_K: 2, GGMLType.Q3_K: 3,
                 GGMLType.IQ4_NL: 4, GGMLType.IQ4_XS: 5, GGMLType.MXFP4: 6,
                 GGMLType.IQ2_XXS: 7, GGMLType.IQ2_XS: 8, GGMLType.IQ2_S: 9,
                 GGMLType.IQ3_XXS: 10, GGMLType.IQ3_S: 11, GGMLType.IQ1_S: 12,
                 GGMLType.IQ1_M: 13, GGMLType.TQ1_0: 14, GGMLType.TQ2_0: 15}
K5_ONLY = (GGMLType.IQ1_M,)
K4_FMTS = tuple(f for f in INT8_FMT_CODE if f not in K5_ONLY)


def int8_matvec_plain(x, w: IntWeight, fuse="q", aux=None, eps=0.0) -> torch.Tensor:
    """Plain version of K4: y [1, N] f32, zllm's per-group epilogue
    pi*a*dx, less b*(dx*sx) where the format has a min (Q2_K, IQ1_S)."""
    k, n = w.shape
    xq, dx, sx = quantize_groups(_prologue(x, k, fuse, aux, eps), w.GROUP)
    codes = w.int_codes().float().reshape(n, k // w.GROUP, w.GROUP)
    # |partial sums| <= 32*128*127 < 2^24: the f32 group dots are exact integers
    pi = (codes * xq[None]).sum(dim=-1)  # [N, G]
    c = pi * w.group_scale() * dx
    b = w.group_min()
    if b is not None:
        c = c - b * (dx * sx)
    return c.sum(dim=-1).reshape(1, n)


def _plane_ptrs(w: QWeight, count: int) -> list[int | None]:
    """The weight's plane pointers, padded with None to the `count` a C
    entry point takes: K4/K5 three in PLANES order (Q6_K ql, qh, a; Q8_0
    qs, d; Q2_K qs, a, b; Q3_K qs, qh, a; IQ4_NL qs, d; IQ4_XS qs, a;
    MXFP4 qs, e; IQ2_*, IQ3_* qs, a; IQ1_S, IQ1_M qs, a, b; TQ1_0, TQ2_0
    qs, a); K1/K3/K12/K11
    five, `NibbleWeight.kernel_planes` (qs, then Q4_K
    sc, mn, d, dmin; Q4_0 d; Q4_1 a, b; Q5_0 d and Q5_1/Q5_K a, b, each
    with qh last)."""
    planes = (w.kernel_planes() if isinstance(w, NibbleWeight)
              else list(w.planes().values()))
    ptrs = [cuda.ptr(p) for p in planes]
    return ptrs + [None] * (count - len(ptrs))


def _check_int8_shape(w: QWeight, formats=INT8_FMT_CODE, what="K5"):
    if w.fmt not in formats:
        raise NotImplementedError(f"{what} takes {', '.join(f.name for f in formats)}, "
                                  f"not {w.fmt.name}")
    k, n = w.shape
    if k % 256 or n % 128:
        raise ValueError(f"K4/K5 take K % 256 == 0 and N % 128 == 0, not (K, N) = {w.shape}")


def int8_matvec(x: torch.Tensor, w: QWeight, fuse: str = "q", aux: torch.Tensor | None = None,
                eps: float = 0.0) -> torch.Tensor:
    """y[1, N] f32 = prologue(x) @ dequant(w) on the int8 path, w Q6_K,
    Q8_0, Q2_K, Q3_K, IQ4_NL, IQ4_XS, MXFP4, IQ2_XXS, IQ2_XS, IQ2_S,
    IQ3_XXS, IQ3_S, IQ1_S, TQ1_0 or TQ2_0; x and fuse as for
    `q4k_matvec`."""
    _check_int8_shape(w, K4_FMTS, "K4")
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
             cuda.ptr(aux) if fuse == "norm" else None, *_plane_ptrs(w, 3),
             y.data_ptr(), k, n, FUSE_CODE[fuse], float(eps), cuda.stream())
    cuda.check(err, "int8_matvec")
    int8_matvec.launches += 1
    return y


int8_matvec.launches = 0


# ---------------------------------------------------------------------------
# K3 / K5: prefill GEMMs
# ---------------------------------------------------------------------------

def slice_width(k: int) -> int:
    """zllm's k-step of `_qmm_kernel`: tk = 2 * fold = 512 when K % 512 == 0,
    else fold = 256 (its default ZLLM_QMM_TK_MULT=2)."""
    return 512 if k % 512 == 0 else 256


def dequant_gemm_plain(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """Plain version of K3 and K5: bf16(x) @ bf16(dequant(w)), f32
    accumulate, in zllm's `_qmm_kernel` sum order: one f32 product per
    k-slice of `slice_width(K)`, added to a zero output in slice order."""
    xb = x.to(torch.bfloat16).float()
    wb = w.dequant_nk().to(torch.bfloat16).float()
    k, tk = w.shape[0], slice_width(w.shape[0])
    y = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for s in range(0, k, tk):
        y += xb[:, s:s + tk] @ wb[:, s:s + tk].t()
    return y


q4k_gemm_plain = dequant_gemm_plain


def _check_gemm_x(x: torch.Tensor, k: int):
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"gemm wants [M, {k}], got {tuple(x.shape)}")


def _gemm_cuda_x(x: torch.Tensor, w: QWeight):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in cuda.ACT_DTYPES:
        raise ValueError(f"activation dtype {x.dtype}")
    _check_qweight(w, x.device)
    cuda.require_cuda(x, aligned=(x,))
    return torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)


ROW_M = 16  # the sliced loop's row form rows (split-K, one slice a block)
ROW_N, TILE_M, TILE_N = 32, 128, 128  # its row form's columns, its tile form block
# `slice_plan`'s cost model, fitted to the K3 and K5 calls of the models'
# prefill and engine shapes on an H100 (every form and split timed by
# `python -m zllm_torch.k5_ablation --plans`): a 64-wide step takes a
# tile-form block 1.6 us and the row form 1.5 ns a block on average over
# its grid; a call whose slices are split pays a launch (2 us) and moves
# its partials (the first split's prefix and each later slice's own) out
# and back, and y out, at 3 TB/s.
TILE_STEP_S, ROW_STEP_S, LAUNCH_S, MOVE_BYTES_PER_S = 1.6e-6, 1.5e-9, 2e-6, 3e12


def _split_seconds(m: int, n: int, slots: int) -> float:
    """The reduction of a split call: its launch and the partials' bytes."""
    return LAUNCH_S + (2 * slots + 1) * 4 * m * n / MOVE_BYTES_PER_S if slots > 1 else 0.0


def _rounds(blocks: int, spb: int, s: int, sms: int) -> int:
    """Slices until the last of `blocks` tiles x ceil(s / spb) splits ends,
    the blocks started in grid order (split after split) on `sms` SMs, one
    block each: the split's spb slices, the last split's remainder."""
    ends = [0] * sms
    for z in range(0, s, spb):
        for _ in range(blocks):
            heapq.heapreplace(ends, ends[0] + min(spb, s - z))
    return max(ends)


@functools.lru_cache(maxsize=None)
def slice_plan(m: int, k: int, n: int, sms: int) -> tuple[int, int, int, int]:
    """(tk, S, form, spb) of one K3 or K5 call: S slices of tk; form 0 (row
    form, one slice a block) or 1 (tile form); spb slices a block along the
    split (1 in the row form).  M <= 16 takes the row form; above, the form
    and split of least time in the cost model above (on ties the fewest
    splits, then the row form).  The launcher takes every plan made here:
    any M, any even N, tk 256 or 512 dividing K.  No choice here changes a
    value: every row is summed slice by slice in order whatever the form
    and the split."""
    tk = slice_width(k)
    s, steps = k // tk, tk // 64
    if m <= ROW_M:
        return tk, s, 0, 1
    row_blocks = -(-m // ROW_M) * -(-n // ROW_N) * s
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    cost = {0: row_blocks * steps * ROW_STEP_S + _split_seconds(m, n, s)}
    for spb in range(s, 0, -1):
        cost[spb] = (_rounds(tiles, spb, s, sms) * steps * TILE_STEP_S
                     + _split_seconds(m, n, s - spb + 1))
    best = min(cost, key=cost.get)
    return (tk, s, 0, 1) if best == 0 else (tk, s, 1, best)


def _sm_count(dev: torch.device) -> int:
    count = _SM_COUNT.get(dev.index)
    if count is None:
        count = _SM_COUNT[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return count


_SM_COUNT: dict[int | None, int] = {}


def slice_argtypes(n_planes: int) -> list:
    """ctypes argument types of a C entry point on the sliced loop
    (zt_q4k_gemm, zt_dequant_gemm): fmt, x, xdtype, xb, the weight's
    `n_planes` planes, y, ws, M, K, N, tk, form, spb, stream."""
    return [_I, _P, _I, _P, *[_P] * n_planes, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def slice_call(fn, fmt_code: int, x: torch.Tensor, w: QWeight, n_planes: int,
               y: torch.Tensor, plan: tuple[int, int, int, int] | None = None) -> int:
    """One call of `fn` (argument types `slice_argtypes`) into y with
    `slice_plan`'s tk, form and split (or `plan`'s), and the workspaces it
    needs: x rounded to bf16 when it is f32, the slice partials when the
    slices are split.  Returns the entry point's error code."""
    m, (k, n) = x.shape[0], w.shape
    tk, s, form, spb = plan or slice_plan(m, k, n, _sm_count(x.device))
    xb = torch.empty((m, k), dtype=torch.bfloat16, device=x.device) if x.dtype == torch.float32 \
        else None
    ws = (torch.empty((s - spb + 1, m, n), dtype=torch.float32, device=x.device)
          if spb < s else None)
    return fn(fmt_code, x.data_ptr(), cuda.DTYPE_CODE[x.dtype], cuda.ptr(xb),
              *_plane_ptrs(w, n_planes), y.data_ptr(), cuda.ptr(ws), m, k, n, tk, form, spb,
              cuda.stream())


def _slice_gemm(name: str, fmt_code: int, x: torch.Tensor, w: QWeight, n_planes: int):
    """K3 or K5 (library `name`, entry point zt_<name>) after the checks."""
    if w.shape[1] % 2:
        raise ValueError(f"the sliced GEMM loop takes an even N, not {w.shape[1]}")
    y = _gemm_cuda_x(x, w)
    fn = cuda.bind(name, f"zt_{name}", slice_argtypes(n_planes))
    cuda.check(slice_call(fn, fmt_code, x, w, n_planes, y), name)
    return y


def q4k_gemm(x: torch.Tensor, w: NibbleWeight) -> torch.Tensor:
    """y[M, N] f32 = x[M, K] @ dequant(w), through bf16 operands (Q4_K, Q4_0,
    Q4_1, Q5_0, Q5_1 or Q5_K), summed in `dequant_gemm_plain`'s slice
    order, on K5's loop and with its extra launches (see `dequant_gemm`); a
    call counts as one launch."""
    _require_nibble(w)
    k, n = w.shape
    _check_gemm_x(x, k)
    if x.device.type == "cpu":
        return dequant_gemm_plain(x, w)
    y = _slice_gemm("q4k_gemm", NIBBLE_FMT_CODE[w.fmt], x, w, 5)
    q4k_gemm.launches += 1
    return y


q4k_gemm.launches = 0


def dequant_gemm(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """y[M, N] f32 = x[M, K] @ dequant(w), through bf16 operands (Q6_K,
    Q8_0, Q2_K, Q3_K, IQ4_NL, IQ4_XS, MXFP4, IQ2_XXS, IQ2_XS, IQ2_S,
    IQ3_XXS, IQ3_S, IQ1_S, IQ1_M, TQ1_0 or TQ2_0), summed in
    `dequant_gemm_plain`'s slice order.  Besides the loop,
    an f32 x takes a launch that rounds it to bf16 (into a workspace), and
    a call whose slices are split over blocks one that reduces the slice
    partials (kept in a second workspace) in order; a call counts as one
    launch."""
    _check_int8_shape(w)
    k, n = w.shape
    _check_gemm_x(x, k)
    if x.device.type == "cpu":
        return dequant_gemm_plain(x, w)
    y = _slice_gemm("dequant_gemm", INT8_FMT_CODE[w.fmt], x, w, 3)
    dequant_gemm.launches += 1
    return y


dequant_gemm.launches = 0


# ---------------------------------------------------------------------------
# format dispatch
# ---------------------------------------------------------------------------

def matvec(x: torch.Tensor, w: QWeight, fuse: str = "q", aux: torch.Tensor | None = None,
           eps: float = 0.0) -> torch.Tensor:
    """The decode matvec for w's format.  Q6_K, Q8_0, Q2_K, Q3_K, IQ4_NL,
    IQ4_XS, MXFP4, the IQ grid formats, TQ1_0 and TQ2_0 -> K4 (the
    switches do not move them: zllm's `_hbm_np_ok` refuses TQ too), but
    IQ1_M, which K4 does not take, -> K5 at M = 1 with fuse="q" alone
    (`fuses` is False for it: the caller norms and gates first, as zllm's
    unfused route does).  The nibble formats Q4_K, Q4_0, Q4_1, Q5_0, Q5_1
    and Q5_K -> K1 by default, and under two switches, read from the
    environment at each dispatch (as zllm reads them at each trace):
      * ZLLM_QMM_HBM=1: K12 for every prologue of a Q4_K/Q4_0/Q4_1 weight
        (zllm's `_hbm_np_ok` refuses a weight with a qh plane);
      * ZLLM_QMM_DUALDOT=1: K11 for the fuse="q" matvecs of Q4_0/Q4_1
        weights; "norm" and "glu" stay on K1, as in zllm.
    A 5-bit weight stays on K1 under both.
    With both set K12 wins.  zllm takes K11 only for a weight its loader
    left out of the npack layout (ZLLM_NPACK=0, or N % 256 != 0), K12 only
    for an npack one, so the two never meet on one weight there; the port
    has one layout, so the switches alone decide.  The values do not depend
    on the route (K12 is K1 bit for bit; K11 differs from K1 in the f32 sum
    order only)."""
    if w.fmt in NIBBLE_FMT_CODE:
        if w.fmt in HBM_FMTS and os.environ.get("ZLLM_QMM_HBM", "0") == "1":
            return q4k_matvec_hbm(x, w, fuse, aux, eps)
        if (fuse == "q" and w.fmt in DUALDOT_FMTS
                and os.environ.get("ZLLM_QMM_DUALDOT", "0") == "1"):
            return w4a8dd_matvec(x, w)
        return q4k_matvec(x, w, fuse, aux, eps)
    if w.fmt in K5_ONLY:
        if fuse != "q":
            raise NotImplementedError(f"{w.fmt.name} has no fused {fuse!r} matvec")
        return dequant_gemm(x.reshape(1, -1), w)
    return int8_matvec(x, w, fuse, aux, eps)


def supports(w: QWeight) -> bool:
    """zllm's `supports` (`zllm/ops/qmatmul.py`): its Pallas matmuls take a
    weight whose K is a multiple of 256 (zllm's fold, `choose_fold`, is
    then 256) and whose N is a multiple of 128.  `ops/linear.py` sends any
    other weight (a 32-block format at K % 256 != 0, an N % 128 != 0) to
    zllm's fallback, x @ dequant(w), and no kernel of this module sees it."""
    k, n = w.shape
    return k % 256 == 0 and n % 128 == 0


def fuses(w: QWeight) -> bool:
    """Whether `matvec` takes w with the "norm" and "glu" prologues (not
    IQ1_M's K5, nor a weight `supports` refuses, as zllm's hooks decline
    both)."""
    return w.fmt not in K5_ONLY and supports(w)


def gemm(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """The prefill GEMM for w's format: the six nibble formats -> K3, the
    others (`INT8_FMT_CODE`) -> K5."""
    if w.fmt in NIBBLE_FMT_CODE:
        return q4k_gemm(x, w)
    return dequant_gemm(x, w)
