"""The IQ grid formats' encoders (IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S,
IQ1_S, IQ1_M), unweighted and importance-weighted, with the grid fit on
a torch device.

The counterpart of zllm's IQ encoders (`zllm/quant/blocks.py`, "IQ
grid-codebook ENCODERS"): each cell of 8 (IQ3: 4) weights takes the grid
row that minimises its weighted squared error at the cell's scale (a
product with the grid and an argmin over its rows, in chunks of cells),
alternating with weighted least-squares refits of the group scales, then
a two-level (superblock scale, per-group code) quantization of the
scales and a last pick; IQ1 fits its signed ternary grid once with each
sign of the delta and keeps the better per delta group.  Every step is
zllm's operation on f32 tensors in zllm's order: the sums over a cell or
a group add in numpy's pairwise order (`_np_sum`), a division by a
constant divides (`_div`: on the card `x / 3.875` multiplies by the
rounded reciprocal, which parted about 1 % of the IQ3 blocks from the
CPU's), and the grid products are `torch.matmul` in full f32 (TF32 off
for the call, whatever the caller's setting): over a cell's 4 or 8
columns MKL's and cuBLAS's sgemm both sum as the chain of fused
multiply-adds that numpy's BLAS runs for zllm.  So the fit gives zllm's
bytes on the CPU, and on the card the CPU's (every block equal where
measured; a score near-tie ordered otherwise by another product would
change that cell).  The byte packing is zllm's numpy.

The device is `cuda` unless the caller passes `cpu`; without a card an
encode for `cuda` raises, it never falls back to the host.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..gguf.constants import QK_K, GGMLType
from .blocks import _round_away, _to_f16_bytes, iq_grids

# score elements ([cells, grid rows]) a grid pick takes at once: 2^24 on
# the CPU (zllm's 65536 cells of the 256-row grids), 2^28 on the card
_SCORE_ELEMS = {"cpu": 1 << 24, "cuda": 1 << 28}


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "zllm_torch: an IQ grid encode on device 'cuda' was requested but no CUDA device "
            "is visible (torch.cuda.is_available() is False); pass device='cpu' to fit on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"zllm_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


@contextlib.contextmanager
def _full_f32():
    """Float32 matmuls in full precision (no TF32) for the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _np_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in numpy's float32 order (its pairwise_sum:
    under 8 terms one by one; up to 128 eight running sums, combined as
    ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the rest one
    by one; above 128 the two halves, split at a multiple of 8)."""
    n = x.shape[-1]
    if n < 8:
        acc = torch.zeros_like(x[..., 0])
        for i in range(n):
            acc = acc + x[..., i]
        return acc
    if n <= 128:
        r = x[..., :8]
        for i in range(8, n - n % 8, 8):
            r = r + x[..., i:i + 8]
        acc = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
            (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(n - n % 8, n):
            acc = acc + x[..., i]
        return acc
    n2 = n // 2
    n2 -= n2 % 8
    return _np_sum(x[..., :n2]) + _np_sum(x[..., n2:])


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v rounded once, as numpy divides: v as a 0-dim tensor on x's
    device (a CUDA division by a Python scalar multiplies by its rounded
    reciprocal instead)."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def _round(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (C roundf)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _chunk(g: int, dev: torch.device) -> int:
    return max(1, _SCORE_ELEMS[dev.type] // g)


def _grid_score_pick(a, wt, g_t, g2_t, db, chunk: int) -> torch.Tensor:
    """Weighted nearest grid row per cell: a, wt [C, L] targets and
    importance, g_t / g2_t [L, G] the grid and its squares transposed, db
    [C, 1] the cell's scale.  argmin_k sum_i wt_i (a_i - db g_ki)^2 =
    argmin_k (db^2 B - 2 db A)."""
    out = torch.empty(a.shape[0], dtype=torch.int64, device=a.device)
    with _full_f32():
        for s in range(0, a.shape[0], chunk):
            e = min(s + chunk, a.shape[0])
            A = (wt[s:e] * a[s:e]) @ g_t
            B = wt[s:e] @ g2_t
            dbs = db[s:e]
            out[s:e] = torch.argmin(B * (dbs * dbs) - 2.0 * dbs * A, dim=1)
    return out


def _ls_scale(a, wt, g, lo: float = 1e-8):
    """Weighted least-squares scale over the last dim: argmin_d sum wt (a - d g)^2."""
    num = _np_sum(wt * a * g)
    den = _np_sum(wt * g * g)
    return torch.clamp_min(num / torch.clamp_min(den, 1e-12), lo)


def _two_level(db, smax: int, off: float, mul: float):
    """Group scales db [N, G] -> (d [N, 1], s [N, G] codes, dbq) with
    dbq = d * (off + s) * mul."""
    d = _div(db.max(dim=-1, keepdim=True).values, (off + smax) * mul)
    d = torch.clamp_min(d, 1e-12)
    s = _round(db / (d * mul) - off).clamp(0, smax)
    return d, s, d * (off + s) * mul


def _ksign_codes(x_cells, wt, a, g, db) -> torch.Tensor:
    """7-bit ksign codes a cell of 8: the signs of elements 0..6, element
    7's sign implied by the parity; on a mismatch the cheapest element
    (weighted cost wt * a * grid * scale) flips."""
    neg = (x_cells < 0).to(torch.int64)
    c = torch.zeros(x_cells.shape[0], dtype=torch.int64, device=x_cells.device)
    for i in range(7):
        c |= neg[:, i] << i
    par = torch.zeros_like(c)
    for i in range(7):
        par ^= (c >> i) & 1
    mism = par != neg[:, 7]
    cost = wt * a * torch.clamp_min(g, 1e-9) * db
    flip = torch.argmin(cost, dim=1)
    do = mism & (flip < 7)
    return torch.where(do, c ^ (1 << flip.clamp(max=6)), c)


def _weights(w: torch.Tensor | None, x: torch.Tensor, rows: int, cell: int) -> torch.Tensor:
    """The cells' importance [rows, cell]: the imatrix weights (floored at
    1e-12), or without them x^2 plus the block's mean x^2 (floored at 1e-9)."""
    n = x.shape[0]
    if w is not None:
        return torch.clamp_min(w.reshape(rows, cell), 1e-12)
    x2 = x * x
    mean = _div(_np_sum(x2.reshape(n, 1, -1))[..., None], QK_K)
    return torch.clamp_min(mean + x2.reshape(n, rows // n, cell), 1e-9).reshape(rows, cell)


def _repeat_cells(v: torch.Tensor, per: int) -> torch.Tensor:
    """Per-group values [N, G] -> per-cell [N * G * per, 1]."""
    return torch.repeat_interleave(v.reshape(-1, 1), per, dim=0)


def _iq_fit(x, w, grid, cell: int, spg: int, smax: int, off: float, mul: float, chunk: int,
            iters: int = 3):
    """The magnitude fit of the IQ2/IQ3 formats: x [N, 256] -> (idx [N, C]
    grid rows, d [N, 1], s [N, G] scale codes, dbq [N, G], a, wt, the
    picked rows) for C = 256 / cell cells and G = 256 / spg groups."""
    n = x.shape[0]
    ncell, ng = QK_K // cell, QK_K // spg
    cpg = ncell // ng
    a = torch.abs(x).reshape(n * ncell, cell)
    wt = _weights(w, x, n * ncell, cell)
    g_t, g2_t = grid.t().contiguous(), (grid * grid).t().contiguous()
    gmax = float(grid.max())
    db_g = _div(torch.clamp_min(a.reshape(n, ng, spg).max(dim=-1).values, 1e-9), gmax)
    for _ in range(iters):
        idx = _grid_score_pick(a, wt, g_t, g2_t, _repeat_cells(db_g, cpg), chunk)
        db_g = _ls_scale(a.reshape(n, ng, spg), wt.reshape(n, ng, spg),
                         grid[idx].reshape(n, ng, spg))
    d, s, dbq = _two_level(db_g, smax, off, mul)
    idx = _grid_score_pick(a, wt, g_t, g2_t, _repeat_cells(dbq, cpg), chunk)
    return idx.reshape(n, ncell), d, s, dbq, a, wt, grid[idx]


def _signs(x, wt, a, gsel, dbq, per: int) -> torch.Tensor:
    """The ksign codes of x's 8-wide cells [N, 32] (dbq repeated `per`
    times a group gives each sign cell its scale)."""
    n = x.shape[0]
    return _ksign_codes(x.reshape(n * 32, 8), wt.reshape(n * 32, 8), a.reshape(n * 32, 8),
                        gsel.reshape(n * 32, 8), _repeat_cells(dbq, per)).reshape(n, 32)


def _iq1_fit(x, w, grid, spg: int, dpg: int, chunk: int):
    """The IQ1 fit: the signed ternary grid shifted by +-0.125 a delta
    group.  spg: weights a scale group; dpg: weights a delta group.
    Returns idx [N, 32], dl [N, G], delta_neg [N, D]."""
    n = x.shape[0]
    ncell, ng = QK_K // 8, QK_K // spg
    cpg, cpd = ncell // ng, dpg // 8
    xv = x.reshape(n * ncell, 8)
    wt = _weights(w, x, n * ncell, 8)
    dl0 = torch.clamp_min(torch.abs(x).reshape(n, ng, spg).max(dim=-1).values, 1e-9)
    passes = []
    for delta in (0.125, -0.125):
        gd = grid + delta
        g_t, g2_t = gd.t().contiguous(), (gd * gd).t().contiguous()
        dlc = dl0
        for _ in range(3):
            idx = _grid_score_pick(xv, wt, g_t, g2_t, _repeat_cells(dlc, cpg), chunk)
            dlc = _ls_scale(xv.reshape(n, ng, spg), wt.reshape(n, ng, spg),
                            gd[idx].reshape(n, ng, spg))
        db_c = _repeat_cells(dlc, cpg)
        r = xv - db_c * gd[idx]
        err = _np_sum((wt * (r * r)).reshape(n, QK_K // dpg, -1))
        passes.append((idx.reshape(n, ncell), err))
    dneg = passes[1][1] < passes[0][1]  # [N, D]: True -> delta -0.125
    sel_c = torch.repeat_interleave(dneg, cpd, dim=1)
    idx = torch.where(sel_c, passes[1][0], passes[0][0])
    delta_c = torch.where(sel_c, -0.125, 0.125).to(torch.float32)
    gd_sel = grid[idx.reshape(-1)] + delta_c.reshape(-1, 1)
    dl = _ls_scale(xv.reshape(n, ng, spg), wt.reshape(n, ng, spg), gd_sel.reshape(n, ng, spg))
    return idx, dl, dneg


def _np(*ts):
    return [t.cpu().numpy() for t in ts]


def _u32le(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype("<u4")).view(np.uint8)


def _u16le(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype("<u2")).view(np.uint8)


def _pack_aux(signs: np.ndarray, s: np.ndarray) -> np.ndarray:
    """IQ2_XXS / IQ3_XXS: four 7-bit sign codes and the 4-bit scale code a
    group -> u32 [n, 8]."""
    n = signs.shape[0]
    sg = signs.astype(np.uint32).reshape(n, 8, 4)
    return (sg[..., 0] | (sg[..., 1] << 7) | (sg[..., 2] << 14) | (sg[..., 3] << 21)
            | (s.astype(np.uint32) << 28))


def _sign_bytes(x: np.ndarray) -> np.ndarray:
    """The raw sign byte of each 8 weights (bit i: element i negative)."""
    n = x.shape[0]
    neg = x.reshape(n, 32, 8) < 0
    sbytes = np.zeros((n, 32), np.uint8)
    for i in range(8):
        sbytes |= neg[:, :, i].astype(np.uint8) << i
    return sbytes


def _enc_iq2_xxs(x, w, grid, chunk):
    idx, d, s, dbq, a, wt, gsel = _iq_fit(x, w, grid, 8, 32, 15, 0.5, 0.25, chunk)
    signs = _signs(x, wt, a, gsel, dbq, 4)
    idx, d, s, signs = _np(idx, d, s, signs)
    n = idx.shape[0]
    codes = idx.astype(np.uint32).reshape(n, 8, 4)
    u32 = np.empty((n, 8, 2), "<u4")
    u32[:, :, 0] = codes[..., 0] | (codes[..., 1] << 8) | (codes[..., 2] << 16) \
        | (codes[..., 3] << 24)
    u32[:, :, 1] = _pack_aux(signs, s)
    return np.concatenate([_to_f16_bytes(d), u32.reshape(n, -1).view(np.uint8)], axis=1)


def _enc_iq2_xs(x, w, grid, chunk):
    idx, d, s, dbq, a, wt, gsel = _iq_fit(x, w, grid, 8, 16, 15, 0.5, 0.25, chunk)
    signs = _signs(x, wt, a, gsel, dbq, 2)
    idx, d, s, signs = _np(idx, d, s, signs)
    s = s.astype(np.uint8)
    qs = idx.astype("<u2") | (signs.astype("<u2") << 9)  # [n, 32]
    sl = (s[:, 0::2] | (s[:, 1::2] << 4)).astype(np.uint8)  # [n, 8]
    return np.concatenate([_to_f16_bytes(d), _u16le(qs), sl], axis=1)


def _enc_iq2_s(x, w, grid, chunk):
    idx, d, s, *_ = _iq_fit(x, w, grid, 8, 16, 15, 0.5, 0.25, chunk)
    idx, d, s, xn = _np(idx, d, s, x)
    n = idx.shape[0]
    s = s.astype(np.uint8)
    hi4 = (idx >> 8).astype(np.uint8).reshape(n, 8, 4)  # 2 bits a cell
    qh = np.zeros((n, 8), np.uint8)
    for i in range(4):
        qh |= (hi4[:, :, i] & 3) << (2 * i)
    sl = (s[:, 0::2] | (s[:, 1::2] << 4)).astype(np.uint8)
    return np.concatenate([_to_f16_bytes(d), (idx & 0xFF).astype(np.uint8), _sign_bytes(xn), qh,
                           sl], axis=1)


def _enc_iq3_xxs(x, w, grid, chunk):
    idx, d, s, dbq, a, wt, gsel = _iq_fit(x, w, grid, 4, 32, 15, 0.5, 0.5, chunk)
    signs = _signs(x, wt, a, gsel, dbq, 4)  # a sign code a pair of 4-wide cells
    idx, d, s, signs = _np(idx, d, s, signs)
    return np.concatenate([_to_f16_bytes(d), idx.astype(np.uint8), _u32le(_pack_aux(signs, s))],
                          axis=1)


def _enc_iq3_s(x, w, grid, chunk):
    idx, d, s, *_ = _iq_fit(x, w, grid, 4, 32, 15, 0.5, 2.0, chunk)
    idx, d, s, xn = _np(idx, d, s, x)
    n = idx.shape[0]
    s = s.astype(np.uint8)
    hibit = (idx >> 8).astype(np.uint8).reshape(n, 8, 8)
    qh = np.zeros((n, 8), np.uint8)
    for i in range(8):
        qh |= (hibit[:, :, i] & 1) << i
    sl = (s[:, 0::2] | (s[:, 1::2] << 4)).astype(np.uint8)  # [n, 4]
    return np.concatenate([_to_f16_bytes(d), (idx & 0xFF).astype(np.uint8), qh, _sign_bytes(xn),
                           sl], axis=1)


def _iq1_scales(dl: np.ndarray):
    """dl [n, G] = d * (2 s + 1) -> (d [n, 1], s uint16 [n, G] in 0..7)."""
    d = np.maximum(dl.max(axis=-1, keepdims=True) / 15.0, 1e-12)
    return d, _round_away((dl / d - 1.0) / 2.0).clip(0, 7).astype(np.uint16)


def _enc_iq1_s(x, w, grid, chunk):
    idx, dl, dneg = _np(*_iq1_fit(x, w, grid, 32, 32, chunk))
    n = idx.shape[0]
    d, s = _iq1_scales(dl)
    hi = (idx >> 8).astype(np.uint16).reshape(n, 8, 4)  # 3 bits x 4 cells
    qh = (hi[:, :, 0] | (hi[:, :, 1] << 3) | (hi[:, :, 2] << 6) | (hi[:, :, 3] << 9)
          ).astype(np.uint16)
    qh |= s << 12
    qh |= dneg.astype(np.uint16) << 15
    return np.concatenate([_to_f16_bytes(d), (idx & 0xFF).astype(np.uint8), _u16le(qh)], axis=1)


def _enc_iq1_m(x, w, grid, chunk):
    idx, dl, dneg = _np(*_iq1_fit(x, w, grid, 16, 8, chunk))
    n = idx.shape[0]
    d, s = _iq1_scales(dl)  # s [n, 16]
    nib = ((idx >> 8).astype(np.uint8) | (dneg.astype(np.uint8) << 3)).reshape(n, 16, 2)
    qh = (nib[:, :, 0] | (nib[:, :, 1] << 4)).astype(np.uint8)  # [n, 16]
    s4 = s.reshape(n, 4, 4)
    sraw = (s4[:, :, 0] | (s4[:, :, 1] << 3) | (s4[:, :, 2] << 6) | (s4[:, :, 3] << 9)
            ).astype("<u2")  # [n, 4]
    db = _to_f16_bytes(d).view("<u2").astype(np.uint16)[:, 0]  # the f16 bits of d
    for i in range(4):  # nibble i of d's bits in the top of word i
        sraw[:, i] |= ((db >> (4 * i)) & 0xF) << 12
    return np.concatenate([(idx & 0xFF).astype(np.uint8), qh, _u16le(sraw)], axis=1)


# format -> (encoder, grid name, grid row width)
_FORMATS = {
    GGMLType.IQ2_XXS: (_enc_iq2_xxs, "iq2_xxs_grid", 8),
    GGMLType.IQ2_XS: (_enc_iq2_xs, "iq2_xs_grid", 8),
    GGMLType.IQ2_S: (_enc_iq2_s, "iq2_s_grid", 8),
    GGMLType.IQ3_XXS: (_enc_iq3_xxs, "iq3_xxs_grid", 4),
    GGMLType.IQ3_S: (_enc_iq3_s, "iq3_s_grid", 4),
    GGMLType.IQ1_S: (_enc_iq1_s, "iq1_s_grid", 8),
    GGMLType.IQ1_M: (_enc_iq1_m, "iq1_m_grid", 8),
}


def encode(blocks: np.ndarray, gtype: GGMLType, weights, device, shape=None) -> np.ndarray:
    """f32 blocks [N, 256] -> the format's bytes [N, type_size], the fit on
    `device`.  `weights` (or None) broadcasts against `shape`, the
    tensor's shape before it was cut into blocks (default: the blocks')."""
    fn, grid_name, width = _FORMATS[GGMLType(gtype)]
    dev = _device(device)
    x = torch.from_numpy(np.ascontiguousarray(blocks, np.float32)).to(dev)
    w = None
    if weights is not None:
        shape = tuple(shape or blocks.shape)
        wn = np.asarray(weights, np.float32)
        if wn.shape == shape[-1:]:  # one a column: repeat it over the rows on the device
            w = torch.from_numpy(np.ascontiguousarray(wn)).to(dev).expand(*shape)
        else:
            w = torch.from_numpy(np.array(np.broadcast_to(wn, shape))).to(dev)
        w = w.reshape(-1, QK_K)
    grid = torch.from_numpy(iq_grids()[grid_name].reshape(-1, width)).to(dev)
    return fn(x, w, grid, _chunk(grid.shape[0], dev))
