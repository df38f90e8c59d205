"""Shared fixtures for the zllm_torch parity tests (holds no tests).

The JAX package `zllm` is the oracle: the same inputs, made with numpy
from a seed, go through a `zllm` function and its `zllm_torch`
counterpart, and the outputs are compared with a stated tolerance.  Data
crosses between the frameworks as numpy arrays only.
"""

from __future__ import annotations

import numpy as np
import torch

from zllm.gguf.constants import GGMLType

# keep -n 6 xdist workers from oversubscribing the cores
torch.set_num_threads(2)

# the slice test's model: small widths, Q4_K everywhere, byte-level SPM vocab
SMALL_LLAMA = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512,
                   vocab_size=512, gtype=GGMLType.Q4_K)


def nmse(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.mean((a - b) ** 2) / (np.mean(b ** 2) + 1e-30))


def to_np(x) -> np.ndarray:
    """A jax array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def q4k_qtensor(n: int, k: int, seed: int, npack: bool = True):
    """A zllm Q4_K QTensor (repack, then optionally to_npack) and its raw
    GGUF rows [N, row_bytes]."""
    from zllm.quant import blocks as qb
    from zllm.quant import repack as rp

    rng = np.random.default_rng(seed)
    raw = qb.quantize(rng.standard_normal((n, k)).astype(np.float32) * 0.5, GGMLType.Q4_K)
    qt = rp.repack(raw, (n, k), GGMLType.Q4_K)
    if npack:
        qt = rp.to_npack(qt)
    return qt, raw


def qtensor_numpy(qt) -> dict:
    """zllm QTensor -> the plain description params_from_jax takes."""
    return {"fmt": int(qt.fmt), "shape": tuple(qt.shape), "fold": qt.fold,
            "npack": bool(qt.npack),
            "planes": {name: np.asarray(p) for name, p in qt.planes.items()}}


def jax_params_numpy(params: dict) -> dict:
    """zllm's loaded params tree with numpy leaves (QTensors described)."""
    from zllm.quant.repack import QTensor

    def leaf(v):
        return qtensor_numpy(v) if isinstance(v, QTensor) else to_np(v)

    out = {key: leaf(v) for key, v in params.items() if key != "layers"}
    out["layers"] = [{key: leaf(v) for key, v in layer.items()} for layer in params["layers"]]
    return out
