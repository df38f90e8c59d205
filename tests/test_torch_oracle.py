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


def quant_qtensor(fmt: GGMLType, n: int, k: int, seed: int):
    """A zllm QTensor of format `fmt` (repacked from random weights) and its
    raw GGUF rows [N, row_bytes]."""
    from zllm.quant import blocks as qb
    from zllm.quant import repack as rp

    rng = np.random.default_rng(seed)
    raw = qb.quantize(rng.standard_normal((n, k)).astype(np.float32) * 0.5, fmt)
    return rp.repack(raw, (n, k), fmt), raw


def q4k_qtensor(n: int, k: int, seed: int, npack: bool = True):
    """A zllm Q4_K QTensor (repack, then optionally to_npack) and its raw
    GGUF rows [N, row_bytes]."""
    from zllm.quant import repack as rp

    qt, raw = quant_qtensor(GGMLType.Q4_K, n, k, seed)
    if npack:
        qt = rp.to_npack(qt)
    return qt, raw


def f16_llama_gguf(path: str, seed: int = 0) -> str:
    """SMALL_LLAMA's geometry written in F16 by zllm's factory: the input
    the quantizers take."""
    from zllm.testing import make_llama_gguf

    shape = {k: v for k, v in SMALL_LLAMA.items() if k != "gtype"}
    return make_llama_gguf(path, **shape, gtype=GGMLType.F16, seed=seed, with_tokenizer=True)


def zllm_quantized_gguf(folder, ftype: str) -> str:
    """An F16 SMALL_LLAMA file requantized to `ftype` by zllm's
    tools/quantize.py (Q4_K_M: attn_v, ffn_down of layer 0 and the head
    Q6_K, the rest Q4_K)."""
    from tools.quantize import quantize_file

    src = f16_llama_gguf(str(folder / "f16.gguf"))
    out = str(folder / f"{ftype}.gguf")
    quantize_file(src, out, ftype, quiet=True)
    return out


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
