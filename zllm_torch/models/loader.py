"""GGUF -> parameters on one device (counterpart of `zllm/models/loader.py`).

Q4_K, Q6_K and Q8_0 matmul weights become `QWeight`s (quantized on the
device, consumed by the port's kernels); the token embedding is dequantized
to a dense tensor of the model dtype, norm weights to f32.  At load, as
`zllm` does by default: the adjacent-pair rope of llama GGUFs is turned
into half-split ("neox") rope by permuting the wq/wk columns, wq|wk|wv and
gate|up are fused along N where the weights share one format (in a Q4_K_M
file wq/wk are Q4_K and wv Q6_K, so they stay apart), and the output head
is zero-padded to a multiple of 1024.

`params_from_jax` carries `zllm`'s loaded parameters (handed over as numpy
arrays) into this layout, so a test can run both packages on the very
same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFFile, read_gguf
from ..quant.repack import WEIGHT_CLASSES, Q6KWeight, QWeight, concat_n, from_planes, pad_n, repack
from ..tokenizer import Tokenizer
from .config import ModelConfig

# GGUF tensor suffix -> params key, per layer (the plain llama block)
_LAYER_MAP = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "ffn_gate",
    "ffn_up.weight": "ffn_up",
    "ffn_down.weight": "ffn_down",
}
_VECTOR_KEYS = {"attn_norm", "ffn_norm", "out_norm"}


def resolve_device(device) -> torch.device:
    """The device asked for; raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "zllm_torch: device 'cuda' was requested but no CUDA device is visible "
            "(torch.cuda.is_available() is False); pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"zllm_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


def _load_dense(f: GGUFFile, name: str, dtype, device) -> torch.Tensor:
    return torch.from_numpy(f.tensor_f32(name)).to(device=device, dtype=dtype)


def _load_matmul(f: GGUFFile, name: str, dtype, device):
    """2-D weight: GGUF [N, K] row-major -> QWeight (Q4_K, Q6_K, Q8_0) or
    dense [K, N] (F32, F16)."""
    meta = f.tensors[name]
    if len(meta.shape) != 2:
        raise ValueError(f"{name}: matmul weight must be 2-D, got {meta.shape}")
    if meta.gtype in WEIGHT_CLASSES:
        return repack(f.tensor_bytes(name), meta.shape, meta.gtype, device)
    if meta.gtype not in (GGMLType.F32, GGMLType.F16):
        raise NotImplementedError(f"{name}: {meta.gtype.name} weights are not in zllm_torch yet")
    x = np.ascontiguousarray(f.tensor_f32(name).T)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def load_params(f: GGUFFile, cfg: ModelConfig, *, dtype, device) -> dict:
    params: dict = {"layers": [dict() for _ in range(cfg.n_layers)]}
    for name in f.tensors:
        if name == "token_embd.weight":
            params["tok_emb"] = _load_dense(f, name, dtype, device)
        elif name == "output_norm.weight":
            params["out_norm"] = _load_dense(f, name, torch.float32, device)
        elif name == "output.weight":
            params["output"] = _load_matmul(f, name, dtype, device)
        elif name.startswith("blk.") and name.split(".", 2)[2] in _LAYER_MAP:
            _, il, suffix = name.split(".", 2)
            key = _LAYER_MAP[suffix]
            if key in _VECTOR_KEYS:
                val = _load_dense(f, name, torch.float32, device)
            else:
                val = _load_matmul(f, name, dtype, device)
            params["layers"][int(il)][key] = val
        else:
            raise NotImplementedError(f"tensor {name} is not part of the plain llama block")
    if "output" not in params:  # tied embedding
        params["output"] = params["tok_emb"].float().t().contiguous().to(dtype)
    return params


def neox_within_perm(d: int) -> np.ndarray:
    """Within-head column permutation of the norm->neox rope conversion:
    neox element i <- adjacent element (2i | 2(i-d/2)+1)."""
    return np.concatenate([np.arange(0, d, 2), np.arange(1, d, 2)])


def neox_head_perm(n: int, d: int) -> np.ndarray:
    """The within-head perm replicated across all n//d heads."""
    return (np.arange(n // d)[:, None] * d + neox_within_perm(d)[None, :]).reshape(-1)


def _permute_cols(w, perm: np.ndarray):
    if isinstance(w, QWeight):
        return w.permute_n(perm)
    return w[:, torch.as_tensor(perm, device=w.device)].contiguous()


def rope_to_neox(params: dict, cfg: ModelConfig) -> tuple[dict, ModelConfig]:
    """Turn adjacent-pair ("norm") rope into half-split ("neox") rope by
    permuting the q/k head columns; attention scores are invariant to a
    shared q/k permutation."""
    rope = cfg.rope
    if rope.style != "norm" or rope.dim != cfg.head_dim:
        return params, cfg
    for layer in params["layers"]:
        for key in ("wq", "wk"):
            layer[key] = _permute_cols(layer[key], neox_head_perm(layer[key].shape[1],
                                                                  cfg.head_dim))
    return params, cfg.with_(rope=rope._replace(style="neox"), neox_permuted=True)


def _fusable(ws) -> bool:
    """One kernel can take the fused weight: one format and one K."""
    if all(isinstance(w, QWeight) for w in ws):
        return len({(w.fmt, w.shape[0]) for w in ws}) == 1
    if not any(isinstance(w, QWeight) for w in ws):
        return len({w.shape[0] for w in ws}) == 1 and len({w.dtype for w in ws}) == 1
    return False


def _cat(ws):
    return concat_n(list(ws)) if isinstance(ws[0], QWeight) else torch.cat(ws, dim=-1)


def fuse_projections(params: dict) -> dict:
    """wq|wk|wv -> wqkv and ffn_gate|ffn_up -> ffn_gateup along N."""
    for layer in params["layers"]:
        ws = [layer["wq"], layer["wk"], layer["wv"]]
        if _fusable(ws):
            layer["wqkv"] = _cat(ws)
            del layer["wq"], layer["wk"], layer["wv"]
        ws = [layer["ffn_gate"], layer["ffn_up"]]
        if _fusable(ws):
            layer["ffn_gateup"] = _cat(ws)
            del layer["ffn_gate"], layer["ffn_up"]
    return params


class Model:
    """Loaded model bundle: config + params + tokenizer, on one device."""

    def __init__(self, cfg: ModelConfig, params: dict, tokenizer: Tokenizer | None,
                 device: torch.device, path: str = ""):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = device
        self.path = path

    @classmethod
    def load(cls, path: str, *, device="cuda", dtype=torch.bfloat16) -> "Model":
        dev = resolve_device(device)
        with read_gguf(path) as f:
            cfg = ModelConfig.from_gguf(f)
            tok = Tokenizer.from_gguf(f) if f.kv("tokenizer.ggml.tokens") is not None else None
            params = load_params(f, cfg, dtype=dtype, device=dev)
        params, cfg = rope_to_neox(params, cfg)
        params = fuse_projections(params)
        if isinstance(params["output"], QWeight):
            # the forward slices the logits back to cfg.vocab_size
            params["output"] = pad_n(params["output"], 1024)
        return cls(cfg, params, tok, dev, path)


def _unfold(plane: np.ndarray, fold: int, bits: int) -> np.ndarray:
    """zllm's split fold packing along K -> uint8 [K, N] values: within each
    chunk of `fold` rows, field i of byte r holds row r + i * fold/per
    (nibbles: bits 4, per 2; crumbs: bits 2, per 4)."""
    per = 8 // bits
    rows, n = plane.shape
    g = np.asarray(plane).astype(np.uint8).reshape(rows // (fold // per), fold // per, n)
    parts = [(g >> (bits * i)) & ((1 << bits) - 1) for i in range(per)]
    return np.concatenate(parts, axis=1).reshape(rows * per, n)


def _f16_nk(plane, rows: int) -> np.ndarray:
    """An fp16 plane [rows (+ padding), N], fp16 or its uint16 bits -> [N, rows]."""
    plane = np.asarray(plane)[:rows]
    return np.ascontiguousarray((plane.view(np.float16) if plane.dtype == np.uint16
                                 else plane.astype(np.float16)).T)


def _q4k_from_jax(desc: dict) -> dict[str, np.ndarray]:
    """The "diet" Q4_K planes: qs (split-half fold nibbles [K/2, N], or with
    npack int8 [K, N/2] bytes holding column c in the low nibble and column
    c + N/2 in the high one, stored XOR 0x80), sm u16 [K/32, N] = sc | mn<<6,
    sd/sb fp16 bits [K/256 rounded up to 8 rows, N]."""
    k, n = desc["shape"]
    p = desc["planes"]
    if "sm" not in p:
        raise NotImplementedError("only the exact two-level ('diet') Q4_K planes carry across")
    if desc["npack"]:
        bp = np.asarray(p["qs"]).view(np.uint8)
        codes = np.concatenate([bp & 0xF, (bp >> 4) ^ 0x8], axis=1)  # [K, N]
    else:
        codes = _unfold(p["qs"], int(desc["fold"]), 4)
    c = np.ascontiguousarray(codes.T).reshape(n, k // 64, 2, 32)
    sm = np.asarray(p["sm"]).astype(np.uint16)
    return {
        "qs": (c[:, :, 0, :] | (c[:, :, 1, :] << 4)).astype(np.uint8).reshape(n, k // 2),
        "sc": np.ascontiguousarray((sm & 63).T).astype(np.uint8),
        "mn": np.ascontiguousarray((sm >> 6).T).astype(np.uint8),
        "d": _f16_nk(p["sd"], k // 256),
        "dmin": _f16_nk(p["sb"], k // 256),
    }


def _q6k_from_jax(desc: dict) -> dict[str, np.ndarray]:
    """zllm's Q6_K planes: ql split-half fold nibbles [K/2, N], qh
    split-quarter fold crumbs [K/4, N], a fp16 bits [K/16, N]."""
    k, n = desc["shape"]
    p, fold = desc["planes"], int(desc["fold"])
    codes = _unfold(p["ql"], fold, 4) | (_unfold(p["qh"], fold, 2) << 4)  # [K, N] 0..63
    return {**Q6KWeight.pack_codes(np.ascontiguousarray(codes.T)), "a": _f16_nk(p["a"], k // 16)}


def _q80_from_jax(desc: dict) -> dict[str, np.ndarray]:
    """zllm's Q8_0 planes: qs int8 [K, N], d fp16 bits [K/32, N]."""
    k, n = desc["shape"]
    p = desc["planes"]
    return {"qs": np.ascontiguousarray(np.asarray(p["qs"]).view(np.int8).T),
            "d": _f16_nk(p["d"], k // 32)}


_FROM_JAX = {GGMLType.Q4_K: _q4k_from_jax, GGMLType.Q6_K: _q6k_from_jax,
             GGMLType.Q8_0: _q80_from_jax}


def _leaf_from_jax(key: str, val, *, dtype, device):
    if isinstance(val, dict):
        fmt = GGMLType(val["fmt"])
        if fmt not in _FROM_JAX:
            raise NotImplementedError(f"{key}: {fmt.name} does not carry across")
        return from_planes(_FROM_JAX[fmt](val), tuple(val["shape"]), fmt, device)
    t = torch.from_numpy(np.ascontiguousarray(val, dtype=np.float32)).to(device)
    return t if key in _VECTOR_KEYS else t.to(dtype)


def params_from_jax(jparams: dict, *, device="cuda", dtype=torch.bfloat16) -> dict:
    """`zllm`'s loaded parameters -> this port's.

    `jparams` mirrors zllm's params tree with numpy leaves: dense arrays as
    f32 numpy, and each QTensor as {"fmt", "shape" (K, N), "fold", "npack",
    "planes": {name: numpy}}.  Q4_K, Q6_K and Q8_0 carry across."""
    dev = resolve_device(device)
    out = {key: _leaf_from_jax(key, val, dtype=dtype, device=dev)
           for key, val in jparams.items() if key != "layers"}
    out["layers"] = [{key: _leaf_from_jax(key, val, dtype=dtype, device=dev)
                      for key, val in layer.items()} for layer in jparams["layers"]]
    return out
