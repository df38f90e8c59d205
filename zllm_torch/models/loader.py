"""GGUF -> parameters on one device (counterpart of `zllm/models/loader.py`).

Q4_0, Q4_1, Q4_K, Q5_0, Q5_1, Q5_K, Q6_K, Q8_0, Q2_K, Q3_K, IQ4_NL,
IQ4_XS, MXFP4, the IQ grid formats' (IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS,
IQ3_S, IQ1_S, IQ1_M; their grids folded into value indexes on the
device) and the ternary TQ1_0's and TQ2_0's matmul weights become
`QWeight`s (quantized on the device, consumed by the port's kernels); an
F32, F16 or BF16 matmul weight is loaded dense [K, N] in the model dtype,
as zllm loads it; the token embedding is dequantized to a dense tensor of
the model dtype, norm weights and biases to f32.  A
llama layer has the pre-norms attn_norm and ffn_norm; a Qwen2 layer adds
the q/k/v biases bq, bk, bv; a Qwen3 layer adds attn_q_norm and
attn_k_norm of length head_dim (one RMS a head); an OLMo-2 layer has no
pre-norms, but attn_q_norm [q_dim] and attn_k_norm [kv_dim] (one RMS over
the whole projection) and the post-norms attn_post_norm and ffn_post_norm;
a Gemma layer has the pre-norms, a Gemma-2 or Gemma-3 one the post-norms
beside them (sandwich norms), and Gemma-3's the per-head q/k norms of
Qwen3; Gemma's head is tied to the embedding.  A mixture-of-experts layer
(Mixtral-style llama, qwen2moe with Qwen2's biases, qwen3moe with Qwen3's
norms) has the router ffn_gate_inp, dense in the model dtype as zllm's
`_load_matmul` loads an F32 tensor, and the expert stacks ffn_gate_exps,
ffn_up_exps, ffn_down_exps: `QWeightE`s (GGUF [E, N, row_bytes], each
expert's rows repacked as a 2-D weight's) or, from F32, F16 or BF16, dense
[E, K, N] in the model dtype, as zllm keeps them; qwen2moe adds the shared
expert ffn_{gate,up,down}_shexp and its gate ffn_gate_inp_shexp ([K, 1];
llama.cpp writes it 1-D, zllm's converter [1, K]).
The layer-norm families (gptneox, stablelm, starcoder2) add the norms'
biases attn_norm_b, ffn_norm_b and out_norm_b (f32, as their weights);
gptneox and starcoder2 the non-gated MLP ffn_up, ffn_down with its biases
ffn_up_b, ffn_down_b, and wo's bias bo; the q/k/v biases of gptneox,
stablelm and starcoder2 come as Qwen2's (bq, bk, bv), or, where llama.cpp
writes GPT-NeoX's fused attn_qkv weight and bias, split at q_dim and kv_dim
into wq, wk, wv and bq, bk, bv (quantized rows are whole blocks, so the
split is exact), as zllm's loader splits the weight (zllm leaves the bias
unmapped; the port loads it).
A gpt-oss layer adds to the llama block's tensors the per-head sink logits
attn_sinks [Hq], the router's bias ffn_gate_inp_b [E] and the experts'
biases ffn_{gate,up,down}_exps_b [E, N], all f32 as zllm loads them, beside
q/k/v and wo biases; its 2880-wide matmul weights (MXFP4 experts, Q8_0
elsewhere, as llama.cpp ships it) load quantized whatever their K, as any
32-block format's, and run on `ops/linear.py`'s dequantizing route.
A Llama-3 file's rope_freqs.weight is kept as `rope_freqs` and not read:
zllm takes llama3 rope scaling from the metadata alone.  At load, as
`zllm` does by default: the adjacent-pair rope of llama GGUFs is turned
into half-split ("neox") rope by permuting the wq/wk columns (and bq/bk),
wq|wk|wv (with bq|bk|bv) and gate|up (the experts' stacks and the shared
expert's too) are fused along N where the weights share one format (in a
Q4_K_M or Q5_K_M file wq/wk are Q4_K or Q5_K and wv Q6_K, so they stay
apart), and the output head is zero-padded to a multiple of 1024.

`params_from_jax` carries `zllm`'s loaded parameters (handed over as numpy
arrays) into this layout, so a test can run both packages on the very
same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFFile, read_gguf
from ..quant.repack import (WEIGHT_CLASSES, Q5Weight, Q6KWeight, QWeight, QWeightE, concat_experts,
                            concat_n, from_planes, pack_crumbs, pack_nibbles, pad_n, repack,
                            repack_experts)
from ..tokenizer import Tokenizer
from .config import NON_GATED_ARCHES, ModelConfig

# GGUF tensor suffix -> params key, per layer (the llama, Qwen2/3, OLMo-2
# and Gemma blocks; llama.cpp writes OLMo-2's and Gemma-2/3's post-norms as
# post_attention_norm / post_ffw_norm, zllm's converter as attn_post_norm /
# ffn_post_norm)
_LAYER_MAP = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "attn_output.bias": "bo",
    "attn_norm.bias": "attn_norm_b",
    "attn_q.bias": "bq",
    "attn_k.bias": "bk",
    "attn_v.bias": "bv",
    "attn_q_norm.weight": "attn_q_norm",
    "attn_k_norm.weight": "attn_k_norm",
    "attn_post_norm.weight": "attn_post_norm",
    "post_attention_norm.weight": "attn_post_norm",
    "ffn_norm.weight": "ffn_norm",
    "ffn_norm.bias": "ffn_norm_b",
    "ffn_gate.weight": "ffn_gate",
    "ffn_up.weight": "ffn_up",
    "ffn_down.weight": "ffn_down",
    "ffn_up.bias": "ffn_up_b",
    "ffn_down.bias": "ffn_down_b",
    "ffn_post_norm.weight": "ffn_post_norm",
    "post_ffw_norm.weight": "ffn_post_norm",
    "ffn_gate_inp.weight": "ffn_gate_inp",
    "ffn_gate_exps.weight": "ffn_gate_exps",
    "ffn_up_exps.weight": "ffn_up_exps",
    "ffn_down_exps.weight": "ffn_down_exps",
    "ffn_gate_shexp.weight": "ffn_gate_shexp",
    "ffn_up_shexp.weight": "ffn_up_shexp",
    "ffn_down_shexp.weight": "ffn_down_shexp",
    "ffn_gate_inp_shexp.weight": "ffn_gate_inp_shexp",
    "attn_sinks.weight": "attn_sinks",
    "ffn_gate_inp.bias": "ffn_gate_inp_b",
    "ffn_gate_exps.bias": "ffn_gate_exps_b",
    "ffn_up_exps.bias": "ffn_up_exps_b",
    "ffn_down_exps.bias": "ffn_down_exps_b",
}
# GPT-NeoX's fused q|k|v rows (llama.cpp's converter; split at load)
_FUSED_QKV = ("attn_qkv.weight", "attn_qkv.bias")
# the expert stacks (3-D: GGUF [E, N, K])
EXPERT_KEYS = ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")
# each architecture's norm vectors: a layer holds exactly these (Qwen3's
# q/k norms are one a head, OLMo-2's one over the whole projection: told
# apart by their length, as zllm tells them)
ARCH_NORMS = {"llama": {"attn_norm", "ffn_norm"},
              "qwen2": {"attn_norm", "ffn_norm"},
              "qwen3": {"attn_norm", "ffn_norm", "attn_q_norm", "attn_k_norm"},
              "olmo2": {"attn_q_norm", "attn_k_norm", "attn_post_norm", "ffn_post_norm"},
              "gemma": {"attn_norm", "ffn_norm"},
              "gemma2": {"attn_norm", "ffn_norm", "attn_post_norm", "ffn_post_norm"},
              "gemma3": {"attn_norm", "ffn_norm", "attn_post_norm", "ffn_post_norm",
                         "attn_q_norm", "attn_k_norm"},
              "qwen2moe": {"attn_norm", "ffn_norm"},
              "qwen3moe": {"attn_norm", "ffn_norm", "attn_q_norm", "attn_k_norm"},
              "gptneox": {"attn_norm", "ffn_norm"},
              "stablelm": {"attn_norm", "ffn_norm"},
              "starcoder2": {"attn_norm", "ffn_norm"},
              "gpt-oss": {"attn_norm", "ffn_norm"}}
_BIAS_KEYS = ("bq", "bk", "bv")
# the LayerNorms' biases (each beside its weight) and the other
# projections' (wo; the non-gated MLP's up and down)
_NORM_BIAS_KEYS = ("attn_norm_b", "ffn_norm_b")
_OTHER_BIAS_KEYS = ("bo", "ffn_up_b", "ffn_down_b", *_NORM_BIAS_KEYS)
# gpt-oss's attention sinks [Hq], router bias [E] and expert biases [E, N]
_MOE_BIAS_KEYS = ("ffn_gate_inp_b", "ffn_gate_exps_b", "ffn_up_exps_b", "ffn_down_exps_b")
_GPT_OSS_KEYS = ("attn_sinks", *_MOE_BIAS_KEYS)
_VECTOR_KEYS = ({"out_norm", "out_norm_b", "rope_freqs", "bqkv", *_BIAS_KEYS, *_OTHER_BIAS_KEYS,
                 *_GPT_OSS_KEYS} | set().union(*ARCH_NORMS.values()))


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


def _load_matmul(f: GGUFFile, name: str, dtype, device, rows: tuple[int, int] | None = None):
    """2-D weight: GGUF [N, K] row-major -> QWeight (a format of
    WEIGHT_CLASSES) or dense [K, N] in the model dtype (F32, F16, BF16);
    `rows` (lo, hi): those output rows alone."""
    meta = f.tensors[name]
    if len(meta.shape) != 2:
        raise ValueError(f"{name}: matmul weight must be 2-D, got {meta.shape}")
    lo, hi = rows or (0, meta.shape[0])
    if meta.gtype in WEIGHT_CLASSES:
        return repack(f.tensor_bytes(name)[lo:hi], (hi - lo, meta.shape[1]), meta.gtype, device)
    if meta.gtype not in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
        raise NotImplementedError(f"{name}: {meta.gtype.name} weights are not in zllm_torch yet")
    x = np.ascontiguousarray(f.tensor_f32(name)[lo:hi].T)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _split_qkv(f: GGUFFile, name: str, cfg: ModelConfig, dtype, device) -> dict:
    """A fused attn_qkv weight or bias (q rows, then k, then v) -> wq, wk, wv
    or bq, bk, bv, cut at q_dim and kv_dim."""
    qd, kvd = cfg.q_dim, cfg.kv_dim
    bounds = ((0, qd), (qd, qd + kvd), (qd + kvd, qd + 2 * kvd))
    if f.tensors[name].shape[0] != qd + 2 * kvd:
        raise ValueError(f"{name}: {f.tensors[name].shape[0]} rows, not q_dim + 2 kv_dim = "
                         f"{qd + 2 * kvd}")
    if name.endswith(".bias"):
        x = f.tensor_f32(name)
        return {key: torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(device)
                for key, (lo, hi) in zip(_BIAS_KEYS, bounds)}
    return {key: _load_matmul(f, name, dtype, device, rows)
            for key, rows in zip(("wq", "wk", "wv"), bounds)}


def _load_experts(f: GGUFFile, name: str, dtype, device):
    """A 3-D expert stack: GGUF [E, N, K] -> QWeightE (a format of
    WEIGHT_CLASSES) or dense [E, K, N] in the model dtype (F32, F16, BF16)."""
    meta = f.tensors[name]
    if len(meta.shape) != 3:
        raise ValueError(f"{name}: an expert stack must be 3-D, got {meta.shape}")
    if meta.gtype in WEIGHT_CLASSES:
        return repack_experts(f.tensor_bytes(name), meta.shape, meta.gtype, device)
    if meta.gtype not in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
        raise NotImplementedError(f"{name}: {meta.gtype.name} experts are not in zllm_torch yet")
    x = np.ascontiguousarray(np.swapaxes(f.tensor_f32(name), 1, 2))
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def load_params(f: GGUFFile, cfg: ModelConfig, *, dtype, device) -> dict:
    params: dict = {"layers": [dict() for _ in range(cfg.n_layers)]}
    if cfg.arch == "stablelm" and any(n.endswith(("attn_q_norm.weight", "attn_k_norm.weight"))
                                      for n in f.tensors):
        # zllm runs these [n_head, head_dim] weights as per-head RMS norms,
        # where the model (StableLM-2-12B) applies per-head LayerNorms
        raise NotImplementedError("StableLM-2-12B's per-head q/k LayerNorms are not in "
                                  "zllm_torch yet (ROADMAP queue 1 item 8)")
    for name in f.tensors:
        if name == "token_embd.weight":
            params["tok_emb"] = _load_dense(f, name, dtype, device)
        elif name == "output_norm.weight":
            params["out_norm"] = _load_dense(f, name, torch.float32, device)
        elif name == "output_norm.bias":
            params["out_norm_b"] = _load_dense(f, name, torch.float32, device)
        elif name == "output.weight":
            params["output"] = _load_matmul(f, name, dtype, device)
        elif name == "rope_freqs.weight":  # loaded and not read, as zllm does
            params["rope_freqs"] = _load_dense(f, name, torch.float32, device)
        elif name.startswith("blk.") and name.split(".", 2)[2] in _FUSED_QKV:
            params["layers"][int(name.split(".")[1])].update(
                _split_qkv(f, name, cfg, dtype, device))
        elif name.startswith("blk.") and name.split(".", 2)[2] in _LAYER_MAP:
            _, il, suffix = name.split(".", 2)
            key = _LAYER_MAP[suffix]
            if key in _VECTOR_KEYS:
                val = _load_dense(f, name, torch.float32, device)
            elif key in EXPERT_KEYS:
                val = _load_experts(f, name, dtype, device)
            elif key == "ffn_gate_inp_shexp" and len(f.tensors[name].shape) == 1:
                val = _load_dense(f, name, dtype, device)[:, None]  # llama.cpp's {n_embd}
            else:
                val = _load_matmul(f, name, dtype, device)
            params["layers"][int(il)][key] = val
        else:
            raise NotImplementedError(f"tensor {name} is not part of the {cfg.arch} block")
    qk_norm_len = {"qwen3": (cfg.head_dim, cfg.head_dim), "gemma3": (cfg.head_dim, cfg.head_dim),
                   "qwen3moe": (cfg.head_dim, cfg.head_dim), "olmo2": (cfg.q_dim, cfg.kv_dim)}
    layer_norm = cfg.norm_kind == "layer"
    if "out_norm_b" in params and not layer_norm:
        raise NotImplementedError(f"output_norm.bias on {cfg.arch}: its RMS norm has no bias")
    for il, layer in enumerate(params["layers"]):
        if cfg.arch == "gpt-oss" and "attn_post_norm" in layer and "ffn_norm" not in layer:
            # llama.cpp writes gpt-oss's FFN pre-norm (HF post_attention_layernorm)
            # as post_attention_norm; zllm's converter writes ffn_norm
            layer["ffn_norm"] = layer.pop("attn_post_norm")
        norms = {key for key in layer if key in _VECTOR_KEYS
                 and key not in _BIAS_KEYS + _OTHER_BIAS_KEYS + _GPT_OSS_KEYS}
        if norms != ARCH_NORMS[cfg.arch]:
            raise NotImplementedError(f"layer {il} of a {cfg.arch} file has the norms "
                                      f"{sorted(norms)}, not {sorted(ARCH_NORMS[cfg.arch])}")
        if cfg.arch in qk_norm_len:
            got = (layer["attn_q_norm"].shape[0], layer["attn_k_norm"].shape[0])
            if got != qk_norm_len[cfg.arch]:
                raise NotImplementedError(f"layer {il} of a {cfg.arch} file has q/k norms of "
                                          f"length {got}, not {qk_norm_len[cfg.arch]}")
        biases = [key for key in _BIAS_KEYS if key in layer]
        if biases and len(biases) != len(_BIAS_KEYS):
            raise NotImplementedError(f"layer {il} has the biases {biases}, not bq, bk and bv")
        for key in _NORM_BIAS_KEYS:  # a LayerNorm's bias, beside its weight
            if key in layer and not (layer_norm and key[:-2] in layer):
                raise NotImplementedError(f"layer {il} of a {cfg.arch} file has {key}: its "
                                          f"{cfg.norm_kind} norm takes no bias there")
        if "attn_sinks" in layer and cfg.arch == "olmo2":  # its T=1 kernel, K8, has no sinks
            raise NotImplementedError("attn_sinks on olmo2 is not in zllm_torch yet (ROADMAP "
                                      "queue 1 item 8)")
        if "attn_sinks" in layer and tuple(layer["attn_sinks"].shape) != (cfg.n_heads,):
            raise NotImplementedError(f"layer {il}: attn_sinks of shape "
                                      f"{tuple(layer['attn_sinks'].shape)}, not [{cfg.n_heads}]")
        _check_ffn(layer, il, cfg)
    if "output" not in params:  # tied embedding
        params["output"] = params["tok_emb"].float().t().contiguous().to(dtype)
    return params


_SHARED_KEYS = ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp")


def _check_ffn(layer: dict, il: int, cfg: ModelConfig):
    """A layer's FFN is dense (gate, up, down; on gptneox and starcoder2
    the non-gated up and down, each with or without its bias) or, in a file
    with experts, the router and the three stacks, with the shared expert
    whole or absent; anything else is refused rather than run as another
    model."""
    dense = [key for key in ("ffn_gate", "ffn_up", "ffn_down") if key in layer]
    gated = cfg.arch not in NON_GATED_ARCHES
    for key in ("ffn_up_b", "ffn_down_b"):
        if key in layer and (gated or key[:-2] not in layer):
            raise NotImplementedError(f"layer {il} has {key}: the port takes the FFN biases of "
                                      f"the non-gated MLP ({', '.join(NON_GATED_ARCHES)})")
    moe = [key for key in ("ffn_gate_inp", *EXPERT_KEYS) if key in layer]
    shared = [key for key in _SHARED_KEYS if key in layer]
    if not moe and any(key in layer for key in _MOE_BIAS_KEYS):
        raise NotImplementedError(f"layer {il} has router or expert biases and no experts")
    if moe:
        if cfg.moe is None or len(moe) != 4 or dense:
            raise NotImplementedError(f"layer {il} has the FFN tensors {sorted(dense + moe)}: "
                                      "an MoE layer is the router and three expert stacks in a "
                                      "file with expert_count (ROADMAP queue 1 item 8)")
        e = layer["ffn_gate_exps"].shape[0]
        if e != cfg.moe.n_experts or layer["ffn_gate_inp"].shape[-1] != e:
            raise NotImplementedError(f"layer {il}: {e} experts, the file says "
                                      f"{cfg.moe.n_experts}")
        if shared and len(shared) != len(_SHARED_KEYS):
            raise NotImplementedError(f"layer {il} has the shared-expert tensors {shared}")
        biases = [key for key in _MOE_BIAS_KEYS[1:] if key in layer]
        if biases and len(biases) != 3:
            raise NotImplementedError(f"layer {il} has the expert biases {biases}, not all three")
        for key in biases:
            if tuple(layer[key].shape) != (e, layer[key.replace("_b", "")].shape[2]):
                raise NotImplementedError(f"layer {il}: {key} of shape "
                                          f"{tuple(layer[key].shape)}")
    elif not gated:
        if dense != ["ffn_up", "ffn_down"] or shared:
            raise NotImplementedError(f"layer {il} of a {cfg.arch} file has the FFN tensors "
                                      f"{sorted(dense + shared)}, not ffn_up and ffn_down")
    elif len(dense) != 3 or shared or "ffn_gate_inp_shexp" in layer:
        raise NotImplementedError(f"layer {il} has the FFN tensors {sorted(dense + shared)}, "
                                  "not ffn_gate, ffn_up and ffn_down")


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
        for key in ("bq", "bk"):
            if key in layer:
                layer[key] = _permute_cols(layer[key][None], neox_head_perm(
                    layer[key].shape[0], cfg.head_dim))[0]
    return params, cfg.with_(rope=rope._replace(style="neox"), neox_permuted=True)


def _fusable(ws) -> bool:
    """One kernel can take the fused weight: one format and one K (expert
    stacks: one format, E and K)."""
    for kind in (QWeight, QWeightE):
        if all(isinstance(w, kind) for w in ws):
            return len({(w.fmt, w.shape[:-1]) for w in ws}) == 1
    if not any(isinstance(w, (QWeight, QWeightE)) for w in ws):
        return len({w.shape[:-1] for w in ws}) == 1 and len({w.dtype for w in ws}) == 1
    return False


def _cat(ws):
    if isinstance(ws[0], QWeight):
        return concat_n(list(ws))
    if isinstance(ws[0], QWeightE):
        return concat_experts(list(ws))
    return torch.cat(ws, dim=-1)


# gate and up of the dense FFN, of the experts and of the shared expert:
# fused along N into the second key where one kernel takes both
_GATE_UP = (("ffn_gate", "ffn_up", "ffn_gateup"),
            ("ffn_gate_exps", "ffn_up_exps", "ffn_gateup_exps"),
            ("ffn_gate_shexp", "ffn_up_shexp", "ffn_gateup_shexp"))


def fuse_projections(params: dict) -> dict:
    """wq|wk|wv -> wqkv (bq|bk|bv -> bqkv with it) and gate|up -> gateup
    along N (`_GATE_UP`); an expert's fused rows are its gate rows, then
    its up rows, so the fusion changes no value."""
    for layer in params["layers"]:
        ws = [layer["wq"], layer["wk"], layer["wv"]]
        if _fusable(ws):
            layer["wqkv"] = _cat(ws)
            del layer["wq"], layer["wk"], layer["wv"]
            if "bq" in layer:
                layer["bqkv"] = torch.cat([layer.pop(key) for key in _BIAS_KEYS])
        for gate, up, fused in _GATE_UP:
            if gate in layer and _fusable([layer[gate], layer[up]]):
                layer[fused] = _cat([layer.pop(gate), layer.pop(up)])
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

    @property
    def chat_template(self) -> str:
        """The GGUF's tokenizer.chat_template jinja source ("" without a
        tokenizer), read by `server/chat.py`'s format detection."""
        if self.tokenizer is not None:
            return self.tokenizer.vocab.chat_template
        return ""

    @classmethod
    def load(cls, path: str, *, device="cuda", dtype=torch.bfloat16) -> "Model":
        dev = resolve_device(device)
        with read_gguf(path) as f:
            cfg = ModelConfig.from_gguf(f).with_(tie_embedding="output.weight" not in f.tensors)
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


def _nibble_codes_from_jax(desc: dict) -> np.ndarray:
    """zllm's 4-bit code plane -> uint8 codes [N, K]: split-half fold
    nibbles [K/2, N], or with npack int8 [K, N/2] bytes holding column c in
    the low nibble and column c + N/2 in the high one, stored XOR 0x80."""
    p = desc["planes"]
    if desc["npack"]:
        bp = np.asarray(p["qs"]).view(np.uint8)
        codes = np.concatenate([bp & 0xF, (bp >> 4) ^ 0x8], axis=1)  # [K, N]
    else:
        codes = _unfold(p["qs"], int(desc["fold"]), 4)
    return np.ascontiguousarray(codes.T)


def _q4k_from_jax(desc: dict) -> dict[str, np.ndarray]:
    """The "diet" Q4_K planes: qs (see _nibble_codes_from_jax), sm u16
    [K/32, N] = sc | mn<<6, sd/sb fp16 bits [K/256 rounded up to 8 rows, N]."""
    k, n = desc["shape"]
    p = desc["planes"]
    if "sm" not in p:
        raise NotImplementedError("only the exact two-level ('diet') Q4_K planes carry across")
    sm = np.asarray(p["sm"]).astype(np.uint16)
    return {
        "qs": pack_nibbles(_nibble_codes_from_jax(desc)),
        "sc": np.ascontiguousarray((sm & 63).T).astype(np.uint8),
        "mn": np.ascontiguousarray((sm >> 6).T).astype(np.uint8),
        "d": _f16_nk(p["sd"], k // 256),
        "dmin": _f16_nk(p["sb"], k // 256),
    }


def _legacy_nibble_from_jax(desc: dict) -> dict[str, np.ndarray]:
    """zllm's Q4_0 (qs, d) and Q4_1 (qs, a, b) planes: qs as for Q4_K, the
    scales fp16 [K/32, N] per 32-group."""
    k, _ = desc["shape"]
    scales = ("d",) if GGMLType(desc["fmt"]) == GGMLType.Q4_0 else ("a", "b")
    return {"qs": pack_nibbles(_nibble_codes_from_jax(desc)),
            **{name: _f16_nk(desc["planes"][name], k // 32) for name in scales}}


def _q5_from_jax(desc: dict) -> dict[str, np.ndarray]:
    """zllm's Q5_0 (qs, qh, a = d), Q5_1 and Q5_K (qs, qh, a, b) planes: the
    low nibbles in qs as for Q4_K, the fifth bits a plane qh [K/8, N] (bit i
    of byte r holds k = 8r + i), the scales fp16 [K/32, N] per 32-group."""
    k, n = desc["shape"]
    p = desc["planes"]
    bits = np.unpackbits(np.asarray(p["qh"]).astype(np.uint8)[:, None, :], axis=1,
                         bitorder="little").reshape(k, n)
    planes = Q5Weight.pack_codes(_nibble_codes_from_jax(desc) | (np.ascontiguousarray(bits.T) << 4))
    if GGMLType(desc["fmt"]) == GGMLType.Q5_0:
        return {**planes, "d": _f16_nk(p["a"], k // 32)}
    return {**planes, "a": _f16_nk(p["a"], k // 32), "b": _f16_nk(p["b"], k // 32)}


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


def _k_quant_low_from_jax(desc: dict) -> dict[str, np.ndarray]:
    """zllm's Q2_K (qs, a, b) and Q3_K (qs, qh, a) planes: the 2-bit codes
    split-quarter fold crumbs [K/4, N], Q3_K's third bits a plane [K/8, N]
    (bit i of byte r holds k = 8r + i, the port's order transposed), the
    scales fp16 [K/16, N] per 16-group."""
    k, n = desc["shape"]
    p, fold = desc["planes"], int(desc["fold"])
    out = {"qs": pack_crumbs(np.ascontiguousarray(_unfold(p["qs"], fold, 2).T)),
           "a": _f16_nk(p["a"], k // 16)}
    if GGMLType(desc["fmt"]) == GGMLType.Q3_K:
        return {**out, "qh": np.ascontiguousarray(np.asarray(p["qh"]).astype(np.uint8).T)}
    return {**out, "b": _f16_nk(p["b"], k // 16)}


def _table_from_jax(desc: dict) -> dict[str, np.ndarray]:
    """zllm's IQ4_NL (qs, d), IQ4_XS (qs, a) and MXFP4 (qs, e) planes: the
    4-bit indexes as the nibble formats' qs, the scale [K/32, N] per
    32-group (MXFP4's e the uint8 exponent)."""
    k, _ = desc["shape"]
    fmt, p = GGMLType(desc["fmt"]), desc["planes"]
    qs = pack_nibbles(_nibble_codes_from_jax(desc))
    if fmt == GGMLType.MXFP4:
        e = np.asarray(p["e"]).astype(np.uint8)[:k // 32]
        return {"qs": qs, "e": np.ascontiguousarray(e.T)}
    name = "d" if fmt == GGMLType.IQ4_NL else "a"
    return {"qs": qs, name: _f16_nk(p[name], k // 32)}


def _iq_from_jax(desc: dict) -> dict[str, np.ndarray]:
    """zllm's IQ grid and ternary planes: IQ2_* and IQ3_* value indexes as
    the nibble formats' qs and a, IQ1_S and IQ1_M crumbs (split-quarter fold
    [K/4, N]) and a, b, TQ1_0 and TQ2_0 crumbs and a; each fp16 plane
    [K/group, N] at the weight class's group."""
    k, n = desc["shape"]
    p, cls = desc["planes"], WEIGHT_CLASSES[GGMLType(desc["fmt"])]
    if cls.PLANES["qs"][1] == 4:
        out = {"qs": pack_crumbs(np.ascontiguousarray(_unfold(p["qs"], int(desc["fold"]), 2).T))}
    else:
        out = {"qs": pack_nibbles(_nibble_codes_from_jax(desc))}
    return {**out, **{name: _f16_nk(p[name], k // kdiv) for name, (_, kdiv) in cls.PLANES.items()
                      if name != "qs"}}


_FROM_JAX = {GGMLType.Q4_K: _q4k_from_jax, GGMLType.Q4_0: _legacy_nibble_from_jax,
             GGMLType.Q4_1: _legacy_nibble_from_jax, GGMLType.Q5_0: _q5_from_jax,
             GGMLType.Q5_1: _q5_from_jax, GGMLType.Q5_K: _q5_from_jax,
             GGMLType.Q6_K: _q6k_from_jax, GGMLType.Q8_0: _q80_from_jax,
             GGMLType.Q2_K: _k_quant_low_from_jax, GGMLType.Q3_K: _k_quant_low_from_jax,
             GGMLType.IQ4_NL: _table_from_jax, GGMLType.IQ4_XS: _table_from_jax,
             GGMLType.MXFP4: _table_from_jax,
             **{fmt: _iq_from_jax for fmt in (GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S,
                                             GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S,
                                             GGMLType.IQ1_M, GGMLType.TQ1_0, GGMLType.TQ2_0)}}


def _experts_from_jax(desc: dict, device) -> QWeightE:
    """A QTensorE's description (planes with a leading E axis, "shape" (E,
    K, N)) -> QWeightE, one expert's planes at a time as a QTensor's."""
    fmt, (e, k, n) = GGMLType(desc["fmt"]), desc["shape"]
    per = [_FROM_JAX[fmt]({**desc, "shape": (k, n), "npack": False,
                           "planes": {name: p[i] for name, p in desc["planes"].items()}})
           for i in range(e)]
    w = from_planes({name: np.concatenate([p[name] for p in per]) for name in per[0]},
                    (k, e * n), fmt, device)
    return QWeightE(fmt, (e, k, n), {name: p.reshape(e, n, *p.shape[1:])
                                     for name, p in w.planes().items()})


def _leaf_from_jax(key: str, val, *, dtype, device):
    if isinstance(val, dict):
        fmt = GGMLType(val["fmt"])
        if fmt not in _FROM_JAX:
            raise NotImplementedError(f"{key}: {fmt.name} does not carry across")
        if len(val["shape"]) == 3:
            return _experts_from_jax(val, device)
        return from_planes(_FROM_JAX[fmt](val), tuple(val["shape"]), fmt, device)
    t = torch.from_numpy(np.ascontiguousarray(val, dtype=np.float32)).to(device)
    return t if key in _VECTOR_KEYS else t.to(dtype)


def params_from_jax(jparams: dict, *, device="cuda", dtype=torch.bfloat16) -> dict:
    """`zllm`'s loaded parameters -> this port's.

    `jparams` mirrors zllm's params tree with numpy leaves: dense arrays as
    f32 numpy, and each QTensor as {"fmt", "shape" (K, N), "fold", "npack",
    "planes": {name: numpy}}, and each QTensorE (expert stack) as the same
    with "shape" (E, K, N) and planes with a leading E axis; a dense
    expert stack is an [E, K, N] array.  Q4_0, Q4_1, Q4_K, Q5_0, Q5_1,
    Q5_K, Q6_K, Q8_0, Q2_K, Q3_K, IQ4_NL, IQ4_XS, MXFP4, the IQ grid formats IQ2_XXS,
    IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S and IQ1_M, and TQ1_0 and TQ2_0
    carry across."""
    dev = resolve_device(device)
    out = {key: _leaf_from_jax(key, val, dtype=dtype, device=dev)
           for key, val in jparams.items() if key != "layers"}
    out["layers"] = [{key: _leaf_from_jax(key, val, dtype=dtype, device=dev)
                      for key, val in layer.items()} for layer in jparams["layers"]]
    return out
