"""Model (re)quantization: the counterpart of `tools/quantize.py`, without
the importance matrix.

Streams the tensors of a source GGUF, picks a target type per tensor with
llama-quantize's role-aware rules (reference: src/llama-quant.cpp
llama_tensor_get_type, simplified as `tools/quantize.py` has them: the
embedding, the output head, attn_v and part of ffn_down get bumped types),
quantizes and writes a new GGUF.  Given the same input it writes the same
bytes as `tools/quantize.py`.  Every preset can name its types, but a type
the port has no encoder for (`quant/blocks.py`: F16, Q8_0, Q4_K, Q6_K)
raises NotImplementedError before anything is written.

Usage: python -m zllm_torch.quantize IN.gguf OUT.gguf Q4_K_M
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .gguf.constants import GGML_BLOCK_SIZES, GGMLType
from .gguf.reader import read_gguf
from .gguf.writer import GGUFWriter
from .quant import blocks as qb

# ftype presets: default type + per-role bumps
FTYPES = {
    "Q4_0": dict(default=GGMLType.Q4_0),
    "Q4_1": dict(default=GGMLType.Q4_1),
    "Q5_0": dict(default=GGMLType.Q5_0),
    "Q5_1": dict(default=GGMLType.Q5_1),
    "Q8_0": dict(default=GGMLType.Q8_0),
    "Q2_K": dict(default=GGMLType.Q2_K, attn_v=GGMLType.Q4_K, output=GGMLType.Q6_K),
    "Q3_K_M": dict(default=GGMLType.Q3_K, attn_v=GGMLType.Q5_K, output=GGMLType.Q6_K),
    "Q4_K_S": dict(default=GGMLType.Q4_K, output=GGMLType.Q6_K),
    "Q4_K_M": dict(default=GGMLType.Q4_K, attn_v=GGMLType.Q6_K,
                   ffn_down_frac=(GGMLType.Q6_K, 0.5), output=GGMLType.Q6_K),
    "Q5_K_S": dict(default=GGMLType.Q5_K, output=GGMLType.Q6_K),
    "Q5_K_M": dict(default=GGMLType.Q5_K, attn_v=GGMLType.Q6_K, output=GGMLType.Q6_K),
    "Q6_K": dict(default=GGMLType.Q6_K),
    "IQ4_NL": dict(default=GGMLType.IQ4_NL, output=GGMLType.Q6_K),
    "IQ4_XS": dict(default=GGMLType.IQ4_XS, output=GGMLType.Q6_K),
    "MXFP4": dict(default=GGMLType.MXFP4, output=GGMLType.Q6_K),
    "IQ1_S": dict(default=GGMLType.IQ1_S, attn_v=GGMLType.Q4_K,
                  embd=GGMLType.Q2_K, output=GGMLType.Q5_K),
    "IQ1_M": dict(default=GGMLType.IQ1_M, attn_v=GGMLType.Q4_K,
                  embd=GGMLType.Q2_K, output=GGMLType.Q5_K),
    "IQ2_XXS": dict(default=GGMLType.IQ2_XXS, attn_v=GGMLType.Q4_K,
                    embd=GGMLType.Q2_K, output=GGMLType.Q5_K),
    "IQ2_XS": dict(default=GGMLType.IQ2_XS, attn_v=GGMLType.Q4_K,
                   embd=GGMLType.Q2_K, output=GGMLType.Q5_K),
    "IQ2_S": dict(default=GGMLType.IQ2_S, attn_v=GGMLType.Q4_K,
                  embd=GGMLType.Q2_K, output=GGMLType.Q5_K),
    "IQ3_XXS": dict(default=GGMLType.IQ3_XXS, attn_v=GGMLType.Q4_K,
                    output=GGMLType.Q5_K),
    "IQ3_S": dict(default=GGMLType.IQ3_S, attn_v=GGMLType.Q4_K,
                  output=GGMLType.Q5_K),
    "TQ1_0": dict(default=GGMLType.TQ1_0, output=GGMLType.Q6_K),
    "TQ2_0": dict(default=GGMLType.TQ2_0, output=GGMLType.Q6_K),
    "F16": dict(default=GGMLType.F16),
    "BF16": dict(default=GGMLType.BF16),
}


def pick_type(name: str, shape, il: int, n_layers: int, preset: dict) -> GGMLType:
    if len(shape) < 2:
        return GGMLType.F32  # norms/biases stay f32
    t = preset["default"]
    if name == "token_embd.weight":
        t = preset.get("embd", GGMLType.Q4_K if t not in (GGMLType.F16, GGMLType.BF16) else t)
    elif name == "output.weight":
        t = preset.get("output", t)
    elif ".attn_v.weight" in name:
        t = preset.get("attn_v", t)
    elif ".ffn_down" in name and "ffn_down_frac" in preset:
        bump, frac = preset["ffn_down_frac"]
        if il < int(n_layers * frac):
            t = bump
    blk, _ = GGML_BLOCK_SIZES[t]
    if shape[-1] % blk != 0:
        t = GGMLType.F16  # non-divisible rows fall back
    return t


def quantize_file(src: str, dst: str, ftype: str, quiet: bool = False) -> dict:
    """Quantize GGUF src -> dst with the ftype preset's role-aware types;
    returns {name: (source type, target type)}."""
    preset = FTYPES[ftype]
    with read_gguf(src) as f:
        n_layers = int(f.kv(f"{f.architecture}.block_count", 0))
        plan = {}
        for name, meta in f.tensors.items():
            il = int(name.split(".")[1]) if name.startswith("blk.") else 0
            plan[name] = pick_type(name, meta.shape, il, n_layers, preset)
        missing = {t.name for name, t in plan.items()
                   if t not in (f.tensors[name].gtype, GGMLType.F32)
                   and t not in qb.supported_encode()}
        if missing:
            raise NotImplementedError(f"{ftype} needs encoders zllm_torch lacks: {sorted(missing)}")

        w = GGUFWriter(dst, alignment=f.alignment)
        for key, val in f.metadata.items():
            if key != "general.file_type":
                w.add(key, val)
        for name, meta in f.tensors.items():
            target = plan[name]
            if target == meta.gtype:
                w.add_tensor(name, np.asarray(f.tensor_bytes(name)), logical_shape=meta.shape,
                             gtype=meta.gtype)
            elif target == GGMLType.F32:
                w.add_tensor(name, f.tensor_f32(name))
            else:
                w.add_tensor(name, qb.quantize(f.tensor_f32(name), target),
                             logical_shape=meta.shape, gtype=target)
            if not quiet:
                print(f"{name}: {meta.gtype.name} -> {target.name}", file=sys.stderr)
        w.write()
        return {name: (f.tensors[name].gtype.name, t.name) for name, t in plan.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("ftype", choices=sorted(FTYPES))
    args = ap.parse_args(argv)
    quantize_file(args.src, args.dst, args.ftype)


if __name__ == "__main__":
    main()
