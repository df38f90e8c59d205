"""Synthetic GGUF model factory for tests, dry runs, and benchmarks.

Builds random llama-family GGUF files with the port's writer + Q4_K
encoder so the whole stack (reader -> QWeight -> kernels -> runtime) can be
exercised without model downloads.  For the same arguments it writes the
same bytes as `zllm.testing.make_llama_gguf`.
"""

from __future__ import annotations

import numpy as np

from .gguf.constants import GGMLType
from .gguf.writer import GGUFWriter
from .quant import blocks as qb


def make_llama_gguf(
    path: str,
    *,
    n_layers: int = 2,
    n_embd: int = 256,
    n_heads: int = 4,
    n_kv_heads: int = 2,
    n_ff: int = 512,
    vocab_size: int = 512,
    gtype: GGMLType = GGMLType.Q4_K,
    seed: int = 0,
    rope_base: float = 10000.0,
    ctx_len: int = 4096,
    n_experts: int = 0,
    n_experts_used: int = 2,
    with_tokenizer: bool = False,
) -> str:
    rng = np.random.default_rng(seed)
    head_dim = n_embd // n_heads
    q_dim = n_heads * head_dim
    kv_dim = n_kv_heads * head_dim

    w = GGUFWriter(path)
    w.add("general.architecture", "llama")
    w.add("general.name", "zllm-synthetic")
    w.add("llama.block_count", n_layers)
    w.add("llama.context_length", ctx_len)
    w.add("llama.embedding_length", n_embd)
    w.add("llama.feed_forward_length", n_ff)
    w.add("llama.attention.head_count", n_heads)
    w.add("llama.attention.head_count_kv", n_kv_heads)
    w.add("llama.attention.key_length", head_dim)
    w.add("llama.attention.value_length", head_dim)
    w.add("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add("llama.rope.freq_base", rope_base)
    w.add("llama.rope.dimension_count", head_dim)
    w.add("llama.vocab_size", vocab_size)
    if n_experts:
        w.add("llama.expert_count", n_experts)
        w.add("llama.expert_used_count", n_experts_used)
        w.add("llama.expert_feed_forward_length", n_ff)
    if with_tokenizer:
        # byte-level SPM vocab (vocab_size >= 259): unk/bos/eos + 256 bytes
        assert vocab_size >= 259, "with_tokenizer needs vocab_size >= 259"
        tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
        tokens += [f"<extra{i}>" for i in range(vocab_size - len(tokens))]
        types = [2, 3, 3] + [6] * 256 + [1] * (vocab_size - 259)
        w.add("tokenizer.ggml.model", "llama")
        w.add("tokenizer.ggml.pre", "default")
        w.add("tokenizer.ggml.tokens", tokens)
        w.add("tokenizer.ggml.scores", [0.0] * vocab_size)
        w.add("tokenizer.ggml.token_type", types)
        w.add("tokenizer.ggml.bos_token_id", 1)
        w.add("tokenizer.ggml.eos_token_id", 2)
        w.add("tokenizer.ggml.unknown_token_id", 0)
        w.add("tokenizer.ggml.add_bos_token", True)
        w.add("tokenizer.ggml.add_space_prefix", False)

    def emit(name: str, shape, scale=0.02, force_f32=False):
        t = GGMLType.F32 if force_f32 else gtype
        blk, _ = qb.GGML_BLOCK_SIZES[t]
        if shape[-1] % blk != 0:
            t = GGMLType.F32
        # this image's numpy RNG runs at only ~2M elem/s, so big tensors are
        # synthesized by quantizing one random row-block and tiling the
        # encoded bytes — valid blocks, near-free, fine for perf/shape work
        rows = shape[0] if len(shape) == 2 else 1
        if len(shape) == 2 and rows > 512:
            base_rows = 256
            x = (rng.standard_normal((base_rows, shape[1]), dtype=np.float32) * scale)
            if t == GGMLType.F32:
                data = np.tile(x, (rows // base_rows + 1, 1))[:rows]
                w.add_tensor(name, np.ascontiguousarray(data))
            else:
                raw = qb.quantize(x, t)
                data = np.tile(raw, (rows // base_rows + 1, 1))[:rows]
                w.add_tensor(name, np.ascontiguousarray(data), logical_shape=shape, gtype=t)
            return
        x = (rng.standard_normal(shape, dtype=np.float32) * scale)
        if t == GGMLType.F32:
            w.add_tensor(name, x)
        else:
            w.add_tensor(name, qb.quantize(x, t), logical_shape=x.shape, gtype=t)

    emit("token_embd.weight", (vocab_size, n_embd))
    for il in range(n_layers):
        o = f"blk.{il}."
        emit(o + "attn_norm.weight", (n_embd,), 1.0, force_f32=True)
        emit(o + "attn_q.weight", (q_dim, n_embd))
        emit(o + "attn_k.weight", (kv_dim, n_embd))
        emit(o + "attn_v.weight", (kv_dim, n_embd))
        emit(o + "attn_output.weight", (n_embd, q_dim))
        emit(o + "ffn_norm.weight", (n_embd,), 1.0, force_f32=True)
        if n_experts:
            emit(o + "ffn_gate_inp.weight", (n_experts, n_embd), force_f32=True)
            for stack, shp in (
                ("ffn_gate_exps", (n_ff, n_embd)),
                ("ffn_up_exps", (n_ff, n_embd)),
                ("ffn_down_exps", (n_embd, n_ff)),
            ):
                x = rng.standard_normal((n_experts,) + shp).astype(np.float32) * 0.02
                t = gtype
                if shp[-1] % qb.GGML_BLOCK_SIZES[t][0] != 0:
                    t = GGMLType.F32
                if t == GGMLType.F32:
                    w.add_tensor(o + stack + ".weight", x)
                else:
                    w.add_tensor(
                        o + stack + ".weight", qb.quantize(x, t),
                        logical_shape=x.shape, gtype=t,
                    )
        else:
            emit(o + "ffn_gate.weight", (n_ff, n_embd))
            emit(o + "ffn_up.weight", (n_ff, n_embd))
            emit(o + "ffn_down.weight", (n_embd, n_ff))
    emit("output_norm.weight", (n_embd,), 1.0, force_f32=True)
    emit("output.weight", (vocab_size, n_embd))
    w.write()
    return path


# TinyLlama-1.1B geometry (22 layers, 2048 emb, 32 heads/4 kv, ff 5632),
# the model shape the chip smoke test drives at full width
TINYLLAMA_SHAPE = dict(
    n_layers=22, n_embd=2048, n_heads=32, n_kv_heads=4, n_ff=5632, vocab_size=32000
)
