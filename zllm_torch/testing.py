"""Synthetic GGUF model factory for tests, dry runs, and benchmarks.

Builds random llama-family GGUF files with the port's writer and encoders
so the whole stack (reader -> QWeight -> kernels -> runtime) can be
exercised without model downloads.  For the same arguments it writes the
same bytes as `zllm.testing.make_llama_gguf`; the options zllm's factory
lacks write what llama.cpp's converter writes for those models, which
zllm's loader reads:
  * `arch="olmo2"`: no attn_norm / ffn_norm, attn_q_norm [q_dim],
    attn_k_norm [kv_dim], post_attention_norm and post_ffw_norm;
  * `arch="qwen2"`: attn_q.bias, attn_k.bias, attn_v.bias;
  * `arch="qwen3"`: attn_q_norm and attn_k_norm of length head_dim;
  * `n_experts` (any of llama, qwen2moe, qwen3moe): the router
    ffn_gate_inp (F32) and the stacks ffn_{gate,up,down}_exps, as zllm's
    factory writes them (in `ftype`'s types where one is given: the
    stacks take their roles' types, ffn_down_exps bumped as ffn_down);
    `arch="qwen2moe"`: Qwen2's biases and, with `n_ff_shexp`, the shared
    expert ffn_{gate,up,down}_shexp and its gate ffn_gate_inp_shexp [1,
    n_embd] (F32), as zllm's `convert_hf_llama` writes Qwen1.5-MoE;
    `arch="qwen3moe"`: Qwen3's q/k norms.  A stack of more than 4 M
    weights is tiled from one encoded block of 256 rows, expert e's rows
    rotated by e, so that no two experts are equal;
  * `arch="gemma"`, `"gemma2"`, `"gemma3"`: what zllm's `convert_hf_llama`
    writes for Gemma-2 and Gemma-3: attn_norm and ffn_norm; Gemma-2/3 the
    post-norms attn_post_norm and ffn_post_norm; Gemma-3 attn_q_norm and
    attn_k_norm of length head_dim; no output.weight (the head is tied);
    the keys `sliding_window`, `query_pre_attn_scalar`, `attn_softcap`,
    `final_softcap` and `rope_base_swa` set when given, and `rope_scale`
    as linear rope scaling (Gemma-3's full layers);
  * `arch="gptneox"`, `"stablelm"`, `"starcoder2"`: what llama.cpp's
    converter writes for GPT-NeoX (Pythia), StableLM-2 and StarCoder2,
    which zllm's loader reads: LayerNorms (attn_norm, ffn_norm and
    output_norm, each weight with its bias) and `attention.layer_norm_epsilon`;
    gptneox the fused attn_qkv weight and bias (q rows, then k, then v),
    attn_output.bias, the non-gated ffn_up and ffn_down with their biases
    and `use_parallel_residual` (True unless `parallel_residual` says
    otherwise); stablelm the q/k/v biases and the gated FFN; starcoder2
    the q/k/v and attn_output biases and gptneox's MLP; `rope_dim`
    (rope.dimension_count) the rotated dims of a head (partial rope);
    `parallel_residual` writes `use_parallel_residual` on any arch;
  * `head_dim` (q_dim may differ from n_embd), `tied=True` (no
    output.weight), `rope_freqs=True` (Llama-3.1's rope_freqs.weight and
    its llama3 rope-scaling metadata);
  * `ftype=` a preset of `zllm_torch.quantize.FTYPES`: each tensor in the
    type `pick_type` gives its role (the embedding, attn_v and the head
    bumped as llama-quantize bumps them); a type the port has an encoder
    for is encoded as `gtype` is, and an IQ grid type (IQ2_XXS, IQ2_XS,
    IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, IQ1_M), which has none, is written as
    random code bytes (`random_iq_blocks`) scaled to the factory's RMS;
  * `tokenizer="bpe"` with `with_tokenizer=True`: a byte-level BPE
    ("gpt2") vocab for tokenizer.ggml.pre `pre`: the 256 byte tokens,
    merges learned from a fixed text (`bpe_vocab`), the specials
    <|endoftext|>, <|im_start|>, <|im_end|> (CONTROL; bos, eos), and
    [PAD<i>] tokens (UNUSED) up to vocab_size.
"""

from __future__ import annotations

import functools
import heapq
import math
from collections import Counter, defaultdict

import numpy as np

from .gguf.constants import GGMLType
from .gguf.writer import GGUFWriter
from .models.config import LAYER_NORM_ARCHES, NON_GATED_ARCHES
from .quant import blocks as qb
from .quantize import FTYPES, pick_type
from .tokenizer.bpe import PRETOKENIZERS, _byte_encoder, pretokenize
from .tokenizer.vocab import Vocab

ARCHES = ("llama", "olmo2", "qwen2", "qwen3", "gemma", "gemma2", "gemma3", "qwen2moe",
          "qwen3moe", "gptneox", "stablelm", "starcoder2")
# expert stacks of more elements than this are tiled from one encoded
# block of rows (see `_expert_stack`); smaller ones are drawn whole, as
# zllm's factory draws them
_TILE_STACK_ELEMS = 1 << 22
BPE_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
BPE_MERGES = 3000
# the text the synthetic BPE merges are learned from: prose, code, digits,
# whitespace runs and non-ASCII, so that merges cross every class
_BPE_TEXT = """\
The quick brown fox jumps over the lazy dog while the chip counts every byte it reads.
It's what they'll say: we're here, you've seen it, I'm sure he'd know. THEY'LL SAY IT'S TRUE.
In 2024 the model served 1234567 requests at 89.5 ms each; 3.14159 and 2.71828 are constants.
def forward(params, tokens, positions):
    x = params["tok_emb"][tokens]
    for layer in params["layers"]:
        x = layer_forward(layer, x, positions)  # one block
    return rms_norm(x) @ params["output"]
\tTabs\tand  double  spaces,\r\nWindows line breaks\r\n\n\nand trailing whitespace   
Ça coûte 15 € — naïve café, déjà vu, Straße, Ελληνικά, русский текст, العربية, עברית.
中文文本：模型在芯片上运行。日本語のテキスト、한국어 텍스트。 Emoji: 🚀🔥😀👍 ok!
<html><body class="main">Hello, world!</body></html> {"key": [1, 2, 3], "ok": true}
"""


@functools.lru_cache(maxsize=8)
def bpe_vocab(pre: str, n_merges: int) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(tokens, merges) of a byte-level BPE vocab: the 256 GPT-2 byte
    tokens, then one token a merge, the merges learned on `_BPE_TEXT` and
    words drawn from it by a numpy generator of seed 0 (pretokenized with
    `pre`'s pretokenizer): the most frequent adjacent pair first, the
    smallest pair of equal counts first, until `n_merges` or no pair is
    left."""
    rng = np.random.default_rng(0)
    base = _BPE_TEXT.split()
    heads, cuts, tails = (rng.integers(0, hi, 4000) for hi in (len(base), 6, len(base)))
    drawn = [base[i][: 1 + j] + base[k] for i, j, k in zip(heads, cuts, tails)]
    text = _BPE_TEXT + " ".join(drawn)
    enc = _byte_encoder()
    counts = Counter("".join(enc[b] for b in frag.encode("utf-8"))
                     for frag in pretokenize(text, PRETOKENIZERS[pre]))
    words = [list(w) for w in counts]
    freq = [counts[w] for w in counts]
    pairs: Counter = Counter()
    where: dict = defaultdict(set)
    for wi, w in enumerate(words):
        for pair in zip(w, w[1:]):
            pairs[pair] += freq[wi]
            where[pair].add(wi)
    heap = [(-c, pair) for pair, c in pairs.items()]
    heapq.heapify(heap)
    tokens = {enc[b]: None for b in range(256)}  # insertion-ordered
    merges = []
    while heap and len(merges) < n_merges:
        neg, pair = heapq.heappop(heap)
        if pairs.get(pair, 0) != -neg:
            continue  # a stale count
        merged = pair[0] + pair[1]
        merges.append(f"{pair[0]} {pair[1]}")
        tokens.setdefault(merged)
        touched = Counter()
        for wi in sorted(where.pop(pair)):
            w, out, i = words[wi], [], 0
            for old in zip(w, w[1:]):
                pairs[old] -= freq[wi]
                touched[old] += 1
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == pair:
                    out.append(merged)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            words[wi] = out
            for new in zip(out, out[1:]):
                pairs[new] += freq[wi]
                where[new].add(wi)
                touched[new] += 1
        for p in touched:
            if pairs[p] > 0 and p != pair:
                heapq.heappush(heap, (-pairs[p], p))
        pairs.pop(pair, None)
    return tuple(tokens), tuple(merges)


# Llama-3.1's rope scaling (HF rope_scaling, rope_type "llama3"), written as
# {arch}.rope.scaling.* metadata
LLAMA31_ROPE_SCALING = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                            original_context_length=8192)


def synthetic_bpe_vocab(pre: str, vocab_size: int, add_bos: bool = False) -> Vocab:
    """The factory's BPE vocab: `bpe_vocab(pre, ...)` (as many merges as
    `vocab_size` leaves room for, at most BPE_MERGES), the specials
    (bos <|endoftext|>, eos <|im_end|>, CONTROL) and [PAD<id>] tokens
    (UNUSED, as llama.cpp's converter pads) up to `vocab_size`."""
    toks, merges = bpe_vocab(pre, min(BPE_MERGES, vocab_size - 256 - len(BPE_SPECIALS)))
    first = len(toks)
    n_pad = vocab_size - first - len(BPE_SPECIALS)
    if n_pad < 0:
        raise ValueError(f"vocab_size {vocab_size} is too small for a BPE vocab")
    return Vocab(model="gpt2", pre=pre,
                 tokens=[*toks, *BPE_SPECIALS, *(f"[PAD{first + 3 + i}]" for i in range(n_pad))],
                 scores=[0.0] * vocab_size, types=[1] * first + [3] * 3 + [5] * n_pad,
                 merges=list(merges), bos_id=first, eos_id=first + 2, pad_id=first,
                 add_bos=add_bos, add_space_prefix=False)


# a text and its ids in `synthetic_bpe_vocab(pre, 4096)` (encode with
# add_special and parse_special): tests/test_torch_bpe.py holds them equal
# to zllm's, chip_smoke.py encodes the text again on a host without `regex`
BPE_ROUNDTRIP_TEXT = "Grüße aus 東京 — it's 2024!\r\n\tDON'T stop 😀👍🏽  12345678 <|im_start|>ok"
BPE_ROUNDTRIP_IDS = {
    "qwen2": [71, 114, 195, 188, 195, 159, 101, 606, 117, 115, 32, 230, 157, 177, 228, 186, 172,
              536, 376, 406, 32, 50, 48, 50, 52, 33, 13, 10, 9, 68, 79, 78, 936, 280, 116, 111,
              112, 32, 416, 299, 145, 141, 266, 143, 189, 32, 32, 49, 50, 51, 52, 53, 54, 55, 56,
              32, 3257, 264],
    "llama-bpe": [71, 114, 195, 188, 195, 159, 101, 619, 117, 115, 32, 230, 157, 177, 228, 186,
                  172, 548, 377, 411, 32, 425, 52, 33, 13, 10, 9, 68, 79, 78, 950, 280, 116, 111,
                  112, 32, 422, 299, 145, 141, 266, 143, 189, 32, 32, 399, 517, 55, 56, 32, 3257,
                  264],
    "gpt-2": [71, 114, 195, 188, 195, 159, 101, 615, 117, 115, 32, 230, 157, 177, 228, 186, 172,
              546, 380, 413, 735, 33, 13, 10, 9, 68, 79, 78, 39, 84, 280, 116, 111, 112, 32, 424,
              300, 145, 141, 266, 143, 189, 32, 1358, 56, 32, 3257, 264],
}


def _llama3_rope_factors(head_dim: int, base: float) -> np.ndarray:
    """rope_freqs.weight as llama.cpp's converter writes it for Llama-3.1."""
    factor, low, high, orig_ctx = LLAMA31_ROPE_SCALING.values()
    out = []
    for i in range(0, head_dim, 2):
        wavelen = 2 * math.pi * base ** (i / head_dim)
        if wavelen < orig_ctx / high:
            out.append(1.0)
        elif wavelen > orig_ctx / low:
            out.append(factor)
        else:
            smooth = (orig_ctx / wavelen - low) / (high - low)
            out.append(1.0 / ((1 - smooth) / factor + smooth))
    return np.asarray(out, dtype=np.float32)


# the IQ grid formats: no encoder in the port, so a file of one is written
# with random code bytes
IQ_GRID_TYPES = (GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ3_XXS,
                 GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.IQ1_M)


def _set_iq_d(blocks: np.ndarray, gtype: GGMLType, d: float):
    """Write the superblock scale d of every block (in place): the fp16 at
    bytes 0-1, or IQ1_M's, spread over the top nibbles of its four scale
    words (bytes 48-55)."""
    bits = np.array([d], dtype=np.float16).view(np.uint16)[0]
    if gtype == GGMLType.IQ1_M:
        words = blocks[:, 48:56].copy().view("<u2")
        for i in range(4):
            words[:, i] = (words[:, i] & 0x0FFF) | (((int(bits) >> (4 * i)) & 0xF) << 12)
        blocks[:, 48:56] = words.view(np.uint8)
    else:
        blocks[:, 0:2] = np.array([d], dtype=np.float16).view(np.uint8)


def random_iq_blocks(gtype: GGMLType, n_blocks: int, rng: np.random.Generator,
                     rms: float = 0.02) -> np.ndarray:
    """`n_blocks` GGUF blocks of an IQ grid format (uint8 [n_blocks, block
    bytes]): every byte from `rng`, then one fp16 d in every block, chosen
    so that the decoded weights' RMS is about `rms` (measured on the first
    256 blocks decoded with d = 1).  Every grid row, sign and group scale
    is a valid value, so a random block is a valid one."""
    size = qb.GGML_BLOCK_SIZES[gtype][1]
    blocks = np.frombuffer(rng.bytes(n_blocks * size), dtype=np.uint8).reshape(n_blocks,
                                                                                 size).copy()
    _set_iq_d(blocks, gtype, 1.0)
    unit = float(np.sqrt(np.mean(qb.dequantize(blocks[:256], gtype) ** 2)))
    _set_iq_d(blocks, gtype, rms / unit)
    return blocks


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
    arch: str = "llama",
    norm_eps: float = 1e-5,
    head_dim: int | None = None,
    tied: bool = False,
    rope_freqs: bool = False,
    tokenizer: str = "spm",
    pre: str = "qwen2",
    ftype: str | None = None,
    sliding_window: int = 0,
    query_pre_attn_scalar: float = 0.0,
    attn_softcap: float = 0.0,
    final_softcap: float = 0.0,
    rope_base_swa: float | None = None,
    rope_scale: float = 1.0,
    n_ff_shexp: int = 0,
    rope_dim: int | None = None,
    parallel_residual: bool | None = None,
) -> str:
    if arch not in ARCHES:
        raise ValueError(f"arch {arch!r}: the factory writes {ARCHES}")
    olmo2 = arch == "olmo2"
    layer_norm = arch in LAYER_NORM_ARCHES
    if parallel_residual is None and arch == "gptneox":
        parallel_residual = True
    gemma = arch.startswith("gemma")
    tied = tied or gemma
    rng = np.random.default_rng(seed)
    head_dim = head_dim or n_embd // n_heads
    q_dim = n_heads * head_dim
    kv_dim = n_kv_heads * head_dim

    w = GGUFWriter(path)
    w.add("general.architecture", arch)
    w.add("general.name", "zllm-synthetic")
    w.add(f"{arch}.block_count", n_layers)
    w.add(f"{arch}.context_length", ctx_len)
    w.add(f"{arch}.embedding_length", n_embd)
    w.add(f"{arch}.feed_forward_length", n_ff)
    w.add(f"{arch}.attention.head_count", n_heads)
    w.add(f"{arch}.attention.head_count_kv", n_kv_heads)
    w.add(f"{arch}.attention.key_length", head_dim)
    w.add(f"{arch}.attention.value_length", head_dim)
    w.add(f"{arch}.attention.layer_norm{'' if layer_norm else '_rms'}_epsilon", norm_eps)
    w.add(f"{arch}.rope.freq_base", rope_base)
    w.add(f"{arch}.rope.dimension_count", rope_dim or head_dim)
    w.add(f"{arch}.vocab_size", vocab_size)
    if parallel_residual is not None:
        w.add(f"{arch}.use_parallel_residual", bool(parallel_residual))
    if n_experts:
        w.add(f"{arch}.expert_count", n_experts)
        w.add(f"{arch}.expert_used_count", n_experts_used)
        w.add(f"{arch}.expert_feed_forward_length", n_ff)
    if n_ff_shexp:
        w.add(f"{arch}.expert_shared_count", 1)
        w.add(f"{arch}.expert_shared_feed_forward_length", n_ff_shexp)
    if rope_freqs:
        for key, val in LLAMA31_ROPE_SCALING.items():
            w.add(f"{arch}.rope.scaling.{key}", val)
    if rope_scale != 1.0:
        w.add(f"{arch}.rope.scaling.type", "linear")
        w.add(f"{arch}.rope.scaling.factor", float(rope_scale))
    for key, val in (("attention.sliding_window", int(sliding_window)),
                     ("attention.query_pre_attn_scalar", float(query_pre_attn_scalar)),
                     ("attn_logit_softcapping", float(attn_softcap)),
                     ("final_logit_softcapping", float(final_softcap)),
                     ("rope.freq_base_swa", rope_base_swa)):
        if val:
            w.add(f"{arch}.{key}", val)
    if with_tokenizer and tokenizer == "bpe":  # Llama-3 adds bos, Qwen does not
        v = synthetic_bpe_vocab(pre, vocab_size, add_bos=arch == "llama")
        w.add("tokenizer.ggml.model", v.model)
        w.add("tokenizer.ggml.pre", v.pre)
        w.add("tokenizer.ggml.tokens", v.tokens)
        w.add("tokenizer.ggml.token_type", v.types)
        w.add("tokenizer.ggml.merges", v.merges)
        w.add("tokenizer.ggml.bos_token_id", v.bos_id)
        w.add("tokenizer.ggml.eos_token_id", v.eos_id)
        w.add("tokenizer.ggml.padding_token_id", v.pad_id)
        w.add("tokenizer.ggml.add_bos_token", v.add_bos)
    elif with_tokenizer:
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

    def tensor_type(name: str, shape, force_f32=False) -> GGMLType:
        t = GGMLType.F32 if force_f32 else gtype
        if ftype is not None and not force_f32:
            il = int(name.split(".")[1]) if name.startswith("blk.") else 0
            t = pick_type(name, shape, il, n_layers, FTYPES[ftype])
        blk, _ = qb.GGML_BLOCK_SIZES[t]
        return GGMLType.F32 if shape[-1] % blk != 0 else t

    def draw(shape, scale, t: GGMLType) -> np.ndarray:
        """Random rows of `shape` in type t: f32 values, or the encoded
        rows (uint8 [rows, row bytes])."""
        blk, _ = qb.GGML_BLOCK_SIZES[t]
        if t in IQ_GRID_TYPES:
            return random_iq_blocks(t, math.prod(shape) // blk, rng, scale).reshape(shape[0], -1)
        # this image's numpy RNG runs at only ~2M elem/s, so big tensors are
        # synthesized by quantizing one random row-block and tiling the
        # encoded bytes — valid blocks, near-free, fine for perf/shape work
        rows = shape[0] if len(shape) == 2 else 1
        if len(shape) == 2 and rows > 512:
            base_rows = 256
            x = (rng.standard_normal((base_rows, shape[1]), dtype=np.float32) * scale)
            base = x if t == GGMLType.F32 else qb.quantize(x, t)
            return np.ascontiguousarray(np.tile(base, (rows // base_rows + 1, 1))[:rows])
        x = (rng.standard_normal(shape, dtype=np.float32) * scale)
        return x if t == GGMLType.F32 else qb.quantize(x, t)

    def emit(name: str, shape, scale=0.02, force_f32=False, parts=None):
        """One tensor of `shape`; `parts` (row counts): its rows drawn part
        by part and joined (a fused projection whose parts differ)."""
        t = tensor_type(name, shape, force_f32)
        data = np.concatenate([draw((n, *shape[1:]), scale, t) for n in parts]) if parts \
            else draw(shape, scale, t)
        if t == GGMLType.F32:
            w.add_tensor(name, data)
        else:
            w.add_tensor(name, data, logical_shape=tuple(shape), gtype=t)

    emit("token_embd.weight", (vocab_size, n_embd))
    if rope_freqs:
        w.add_tensor("rope_freqs.weight", _llama3_rope_factors(head_dim, rope_base))
    for il in range(n_layers):
        o = f"blk.{il}."
        if not olmo2:
            emit(o + "attn_norm.weight", (n_embd,), 1.0, force_f32=True)
        if layer_norm:
            emit(o + "attn_norm.bias", (n_embd,), 0.1, force_f32=True)
        if arch == "gptneox":  # llama.cpp's fused q|k|v rows and their bias
            qkv = (q_dim + 2 * kv_dim, n_embd)
            emit(o + "attn_qkv.weight", qkv, parts=(q_dim, kv_dim, kv_dim))
            emit(o + "attn_qkv.bias", qkv[:1], 0.5, force_f32=True)
        else:
            emit(o + "attn_q.weight", (q_dim, n_embd))
            emit(o + "attn_k.weight", (kv_dim, n_embd))
            emit(o + "attn_v.weight", (kv_dim, n_embd))
        if arch in ("qwen2", "qwen2moe", "stablelm", "starcoder2"):
            emit(o + "attn_q.bias", (q_dim,), 0.5, force_f32=True)
            emit(o + "attn_k.bias", (kv_dim,), 0.5, force_f32=True)
            emit(o + "attn_v.bias", (kv_dim,), 0.5, force_f32=True)
        if arch in ("qwen3", "gemma3", "qwen3moe"):
            emit(o + "attn_q_norm.weight", (head_dim,), 1.0, force_f32=True)
            emit(o + "attn_k_norm.weight", (head_dim,), 1.0, force_f32=True)
        emit(o + "attn_output.weight", (n_embd, q_dim))
        if arch in NON_GATED_ARCHES:
            emit(o + "attn_output.bias", (n_embd,), 0.1, force_f32=True)
        if olmo2:
            emit(o + "attn_q_norm.weight", (q_dim,), 1.0, force_f32=True)
            emit(o + "attn_k_norm.weight", (kv_dim,), 1.0, force_f32=True)
            emit(o + "post_attention_norm.weight", (n_embd,), 1.0, force_f32=True)
        else:
            if arch in ("gemma2", "gemma3"):
                emit(o + "attn_post_norm.weight", (n_embd,), 1.0, force_f32=True)
            emit(o + "ffn_norm.weight", (n_embd,), 1.0, force_f32=True)
        if layer_norm:
            emit(o + "ffn_norm.bias", (n_embd,), 0.1, force_f32=True)
        if arch in NON_GATED_ARCHES:  # up -> gelu -> down, with biases
            emit(o + "ffn_up.weight", (n_ff, n_embd))
            emit(o + "ffn_up.bias", (n_ff,), 0.1, force_f32=True)
            emit(o + "ffn_down.weight", (n_embd, n_ff))
            emit(o + "ffn_down.bias", (n_embd,), 0.1, force_f32=True)
        elif n_experts:
            emit(o + "ffn_gate_inp.weight", (n_experts, n_embd), force_f32=True)
            for stack, shp in (
                ("ffn_gate_exps", (n_ff, n_embd)),
                ("ffn_up_exps", (n_ff, n_embd)),
                ("ffn_down_exps", (n_embd, n_ff)),
            ):
                shape = (n_experts,) + shp
                t = gtype
                if ftype is not None:
                    t = pick_type(o + stack + ".weight", shape, il, n_layers, FTYPES[ftype])
                if shp[-1] % qb.GGML_BLOCK_SIZES[t][0] != 0:
                    t = GGMLType.F32
                _expert_stack(w, o + stack + ".weight", shape, t, rng)
            if n_ff_shexp:
                emit(o + "ffn_gate_shexp.weight", (n_ff_shexp, n_embd))
                emit(o + "ffn_up_shexp.weight", (n_ff_shexp, n_embd))
                emit(o + "ffn_down_shexp.weight", (n_embd, n_ff_shexp))
                emit(o + "ffn_gate_inp_shexp.weight", (1, n_embd), force_f32=True)
        else:
            emit(o + "ffn_gate.weight", (n_ff, n_embd))
            emit(o + "ffn_up.weight", (n_ff, n_embd))
            emit(o + "ffn_down.weight", (n_embd, n_ff))
        if olmo2:
            emit(o + "post_ffw_norm.weight", (n_embd,), 1.0, force_f32=True)
        if arch in ("gemma2", "gemma3"):
            emit(o + "ffn_post_norm.weight", (n_embd,), 1.0, force_f32=True)
    emit("output_norm.weight", (n_embd,), 1.0, force_f32=True)
    if layer_norm:
        emit("output_norm.bias", (n_embd,), 0.1, force_f32=True)
    if not tied:
        emit("output.weight", (vocab_size, n_embd))
    w.write()
    return path


def _expert_stack(w: GGUFWriter, name: str, shape, t: GGMLType, rng: np.random.Generator):
    """One expert stack [E, N, K] of type t: drawn whole (N(0, 0.02)) as
    zllm's factory draws it, or, above _TILE_STACK_ELEMS weights, one block
    of 256 rows drawn and encoded, expert e's row r the block's row (r + e)
    % 256 (each expert a rotation of the block's rows, so no two are
    equal)."""
    e, n, k = shape
    if math.prod(shape) <= _TILE_STACK_ELEMS:
        if t in IQ_GRID_TYPES:
            raw = random_iq_blocks(t, math.prod(shape) // 256, rng, 0.02)
            w.add_tensor(name, raw.reshape(e, n, -1), logical_shape=shape, gtype=t)
            return
        x = rng.standard_normal(shape).astype(np.float32) * 0.02
        if t == GGMLType.F32:
            w.add_tensor(name, x)
        else:
            w.add_tensor(name, qb.quantize(x, t), logical_shape=x.shape, gtype=t)
        return
    base_rows = 256
    if t in IQ_GRID_TYPES:
        base = random_iq_blocks(t, base_rows * k // 256, rng, 0.02).reshape(base_rows, -1)
    else:
        base = rng.standard_normal((base_rows, k), dtype=np.float32) * 0.02
        if t != GGMLType.F32:
            base = qb.quantize(base, t)
    rows = (np.arange(n)[None, :] + np.arange(e)[:, None]) % base_rows
    data = np.ascontiguousarray(base[rows])  # [E, N, row]
    if t == GGMLType.F32:
        w.add_tensor(name, data)
    else:
        w.add_tensor(name, data, logical_shape=shape, gtype=t)


# TinyLlama-1.1B geometry (22 layers, 2048 emb, 32 heads/4 kv, ff 5632),
# the model shape the chip smoke test drives at full width
TINYLLAMA_SHAPE = dict(
    n_layers=22, n_embd=2048, n_heads=32, n_kv_heads=4, n_ff=5632, vocab_size=32000
)

# OLMo-2-0425-1B (huggingface.co/allenai/OLMo-2-0425-1B config.json): 16
# layers, 2048 emb, 16 heads / 16 kv (head_dim 128), ff 8192, vocab 100352,
# rope theta 500000, rms_norm_eps 1e-6, untied head
OLMO2_1B_SHAPE = dict(
    arch="olmo2", n_layers=16, n_embd=2048, n_heads=16, n_kv_heads=16, n_ff=8192,
    vocab_size=100352, rope_base=500000.0, norm_eps=1e-6,
)

# Qwen3-1.7B (huggingface.co/Qwen/Qwen3-1.7B config.json): 28 layers, 2048
# emb, 16 heads / 8 kv of 128, ff 6144, vocab 151936, rope theta 1e6,
# rms_norm_eps 1e-6, tied embeddings, a byte-level BPE vocab (pre "qwen2")
QWEN3_1_7B_SHAPE = dict(
    arch="qwen3", n_layers=28, n_embd=2048, n_heads=16, n_kv_heads=8, head_dim=128, n_ff=6144,
    vocab_size=151936, rope_base=1e6, norm_eps=1e-6, ctx_len=40960, tied=True,
    tokenizer="bpe", pre="qwen2",
)

# Qwen2.5-1.5B (huggingface.co/Qwen/Qwen2.5-1.5B config.json): 28 layers,
# 1536 emb, 12 heads / 2 kv of 128, ff 8960, vocab 151936, rope theta 1e6,
# rms_norm_eps 1e-6, q/k/v biases, tied embeddings, BPE vocab (pre "qwen2")
QWEN25_1_5B_SHAPE = dict(
    arch="qwen2", n_layers=28, n_embd=1536, n_heads=12, n_kv_heads=2, head_dim=128, n_ff=8960,
    vocab_size=151936, rope_base=1e6, norm_eps=1e-6, ctx_len=32768, tied=True,
    tokenizer="bpe", pre="qwen2",
)

# Gemma-2-2B (huggingface.co/google/gemma-2-2b config.json): 26 layers, 2304
# emb, 8 heads / 4 kv of 256, ff 9216, vocab 256000, rms_norm_eps 1e-6, a
# 4096-token window on every other layer (layer 0 first), attention and
# final logit softcaps 50 and 30, query_pre_attn_scalar 256, tied head
GEMMA2_2B_SHAPE = dict(
    arch="gemma2", n_layers=26, n_embd=2304, n_heads=8, n_kv_heads=4, head_dim=256, n_ff=9216,
    vocab_size=256000, norm_eps=1e-6, ctx_len=8192, sliding_window=4096,
    query_pre_attn_scalar=256, attn_softcap=50.0, final_softcap=30.0,
)

# Gemma-3-4B's text stack (huggingface.co/google/gemma-3-4b-it config.json,
# text_config): 34 layers, 2560 emb, 8 heads / 4 kv of 256, ff 10240, vocab
# 262144, rms_norm_eps 1e-6, a 1024-token window on five layers of six,
# rope theta 1e6 with linear x8 scaling on the full layers and 1e4 on the
# windowed ones, per-head q/k norms, query_pre_attn_scalar 256, tied head
GEMMA3_4B_SHAPE = dict(
    arch="gemma3", n_layers=34, n_embd=2560, n_heads=8, n_kv_heads=4, head_dim=256, n_ff=10240,
    vocab_size=262144, norm_eps=1e-6, ctx_len=131072, sliding_window=1024, rope_base=1e6,
    rope_base_swa=10000.0, rope_scale=8.0, query_pre_attn_scalar=256,
)

# Gemma-2B (huggingface.co/google/gemma-2b config.json): 18 layers, 2048
# emb, 8 heads / 1 kv of 256 (MQA), ff 16384, vocab 256000, rms_norm_eps
# 1e-6, no window, tied head
GEMMA_2B_SHAPE = dict(
    arch="gemma", n_layers=18, n_embd=2048, n_heads=8, n_kv_heads=1, head_dim=256, n_ff=16384,
    vocab_size=256000, norm_eps=1e-6, ctx_len=8192,
)

# Qwen3-30B-A3B (huggingface.co/Qwen/Qwen3-30B-A3B config.json): 48 layers,
# 2048 emb, 32 heads / 4 kv of 128, 128 experts of 768 (8 used,
# norm_topk_prob true), vocab 151936, rope theta 1e6, rms_norm_eps 1e-6,
# untied head, a byte-level BPE vocab (pre "qwen2"); feed_forward_length is
# written as the expert FFN (the dense 6144 no layer uses)
QWEN3_30B_A3B_SHAPE = dict(
    arch="qwen3moe", n_layers=48, n_embd=2048, n_heads=32, n_kv_heads=4, head_dim=128, n_ff=768,
    n_experts=128, n_experts_used=8, vocab_size=151936, rope_base=1e6, norm_eps=1e-6,
    ctx_len=40960, tokenizer="bpe", pre="qwen2",
)

# Mixtral-8x7B-v0.1 (huggingface.co/mistralai/Mixtral-8x7B-v0.1 config.json):
# 32 layers, 4096 emb, 32 heads / 8 kv of 128, 8 experts of 14336 (2 used),
# vocab 32000, rope theta 1e6, rms_norm_eps 1e-5, untied head, SPM vocab
MIXTRAL_8X7B_SHAPE = dict(
    arch="llama", n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=8, n_ff=14336, n_experts=8,
    n_experts_used=2, vocab_size=32000, rope_base=1e6, norm_eps=1e-5, ctx_len=32768,
)

# Qwen1.5-MoE-A2.7B (huggingface.co/Qwen/Qwen1.5-MoE-A2.7B config.json): 24
# layers, 2048 emb, 16 heads / 16 kv of 128, 60 experts of 1408 (4 used,
# norm_topk_prob false), a shared expert of 5632 behind its sigmoid gate,
# q/k/v biases, vocab 151936, rope theta 1e6, rms_norm_eps 1e-6, untied head
QWEN15_MOE_A27B_SHAPE = dict(
    arch="qwen2moe", n_layers=24, n_embd=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    n_ff=1408, n_experts=60, n_experts_used=4, n_ff_shexp=5632, vocab_size=151936,
    rope_base=1e6, norm_eps=1e-6, ctx_len=8192, tokenizer="bpe", pre="qwen2",
)

# Pythia-1.4B (huggingface.co/EleutherAI/pythia-1.4b config.json): 24
# layers, 2048 emb, 16 heads / 16 kv of 128, rotary_pct 0.25 (32 of 128
# dims), rotary_emb_base 10000, ff 8192 (exact gelu), vocab 50304,
# layer_norm_eps 1e-5, use_parallel_residual, biases everywhere, untied
# head; GPT-NeoX's BPE vocab (pre "gpt-2")
PYTHIA_1_4B_SHAPE = dict(
    arch="gptneox", n_layers=24, n_embd=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    n_ff=8192, vocab_size=50304, rope_dim=32, rope_base=10000.0, norm_eps=1e-5, ctx_len=2048,
    tokenizer="bpe", pre="gpt-2",
)

# StableLM-2-1.6B (huggingface.co/stabilityai/stablelm-2-1_6b config.json):
# 24 layers, 2048 emb, 32 heads / 32 kv of 64, partial_rotary_factor 0.25
# (16 of 64 dims), rope theta 10000, ff 5632 (gated SiLU), vocab 100352,
# layer_norm_eps 1e-5, q/k/v biases (no wo bias), untied head; pre
# "stablelm2"
STABLELM2_1_6B_SHAPE = dict(
    arch="stablelm", n_layers=24, n_embd=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    n_ff=5632, vocab_size=100352, rope_dim=16, rope_base=10000.0, norm_eps=1e-5, ctx_len=4096,
    tokenizer="bpe", pre="stablelm2",
)

# StarCoder2-3B (huggingface.co/bigcode/starcoder2-3b config.json): 30
# layers, 3072 emb, 24 heads / 2 kv of 128 (G 12), full rope at theta
# 999999.4420358813, ff 12288 (tanh gelu), vocab 49152, norm_epsilon 1e-5,
# biases everywhere, the head written as its own output.weight; pre
# "starcoder"; its 4096-token sliding window is not written (a file with
# one is refused)
STARCODER2_3B_SHAPE = dict(
    arch="starcoder2", n_layers=30, n_embd=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    n_ff=12288, vocab_size=49152, rope_base=999999.4420358813, norm_eps=1e-5, ctx_len=16384,
    tokenizer="bpe", pre="starcoder",
)
