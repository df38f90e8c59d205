"""GGUF / GGML file-format constants.

The GGUF container format and the GGML quantized block formats are public,
stable on-disk contracts; the authoritative definitions live in the reference
at ggml/include/gguf.h (container) and ggml/src/ggml-common.h:89-430 (block
layouts).  This module re-declares only the *facts* of those formats (enum
values, block/type byte sizes) that any independent implementation must agree
on to read the same files.
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

# Number of elements per superblock row chunk for K-quants.
QK_K = 256


class GGMLType(enum.IntEnum):
    """Tensor element types (ggml.h:390-429). Values are part of the format."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2/Q4_3 (removed upstream)
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35
    MXFP4 = 39


# type -> (elements per block, bytes per block)
GGML_BLOCK_SIZES: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18),
    GGMLType.Q4_1: (32, 20),
    GGMLType.Q5_0: (32, 22),
    GGMLType.Q5_1: (32, 24),
    GGMLType.Q8_0: (32, 34),
    GGMLType.Q8_1: (32, 40),
    GGMLType.Q2_K: (QK_K, 84),
    GGMLType.Q3_K: (QK_K, 110),
    GGMLType.Q4_K: (QK_K, 144),
    GGMLType.Q5_K: (QK_K, 176),
    GGMLType.Q6_K: (QK_K, 210),
    GGMLType.Q8_K: (QK_K, 292),
    GGMLType.IQ2_XXS: (QK_K, 66),
    GGMLType.IQ2_XS: (QK_K, 74),
    GGMLType.IQ3_XXS: (QK_K, 98),
    GGMLType.IQ1_S: (QK_K, 50),
    GGMLType.IQ4_NL: (32, 18),
    GGMLType.IQ3_S: (QK_K, 110),
    GGMLType.IQ2_S: (QK_K, 82),
    GGMLType.IQ4_XS: (QK_K, 136),
    GGMLType.IQ1_M: (QK_K, 56),
    GGMLType.TQ1_0: (QK_K, 54),
    GGMLType.TQ2_0: (QK_K, 66),
    GGMLType.MXFP4: (32, 17),
}


class GGUFValueType(enum.IntEnum):
    """Metadata KV value types (gguf.h:53-83)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


def row_bytes(gtype: GGMLType, n_elements: int) -> int:
    """Bytes used by a contiguous row of `n_elements` of `gtype`."""
    blk, sz = GGML_BLOCK_SIZES[gtype]
    if n_elements % blk != 0:
        raise ValueError(f"row of {n_elements} not divisible by {gtype.name} block {blk}")
    return n_elements // blk * sz


def is_quantized(gtype: GGMLType) -> bool:
    return GGML_BLOCK_SIZES[gtype][0] > 1


# ---------------------------------------------------------------------------
# Well-known metadata keys (subset used by the engine; the authoritative
# registry is the reference's gguf-py/gguf/constants.py and src/llama-arch.cpp)
# ---------------------------------------------------------------------------

class K:
    ARCHITECTURE = "general.architecture"
    NAME = "general.name"
    ALIGNMENT = "general.alignment"
    FILE_TYPE = "general.file_type"
    QUANT_VERSION = "general.quantization_version"

    # model hyper-parameters; format with arch prefix, e.g. "llama.block_count"
    CONTEXT_LENGTH = "{arch}.context_length"
    EMBEDDING_LENGTH = "{arch}.embedding_length"
    BLOCK_COUNT = "{arch}.block_count"
    FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
    HEAD_COUNT = "{arch}.attention.head_count"
    HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
    KEY_LENGTH = "{arch}.attention.key_length"
    VALUE_LENGTH = "{arch}.attention.value_length"
    LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
    LAYERNORM_EPS = "{arch}.attention.layer_norm_epsilon"
    SLIDING_WINDOW = "{arch}.attention.sliding_window"
    ROPE_DIMENSION_COUNT = "{arch}.rope.dimension_count"
    ROPE_FREQ_BASE = "{arch}.rope.freq_base"
    ROPE_SCALING_TYPE = "{arch}.rope.scaling.type"
    ROPE_SCALING_FACTOR = "{arch}.rope.scaling.factor"
    ROPE_SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
    ROPE_SCALING_LOW_FREQ = "{arch}.rope.scaling.low_freq_factor"
    ROPE_SCALING_HIGH_FREQ = "{arch}.rope.scaling.high_freq_factor"
    EXPERT_COUNT = "{arch}.expert_count"
    EXPERT_USED_COUNT = "{arch}.expert_used_count"
    EXPERT_FFN_LENGTH = "{arch}.expert_feed_forward_length"
    EXPERT_SHARED_COUNT = "{arch}.expert_shared_count"
    VOCAB_SIZE = "{arch}.vocab_size"
    LOGIT_SCALE = "{arch}.logit_scale"
    ATTN_LOGIT_SOFTCAP = "{arch}.attn_logit_softcapping"
    FINAL_LOGIT_SOFTCAP = "{arch}.final_logit_softcapping"

    # tokenizer
    TOK_MODEL = "tokenizer.ggml.model"  # "llama"(spm) | "gpt2"(bpe) | ...
    TOK_PRE = "tokenizer.ggml.pre"
    TOK_TOKENS = "tokenizer.ggml.tokens"
    TOK_SCORES = "tokenizer.ggml.scores"
    TOK_TYPES = "tokenizer.ggml.token_type"
    TOK_MERGES = "tokenizer.ggml.merges"
    TOK_BOS = "tokenizer.ggml.bos_token_id"
    TOK_EOS = "tokenizer.ggml.eos_token_id"
    TOK_UNK = "tokenizer.ggml.unknown_token_id"
    TOK_PAD = "tokenizer.ggml.padding_token_id"
    TOK_ADD_BOS = "tokenizer.ggml.add_bos_token"
    TOK_ADD_EOS = "tokenizer.ggml.add_eos_token"
    TOK_ADD_SPACE_PREFIX = "tokenizer.ggml.add_space_prefix"
