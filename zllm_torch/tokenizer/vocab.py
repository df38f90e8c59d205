"""Vocabulary loaded from GGUF metadata.

Mirrors the data model of the reference's llama-vocab (reference:
src/llama-vocab.cpp) — token strings, scores, per-token attribute types,
special ids — without any of its code.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..gguf.reader import GGUFFile


class TokenType(enum.IntEnum):
    """Per-token types stored in tokenizer.ggml.token_type (llama.h)."""

    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


@dataclass
class Vocab:
    model: str  # "llama" (spm) | "gpt2" (bpe) | "bert" (wpm) | ...
    pre: str
    tokens: list[str]
    scores: list[float]
    types: list[int]
    merges: list[str] = field(default_factory=list)
    bos_id: int = -1
    eos_id: int = -1
    unk_id: int = -1
    pad_id: int = -1
    eot_id: int = -1  # end-of-turn (reference: special_eot_id)
    # fill-in-the-middle special ids (reference: llama_vocab fim ids,
    # src/llama-vocab.cpp special_fim_* + llama.h llama_vocab_fim_pre)
    fim_pre_id: int = -1
    fim_suf_id: int = -1
    fim_mid_id: int = -1
    fim_pad_id: int = -1
    fim_rep_id: int = -1
    fim_sep_id: int = -1
    add_bos: bool = False
    add_eos: bool = False
    add_space_prefix: bool = True
    chat_template: str = ""

    token_to_id: dict[str, int] = field(default_factory=dict)
    byte_tokens: dict[int, int] = field(default_factory=dict)  # byte value -> token id

    def __post_init__(self):
        if not self.token_to_id:
            self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        if not self.byte_tokens:
            for i, (t, tt) in enumerate(zip(self.tokens, self.types)):
                if tt == TokenType.BYTE and len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                    self.byte_tokens[int(t[3:5], 16)] = i

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def is_special(self, tid: int) -> bool:
        return self.types[tid] in (TokenType.CONTROL, TokenType.USER_DEFINED, TokenType.UNKNOWN)

    def special_tokens(self) -> list[tuple[str, int]]:
        """(text, id) of tokens eligible for raw-text partition matching,
        longest-first so that overlapping specials match greedily."""
        out = [
            (t, i)
            for i, (t, tt) in enumerate(zip(self.tokens, self.types))
            if tt in (TokenType.CONTROL, TokenType.USER_DEFINED, TokenType.UNKNOWN) and t
        ]
        out.sort(key=lambda p: -len(p[0]))
        return out

    @classmethod
    def from_gguf(cls, f: GGUFFile) -> "Vocab":
        tokens = list(f.kv("tokenizer.ggml.tokens") or [])
        n = len(tokens)
        scores = f.kv("tokenizer.ggml.scores")
        scores = [float(s) for s in scores] if scores is not None else [0.0] * n
        types = f.kv("tokenizer.ggml.token_type")
        types = [int(t) for t in types] if types is not None else [int(TokenType.NORMAL)] * n
        model = f.kv("tokenizer.ggml.model") or "llama"
        is_spm = model == "llama"

        def _tid(*keys, default=-1):
            for key in keys:
                v = f.kv(f"tokenizer.ggml.{key}")
                if v is not None:
                    return int(v)
            return default

        return cls(
            model=model,
            pre=f.kv("tokenizer.ggml.pre") or "default",
            tokens=tokens,
            scores=scores,
            types=types,
            merges=list(f.kv("tokenizer.ggml.merges") or []),
            bos_id=int(f.kv("tokenizer.ggml.bos_token_id", 1 if is_spm else -1)),
            eos_id=int(f.kv("tokenizer.ggml.eos_token_id", 2 if is_spm else -1)),
            unk_id=int(f.kv("tokenizer.ggml.unknown_token_id", 0 if is_spm else -1)),
            pad_id=int(f.kv("tokenizer.ggml.padding_token_id", -1)),
            eot_id=_tid("eot_token_id"),
            # modern + legacy KV names (reference: llama-vocab.cpp
            # LLM_KV_TOKENIZER_FIM_*_ID / LLM_KV_TOKENIZER_PREFIX_ID)
            fim_pre_id=_tid("fim_pre_token_id", "prefix_token_id"),
            fim_suf_id=_tid("fim_suf_token_id", "suffix_token_id"),
            fim_mid_id=_tid("fim_mid_token_id", "middle_token_id"),
            fim_pad_id=_tid("fim_pad_token_id"),
            fim_rep_id=_tid("fim_rep_token_id"),
            fim_sep_id=_tid("fim_sep_token_id"),
            add_bos=bool(f.kv("tokenizer.ggml.add_bos_token", is_spm)),
            add_eos=bool(f.kv("tokenizer.ggml.add_eos_token", False)),
            add_space_prefix=bool(f.kv("tokenizer.ggml.add_space_prefix", is_spm)),
            chat_template=str(f.kv("tokenizer.chat_template") or ""),
        )
