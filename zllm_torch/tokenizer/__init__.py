"""Tokenizers with special-token partitioning; the engine-facing facade is
`Tokenizer`.  A copy of `zllm.tokenizer` holding the SPM ("llama") model
and `IncrementalDecoder`; BPE, WPM, UGM, RWKV and PLaMo2 are not ported
yet and raise NotImplementedError."""

from __future__ import annotations

from ..gguf.reader import GGUFFile
from .spm import SpmTokenizer
from .vocab import TokenType, Vocab


class Tokenizer:
    """Facade with llama.h-shaped semantics: encode(text, add_special,
    parse_special) -> ids; decode(ids) -> text.  Special tokens are
    partitioned out of the raw text before the inner tokenizer runs
    (reference behavior: src/llama-vocab.cpp tokenizer_st_partition)."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        if vocab.model == "llama":
            self.inner = SpmTokenizer(vocab)
        else:
            raise NotImplementedError(f"tokenizer model {vocab.model!r} not in zllm_torch yet")
        self._specials = vocab.special_tokens()

    @classmethod
    def from_gguf(cls, f: GGUFFile) -> "Tokenizer":
        return cls(Vocab.from_gguf(f))

    # ------------------------------------------------------------------
    def _partition(self, text: str, parse_special: bool):
        """Split text into (is_token, payload) fragments on special tokens."""
        frags: list[tuple[bool, object]] = [(False, text)]
        for st, tid in self._specials:
            if not parse_special and self.vocab.types[tid] in (TokenType.CONTROL, TokenType.UNKNOWN):
                continue
            nxt: list[tuple[bool, object]] = []
            for is_tok, payload in frags:
                if is_tok:
                    nxt.append((is_tok, payload))
                    continue
                s: str = payload  # type: ignore[assignment]
                while True:
                    idx = s.find(st)
                    if idx < 0:
                        if s:
                            nxt.append((False, s))
                        break
                    if idx > 0:
                        nxt.append((False, s[:idx]))
                    nxt.append((True, tid))
                    s = s[idx + len(st) :]
            frags = nxt
        return frags

    def encode(self, text: str, add_special: bool = False, parse_special: bool = False) -> list[int]:
        v = self.vocab
        out: list[int] = []
        if add_special and v.add_bos and v.bos_id >= 0:
            out.append(v.bos_id)
        for is_tok, payload in self._partition(text, parse_special):
            if is_tok:
                out.append(payload)  # type: ignore[arg-type]
            else:
                out.extend(self.inner.encode(payload))  # type: ignore[arg-type]
        if add_special and v.add_eos and v.eos_id >= 0:
            out.append(v.eos_id)
        return out

    def decode(self, ids, skip_special: bool = True) -> str:
        parts: list[bytes] = []
        for tid in ids:
            tid = int(tid)
            if skip_special and self.vocab.types[tid] == TokenType.CONTROL:
                continue
            parts.append(self.inner.decode_piece(tid))
        text = b"".join(parts).decode("utf-8", errors="replace")
        strip = (self.vocab.model == "llama" and self.vocab.add_space_prefix) or (
            self.vocab.model in ("bert", "t5")  # U+2581 is the word marker
        )
        if strip and text.startswith(" "):
            text = text[1:]
        return text

    @property
    def bos_id(self) -> int:
        return self.vocab.bos_id

    @property
    def eos_id(self) -> int:
        return self.vocab.eos_id


def _utf8_complete_prefix_len(b: bytes) -> int:
    """Length of the longest prefix of `b` that ends on a complete UTF-8
    sequence (the tail of an in-flight multi-byte char is held back)."""
    n = len(b)
    i = n
    while i > 0 and n - i < 4 and (b[i - 1] & 0xC0) == 0x80:
        i -= 1
    if i == 0:
        return n if n >= 4 else 0  # orphan continuations: emit as-is
    lead = b[i - 1]
    if lead < 0x80:
        return n
    if lead < 0xC0:
        return n  # invalid lead; emit (decodes to U+FFFD either way)
    need = 2 if lead < 0xE0 else 3 if lead < 0xF0 else 4
    return n if n - (i - 1) >= need else i - 1


class IncrementalDecoder:
    """Streaming detokenizer: per-token UTF-8-safe text deltas.

    The reference server accumulates a running string and emits diffs so
    multi-byte chars split across tokens never stream as U+FFFD
    (tools/server/server-context.cpp incremental piece emission).  This is
    the byte-buffer formulation: pieces accumulate in a byte buffer and
    only the longest complete-UTF-8 prefix is released; the SPM space
    prefix is stripped once, at the very first piece.
    """

    def __init__(self, tok: Tokenizer, skip_special: bool = True):
        self.tok = tok
        self.skip_special = skip_special
        self._buf = b""
        self._first = True

    def push(self, tid: int) -> str:
        tid = int(tid)
        if self.skip_special and self.tok.vocab.types[tid] == TokenType.CONTROL:
            return ""
        piece = self.tok.inner.decode_piece(tid)
        if self._first:
            v = self.tok.vocab
            if v.model == "llama" and v.add_space_prefix and piece.startswith(b" "):
                piece = piece[1:]
            self._first = False
        self._buf += piece
        cut = _utf8_complete_prefix_len(self._buf)
        out, self._buf = self._buf[:cut], self._buf[cut:]
        return out.decode("utf-8", errors="replace")

    def flush(self) -> str:
        out = self._buf.decode("utf-8", errors="replace") if self._buf else ""
        self._buf = b""
        return out
