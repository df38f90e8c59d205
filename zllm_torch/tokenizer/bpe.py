"""Byte-level BPE tokenizer (the "gpt2" GGUF tokenizer model).

The counterpart of `zllm/tokenizer/bpe.py`: rank-based pair merging over
GPT-2 byte-encoded pretokens, with the pretokenizers written out by hand
instead of compiled from `regex` patterns (the `regex` package, which the
patterns' `\\p{L}` / `\\p{N}` classes need, is not a dependency of the
port).  Each scanner reproduces `regex.finditer` over its pattern:
alternatives tried in order at each position, the first that matches wins
(leftmost-first), greedy runs backed off only as far as the pattern makes
them; characters no alternative matches are kept as fragments of their
own, as zllm's `pretokenize` keeps them.  The patterns (HF tokenizer.json,
the reference's src/llama-vocab.cpp), and one pair of them:

  gpt2    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)
  llama3  (?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])
          |[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}| ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*
          |\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+
  qwen2   llama3 with \\p{N} in place of \\p{N}{1,3}
  starcoder  \\p{N}, then gpt2 over each fragment: every numeric character
          a fragment of its own, gpt2's pattern on the runs between them
  gpt-4o  [^\\r\\n\\p{L}\\p{N}]?[\\p{Lu}\\p{Lt}\\p{Lm}\\p{Lo}\\p{M}]*
          [\\p{Ll}\\p{Lm}\\p{Lo}\\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?
          |[^\\r\\n\\p{L}\\p{N}]?[\\p{Lu}\\p{Lt}\\p{Lm}\\p{Lo}\\p{M}]+
          [\\p{Ll}\\p{Lm}\\p{Lo}\\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?
          |\\p{N}{1,3}| ?[^\\s\\p{L}\\p{N}]+[\\r\\n/]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+

`\\s` is Unicode White_Space (as in `regex`, which leaves out U+001C-U+001F
where `str.isspace` takes them), `\\p{L}` the general categories L*,
`\\p{N}` N*, `\\p{M}` M* and gpt-4o's letter classes Lu, Lt, Lm, Lo and Ll,
all from `unicodedata` (Python 3.12's is Unicode 15.0: a character whose
category a newer Unicode changed may split otherwise than `regex` splits
it); `(?i:'s)` takes S and the long s U+017F, as `regex`'s case folding
does.
"""

from __future__ import annotations

import functools
import unicodedata

from .vocab import TokenType, Vocab

_WHITE_SPACE = frozenset(chr(c) for c in (
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B), 0x2028, 0x2029,
    0x202F, 0x205F, 0x3000))
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_CRLF = "\r\n"

# pretokenizer of each ported tokenizer.ggml.pre name (zllm's PRE_PATTERNS
# entries that hold exactly one of the three patterns, or \p{N} then gpt2)
PRETOKENIZERS = {
    **dict.fromkeys(("gpt-2", "mpt", "olmo", "jais"), "gpt2"),
    **dict.fromkeys(("llama3", "llama-bpe", "dbrx", "smaug-bpe", "llama4", "chatglm-bpe"),
                    "llama3"),
    **dict.fromkeys(("qwen2", "stablelm2"), "qwen2"),
    **dict.fromkeys(("starcoder", "refact", "command-r", "smollm", "codeshell", "exaone"),
                    "starcoder"),
    "gpt-4o": "gpt-4o",
}


@functools.lru_cache(maxsize=1)
def _byte_encoder() -> dict[int, str]:
    """GPT-2's byte -> visible code point table."""
    keep = set(range(ord("!"), ord("~") + 1)) | set(range(0xA1, 0xAD)) | set(range(0xAE, 0x100))
    mapping, extra = {}, 0
    for b in range(256):
        if b in keep:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + extra)
            extra += 1
    return mapping


@functools.lru_cache(maxsize=1)
def _byte_decoder() -> dict[str, int]:
    return {c: b for b, c in _byte_encoder().items()}


@functools.lru_cache(maxsize=None)
def char_class(c: str) -> str:
    """"S" for \\s, "L" for \\p{L}, "N" for \\p{N}, "O" for anything else."""
    if c in _WHITE_SPACE:
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "O"


@functools.lru_cache(maxsize=None)
def case_class(c: str) -> str:
    """gpt-4o's classes: "S" for \\s, the letter's category (Lu, Ll, Lt, Lm,
    Lo), "M" for \\p{M}, "N" for \\p{N}, "O" for anything else."""
    if c in _WHITE_SPACE:
        return "S"
    cat = unicodedata.category(c)
    return cat if cat[0] == "L" else cat[0] if cat[0] in "MN" else "O"


# gpt-4o's [\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}] and [\p{Ll}\p{Lm}\p{Lo}\p{M}]
_UPPERISH = frozenset(("Lu", "Lt", "Lm", "Lo", "M"))
_LOWERISH = frozenset(("Ll", "Lm", "Lo", "M"))
_CASE_FOLDS = {"s": "sS\u017f"}  # (?i): the characters each contraction letter matches


def _run(k: list[str], i: int, cls: str, limit: int | None = None) -> int:
    """End of the run of class `cls` starting at i (at most `limit` long)."""
    n = len(k) if limit is None else min(len(k), i + limit)
    while i < n and k[i] == cls:
        i += 1
    return i


def _contraction(text: str, i: int, any_case: bool) -> int:
    """End of the contraction 's 't 're 've 'm 'll 'd at i, or -1."""
    for suf in _CONTRACTIONS:
        seg = text[i + 1:i + 1 + len(suf)]
        if len(seg) == len(suf) and all(
                c == s or (any_case and c == s.upper()) for c, s in zip(seg, suf)):
            return i + 1 + len(suf)
    return -1


def _contraction_ci(text: str, i: int) -> int:
    """End of the case-insensitive contraction at i ('s 't 're 've 'm 'll 'd,
    the first that matches), or -1."""
    for suf in _CONTRACTIONS:
        seg = text[i + 1:i + 1 + len(suf)]
        if len(seg) == len(suf) and all(c in _CASE_FOLDS.get(s, s + s.upper())
                                        for c, s in zip(seg, suf)):
            return i + 1 + len(suf)
    return -1


def _cased_word(text: str, k: list[str], j: int, upper_first: bool) -> int:
    """End of gpt-4o's first (`upper_first` false: uppers* lowers+) or
    second (uppers+ lowers*) word alternative from j, with its contraction,
    or -1.  The first backs its greedy upper run off to the last character
    a lower run can start on (Lm, Lo and M are both)."""
    n = len(text)
    u = j
    while u < n and k[u] in _UPPERISH:
        u += 1
    if upper_first:
        if u == j:
            return -1
        end = u
        while end < n and k[end] in _LOWERISH:
            end += 1
    else:
        p = u
        while p >= j and not (p < n and k[p] in _LOWERISH):
            p -= 1
        if p < j:
            return -1
        end = p + 1
        if p == u:  # an Ll after the upper run: the lower run goes on
            while end < n and k[end] in _LOWERISH:
                end += 1
    if end < n and text[end] == "'":
        end = max(end, _contraction_ci(text, end))
    return end


def _match_gpt4o(text: str, k: list[str], i: int) -> int:
    n = len(text)
    c = text[i]
    prefix = c not in _CRLF and k[i][0] not in "LN"  # [^\r\n\p{L}\p{N}]
    for upper_first in (False, True):  # the two word alternatives, each prefix first
        for j in ((i + 1, i) if prefix else (i,)):
            end = _cased_word(text, k, j, upper_first) if j < n else -1
            if end > 0:
                return end
    if k[i] == "N":  # \p{N}{1,3}
        return _run(k, i, "N", 3)
    #  ?[^\s\p{L}\p{N}]+[\r\n/]*
    other = ("O", "M")
    j = i + 1 if c == " " and i + 1 < n and k[i + 1] in other else i
    if k[j] in other:
        while j < n and k[j] in other:
            j += 1
        while j < n and text[j] in "\r\n/":
            j += 1
        return j
    if k[i] == "S":  # \s*[\r\n]+ | \s+(?!\S) | \s+, as llama3's
        j = _run(k, i, "S")
        last = max((p for p in range(i, j) if text[p] in _CRLF), default=-1)
        if last >= 0:
            return last + 1
        if j == n or j - 1 == i:
            return j
        return j - 1
    return -1


def _match_gpt2(text: str, k: list[str], i: int) -> int:
    n = len(text)
    if text[i] == "'":
        end = _contraction(text, i, any_case=False)
        if end > 0:
            return end
    lead = 1 if text[i] == " " and i + 1 < n else 0
    for cls in ("L", "N", "O"):  #  ?\p{L}+ |  ?\p{N}+ |  ?[^\s\p{L}\p{N}]+
        j = i + lead if lead and k[i + 1] == cls else i
        if k[j] == cls:
            return _run(k, j, cls)
    if k[i] == "S":  # \s+(?!\S): the last space of a run before \S stays
        j = _run(k, i, "S")
        if j == n:
            return j
        if j - 1 > i:
            return j - 1
    return -1


def _match_llama3(text: str, k: list[str], i: int, max_digits: int | None) -> int:
    n = len(text)
    c = text[i]
    if c == "'":
        end = _contraction(text, i, any_case=True)
        if end > 0:
            return end
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if k[i] == "L":
        return _run(k, i, "L")
    if c not in _CRLF and k[i] != "N" and i + 1 < n and k[i + 1] == "L":
        return _run(k, i + 1, "L")
    if k[i] == "N":  # \p{N}{1,3} (llama3) | \p{N} (qwen2)
        return _run(k, i, "N", max_digits)
    #  ?[^\s\p{L}\p{N}]+[\r\n]*
    j = i + 1 if c == " " and i + 1 < n and k[i + 1] == "O" else i
    if k[j] == "O":
        j = _run(k, j, "O")
        while j < n and text[j] in _CRLF:
            j += 1
        return j
    if k[i] == "S":
        j = _run(k, i, "S")
        # \s*[\r\n]+: up to the run's last line break
        last = max((p for p in range(i, j) if text[p] in _CRLF), default=-1)
        if last >= 0:
            return last + 1
        # \s+(?!\S) | \s+
        if j == n or j - 1 == i:
            return j
        return j - 1
    return -1


def pretokenize(text: str, kind: str) -> list[str]:
    """`text` split as `regex.finditer` splits it with pattern `kind`
    ("gpt2", "llama3" or "qwen2"), the unmatched characters between
    matches kept as fragments; "starcoder": each \\p{N} character a fragment,
    then "gpt2" over every fragment (zllm's two passes)."""
    if kind == "starcoder":
        return [out for frag in _split_numerals(text) for out in pretokenize(frag, "gpt2")]
    k = [(case_class if kind == "gpt-4o" else char_class)(c) for c in text]
    if kind == "gpt2":
        def match(i):
            return _match_gpt2(text, k, i)
    elif kind == "gpt-4o":
        def match(i):
            return _match_gpt4o(text, k, i)
    else:
        digits = 3 if kind == "llama3" else 1

        def match(i):
            return _match_llama3(text, k, i, digits)
    out: list[str] = []
    gap = i = 0
    while i < len(text):
        end = match(i)
        if end < 0:
            i += 1
            continue
        if i > gap:
            out.append(text[gap:i])
        out.append(text[i:end])
        gap = i = end
    if gap < len(text):
        out.append(text[gap:])
    return out


def _split_numerals(text: str) -> list[str]:
    """`text` cut around every \\p{N} character: each one a fragment, the
    runs between them fragments."""
    out, start = [], 0
    for i, c in enumerate(text):
        if char_class(c) == "N":
            if i > start:
                out.append(text[start:i])
            out.append(c)
            start = i + 1
    if start < len(text):
        out.append(text[start:])
    return out


class BpeTokenizer:
    def __init__(self, vocab: Vocab):
        if vocab.pre not in PRETOKENIZERS:
            raise NotImplementedError(
                f"BPE pretokenizer {vocab.pre!r} is not in zllm_torch yet (ROADMAP queue 1 item 8: "
                f"the other BPE pre patterns); ported: {sorted(PRETOKENIZERS)}")
        self.vocab = vocab
        self.kind = PRETOKENIZERS[vocab.pre]
        self.ranks: dict[tuple[str, str], int] = {}
        for rank, line in enumerate(vocab.merges):
            left, _, right = line.partition(" ")
            self.ranks[(left, right)] = rank

    def pretokenize(self, text: str) -> list[str]:
        return pretokenize(text, self.kind)

    def _bpe_word(self, word: str) -> list[str]:
        """Merge the lowest-ranked adjacent pair (the leftmost of equals)
        until no pair has a rank."""
        parts = list(word)
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return parts

    def encode(self, text: str) -> list[int]:
        v = self.vocab
        enc = _byte_encoder()
        out: list[int] = []
        for frag in self.pretokenize(text):
            word = "".join(enc[b] for b in frag.encode("utf-8"))
            for piece in self._bpe_word(word):
                tid = v.token_to_id.get(piece)
                if tid is not None:
                    out.append(tid)
                    continue
                # unmergeable piece: one token a character (a well-formed
                # byte-level vocab holds all 256), else unk
                for ch in piece:
                    cid = v.token_to_id.get(ch)
                    if cid is not None:
                        out.append(cid)
                    elif v.unk_id >= 0:
                        out.append(v.unk_id)
        return out

    def decode_piece(self, tid: int) -> bytes:
        v = self.vocab
        if v.types[tid] == TokenType.CONTROL:
            return b""
        if v.types[tid] == TokenType.USER_DEFINED:
            return v.tokens[tid].encode("utf-8")
        dec = _byte_decoder()
        return bytes(dec[c] for c in v.tokens[tid] if c in dec)
