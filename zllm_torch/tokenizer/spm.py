"""SentencePiece-style tokenizer (the "llama" GGUF tokenizer model).

Greedy highest-score bigram merging over UTF-8 codepoints with byte
fallback — behaviorally equivalent to the reference's SPM tokenizer
(reference: src/llama-vocab.cpp llm_tokenizer_spm), implemented with a
heap over (score, position) and a doubly-linked symbol list.
"""

from __future__ import annotations

import heapq

from .vocab import TokenType, Vocab

SPIECE_SPACE = "▁"  # ▁


class SpmTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    def encode(self, text: str) -> list[int]:
        v = self.vocab
        if not text:
            return []
        if v.add_space_prefix:
            text = " " + text
        text = text.replace(" ", SPIECE_SPACE)

        chars = list(text)
        n = len(chars)
        # doubly-linked list over symbol slots; each slot holds a substring
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1 if n else 0
        text_of = chars[:]
        alive = [True] * n

        heap: list[tuple[float, int]] = []

        def push_bigram(left: int):
            right = nxt[left]
            if left < 0 or right < 0:
                return
            merged = text_of[left] + text_of[right]
            tid = v.token_to_id.get(merged)
            if tid is not None and v.types[tid] == TokenType.NORMAL:
                # max-score first; ties resolved to the leftmost position
                heapq.heappush(heap, (-v.scores[tid], left, len(text_of[left]), len(text_of[right])))

        for i in range(n - 1):
            push_bigram(i)

        while heap:
            _, left, llen, rlen = heapq.heappop(heap)
            right = nxt[left] if left >= 0 else -1
            # stale entries: either symbol was already merged away
            if left < 0 or right < 0 or not alive[left] or not alive[right]:
                continue
            if len(text_of[left]) != llen or len(text_of[right]) != rlen:
                continue
            text_of[left] = text_of[left] + text_of[right]
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            if prev[left] >= 0:
                push_bigram(prev[left])
            push_bigram(left)

        out: list[int] = []
        i = 0
        while i != -1 and n:
            if alive[i]:
                self._emit(text_of[i], out)
            i = nxt[i]
        return out

    def _emit(self, piece: str, out: list[int]):
        v = self.vocab
        tid = v.token_to_id.get(piece)
        if tid is not None:
            out.append(tid)
            return
        # byte fallback, one token per UTF-8 byte
        data = piece.encode("utf-8")
        for b in data:
            bid = v.byte_tokens.get(b)
            if bid is not None:
                out.append(bid)
            elif v.unk_id >= 0:
                out.append(v.unk_id)

    def decode_piece(self, tid: int) -> bytes:
        v = self.vocab
        t = v.tokens[tid]
        if v.types[tid] == TokenType.BYTE:
            return bytes([int(t[3:5], 16)])
        if v.types[tid] == TokenType.CONTROL:
            return b""
        return t.replace(SPIECE_SPACE, " ").encode("utf-8")
