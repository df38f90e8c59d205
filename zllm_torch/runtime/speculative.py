"""Speculative decoding for one sequence (counterpart of
`zllm/runtime/speculative.py`), on the slot == position KV cache: partial
acceptance needs no rollback, rejected positions are overwritten by the
next write before anything attends them.

  * prompt-lookup (n-gram) speculation: `ngram_propose` proposes the
    continuation of the longest recent n-gram match in the context;
  * draft-model speculation: a small model drafts k tokens greedily, the
    target verifies them in one batched forward.

Both run at batch 1 on the target's device.  There a plain decode step
takes the matvec kernels (K1/K4, int8-rounded activations) while the
verify step, T = 1 + k, takes the GEMMs (K3/K5), as in zllm: greedy output
equals plain greedy decoding exactly where both round alike (f32 weights
on the CPU), and otherwise up to those roundings.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.llama import forward
from .kvcache import KVCache


def ngram_propose(tokens: list[int], n_draft: int = 8, max_ngram: int = 4,
                  min_ngram: int = 2) -> list[int]:
    """Longest-suffix n-gram match: if the last n tokens appeared earlier,
    propose what followed them."""
    toks = tokens
    for n in range(max_ngram, min_ngram - 1, -1):
        if len(toks) < n + 1:
            continue
        tail = toks[-n:]
        # scan right to left, excluding the match with itself
        for i in range(len(toks) - n - 1, -1, -1):
            if toks[i:i + n] == tail:
                cont = toks[i + n:i + n + n_draft]
                if cont:
                    return cont
    return []


class SpeculativeDecoder:
    """Greedy speculative decoding for a single sequence.  `target` and
    `draft` are loaded models on one device; draft=None selects
    prompt-lookup.  The KV caches hold `kv_dtype` (zllm's is bf16)."""

    def __init__(self, target, draft=None, n_draft: int = 8, max_len: int = 2048,
                 kv_dtype=torch.bfloat16):
        self.target = target
        self.draft = draft
        self.n_draft = n_draft
        self.device = target.device
        cfg = target.cfg
        self.kv = KVCache.create(cfg.n_layers, 1, max_len, cfg.n_kv_heads, cfg.head_dim,
                                 kv_dtype, self.device)
        if draft is not None:
            dcfg = draft.cfg
            self.dkv = KVCache.create(dcfg.n_layers, 1, max_len, dcfg.n_kv_heads,
                                      dcfg.head_dim, kv_dtype, self.device)
        self.n_accepted = 0
        self.n_drafted = 0
        self.draft_seen = 0  # history positions correctly fed to the draft

    def _step(self, model, kv, toks: list[int], p0: int) -> np.ndarray:
        """Greedy picks after each of `toks`, fed at positions p0.. ."""
        dev = self.device
        t = torch.tensor([toks], dtype=torch.int32, device=dev)
        pos = torch.arange(p0, p0 + len(toks), dtype=torch.int32, device=dev)[None]
        with torch.inference_mode():
            logits = forward(model.params, model.cfg, t, pos, kv, logits_for="all")
        return torch.argmax(logits[0], dim=-1).cpu().numpy()

    def _drafts(self, history: list[int]) -> list[int]:
        if self.draft is None:
            return ngram_propose(history, self.n_draft)
        # catch the draft model up on tokens it mispredicted or never saw
        nxt = self._step(self.draft, self.dkv, history[self.draft_seen:], self.draft_seen)
        self.draft_seen = len(history)
        out = [int(nxt[-1])]
        p = len(history)
        while len(out) < self.n_draft:
            out.append(int(self._step(self.draft, self.dkv, [out[-1]], p)[-1]))
            p += 1
        # drafted positions hold the draft's own K/V; the next round's
        # catch-up overwrites any of them that verification rejected
        return out

    def generate(self, prompt: list[int], max_new: int = 64, eos_id: int = -1) -> list[int]:
        """Greedy generation; output equals plain greedy decode (see the
        module docstring for where the two round apart)."""
        out = [int(self._step(self.target, self.kv, list(prompt), 0)[-1])]
        history = list(prompt) + out
        p = len(prompt)  # next write position, for token out[-1]
        while len(out) < max_new and out[-1] != eos_id:
            drafts = self._drafts(history)
            self.n_drafted += len(drafts)
            preds = self._step(self.target, self.kv, [out[-1]] + drafts, p)
            accepted = 0
            for i, d in enumerate(drafts):
                if int(preds[i]) != d:
                    break
                accepted += 1
            self.n_accepted += accepted
            for t in drafts[:accepted] + [int(preds[accepted])]:
                out.append(t)
                history.append(t)
                if len(out) >= max_new or t == eos_id:
                    break
            p += accepted + 1
        return out[:max_new]
