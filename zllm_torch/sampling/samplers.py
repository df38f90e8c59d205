"""Sampler chain on tensors (counterpart of `zllm/sampling/samplers.py`):
top-k -> top-p -> min-p -> temperature -> draw, or greedy argmax.  Each
transform maps logits to logits; the draw takes an explicit
`torch.Generator`, so a seed fixes the stream on its device."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

NEG_INF = -1e30


def temperature(logits: torch.Tensor, temp: float) -> torch.Tensor:
    if temp <= 0:
        # greedy semantics: keep only the max
        mx = logits.amax(dim=-1, keepdim=True)
        return torch.where(logits == mx, logits, torch.full_like(logits, NEG_INF))
    return logits / temp


def top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus: keep the smallest set with cumulative prob >= p."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens while the cumulative mass *before* them is < p
    n_keep = torch.sum(cum - probs < p, dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1, torch.clamp_min(n_keep - 1, 0))
    return torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)


def min_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Drop tokens below p * max prob."""
    if p <= 0:
        return logits
    mx = logits.amax(dim=-1, keepdim=True)
    return torch.where(logits < mx + math.log(p), torch.full_like(logits, NEG_INF), logits)


@dataclass
class SamplerChain:
    """Ordered chain with llama.cpp-compatible defaults:
    top_k -> top_p -> min_p -> temp -> dist."""

    temp: float = 0.8
    top_k_n: int = 40
    top_p_p: float = 0.95
    min_p_p: float = 0.05
    greedy: bool = False

    def apply_logits(self, logits: torch.Tensor) -> torch.Tensor:
        lg = logits.float()
        if self.top_k_n > 0:
            lg = top_k(lg, self.top_k_n)
        if self.top_p_p < 1.0:
            lg = top_p(lg, self.top_p_p)
        if self.min_p_p > 0:
            lg = min_p(lg, self.min_p_p)
        return temperature(lg, self.temp)

    def sample(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """logits [..., V] -> token ids [...]."""
        if self.greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(self.apply_logits(logits), dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        ids = torch.multinomial(flat, 1, generator=generator)
        return ids.reshape(probs.shape[:-1])
