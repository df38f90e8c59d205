"""Decode loop: chunked prefill + single-token steps (counterpart of
`zllm/runtime/generate.py::Generator`).  PyTorch runs eagerly, so the
steps are plain calls of `forward`; the KV cache is updated in place."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.llama import forward
from .kvcache import KVCache


@dataclass
class GenerateResult:
    tokens: list[int]
    text: str = ""
    n_prefill: int = 0
    t_prefill: float = 0.0
    t_decode: float = 0.0


class Generator:
    """Runs one model's prefill and decode steps (batch 1) on the model's
    device."""

    def __init__(self, model, max_len: int = 2048, prefill_chunk: int = 256,
                 kv_dtype=torch.bfloat16):
        if prefill_chunk > max_len:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} exceeds max_len={max_len}: a padded chunk "
                "must fit in the KV cache")
        self.model = model
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.kv_dtype = kv_dtype
        self.device = model.device
        self.t_prefill = 0.0
        self._cur_pos = 0
        self.reset()

    def reset(self):
        cfg = self.model.cfg
        self.kv = KVCache.create(cfg.n_layers, 1, self.max_len, cfg.n_kv_heads,
                                 cfg.head_dim, self.kv_dtype, self.device)

    def _step(self, tokens: np.ndarray, positions: np.ndarray, logits_for: str) -> torch.Tensor:
        """Run tokens [T] at positions [T] (int32, consecutive)."""
        tok = torch.from_numpy(tokens[None]).to(self.device)
        pos = torch.from_numpy(positions[None]).to(self.device)
        with torch.inference_mode():
            return forward(self.model.params, self.model.cfg, tok, pos, self.kv,
                           start=int(positions[0]), logits_for=logits_for)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, prompt_tokens: list[int]) -> torch.Tensor:
        """Feed the prompt in fixed-size chunks; returns last-token logits.
        Each chunk is padded to `prefill_chunk` tokens; padded positions run
        past the prompt and clamp to max_len - 1 (their cache writes land
        beyond the causal horizon of real queries)."""
        toks = np.asarray(prompt_tokens, dtype=np.int32)
        n = len(toks)
        logits = None
        t0 = time.perf_counter()
        pos = 0
        while pos < n:
            chunk = min(self.prefill_chunk, n - pos)
            padded = np.zeros(self.prefill_chunk, dtype=np.int32)
            padded[:chunk] = toks[pos:pos + chunk]
            positions = np.arange(pos, pos + self.prefill_chunk, dtype=np.int32)
            positions = np.minimum(positions, self.max_len - 1)
            logits = self._step(padded, positions, "all")[0, chunk - 1]
            pos += chunk
        self._sync()
        self.t_prefill = time.perf_counter() - t0
        self._cur_pos = n
        return logits

    def _decode_one(self, token: int, pos: int) -> torch.Tensor:
        return self._step(np.array([token], dtype=np.int32), np.array([pos], dtype=np.int32),
                          "last")[0, -1]

    def decode_steps(self, first_token: int, n_steps: int, sampler=None) -> list[int]:
        """Greedy (or sampler-driven) decode; returns generated tokens."""
        out = [int(first_token)]
        pos = self._cur_pos
        for _ in range(n_steps):
            row = self._decode_one(out[-1], pos)
            out.append(int(torch.argmax(row)) if sampler is None else int(sampler(row)))
            pos += 1
        self._cur_pos = pos
        return out

    def generate(self, prompt_tokens: list[int], max_new: int = 32, sampler=None,
                 eos_id: int = -1) -> GenerateResult:
        logits = self.prefill(prompt_tokens)
        first = int(torch.argmax(logits)) if sampler is None else int(sampler(logits))
        t0 = time.perf_counter()
        toks = [first]
        pos = self._cur_pos
        for _ in range(max_new - 1):
            if toks[-1] == eos_id:
                break
            row = self._decode_one(toks[-1], pos)
            toks.append(int(torch.argmax(row)) if sampler is None else int(sampler(row)))
            pos += 1
        self._sync()
        t_decode = time.perf_counter() - t0
        self._cur_pos = len(prompt_tokens) + len(toks) - 1
        text = self.model.tokenizer.decode(toks) if self.model.tokenizer else ""
        return GenerateResult(tokens=toks, text=text, n_prefill=len(prompt_tokens),
                              t_prefill=self.t_prefill, t_decode=t_decode)
