"""Lookahead decoding: Jacobi n-gram speculation without a draft model
(counterpart of zllm's `tools/lookahead.py`).

Every step runs ONE forward over a composite batch

  [ pending tokens | W x (N-1) Jacobi window columns | G x (N-1)
    verification n-grams ]

with an explicit block attention mask (`models/llama.forward`'s `mask`):
window column i at level j attends the committed prefix and its own
column at lower levels; a verification gram attends the prefix and its
own earlier tokens.  Trajectory n-grams harvested from the window feed a
per-first-token pool (G grams a key, deduplicated); grams whose key is the
last token ride along for verification, and the longest chain whose tokens
match the greedy argmax at each position is accepted.  Speculative tokens
are stored in cache slots past the committed region (`kv_positions`) and
overwritten by the next step.  The masked attention is the plain
`attention_ref`, as zllm's is XLA's: accepted output equals plain greedy
decoding up to that rounding (exactly on the CPU with f32 weights).

Usage: python -m zllm_torch.lookahead MODEL.gguf [-p PROMPT -n 64 -W 8 -N 4
       -G 8 --device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .models.llama import forward
from .runtime.kvcache import KVCache


def lookahead_generate(model, prompt_tokens, n_new: int, w: int = 8, n: int = 4, g: int = 8,
                       max_len: int = 1024):
    """Greedy lookahead decoding on the model's device over an f32 KV
    cache.  Returns (tokens, stats), stats with the step count and the
    tokens accepted from grams."""
    cfg = model.cfg
    dev = model.device
    lvls = n - 1
    t_batch = n + w * lvls + g * lvls  # pending (padded to N) + window + verify
    kv = KVCache.create(cfg.n_layers, 1, max_len, cfg.n_kv_heads, cfg.head_dim,
                        torch.float32, dev)

    def run(toks, pos, logits_for="all", **kw):
        with torch.inference_mode():
            return forward(model.params, cfg, torch.from_numpy(toks[None]).to(dev),
                           torch.from_numpy(pos[None]).to(dev), kv, logits_for=logits_for,
                           **kw)

    def prefill(toks: list[int], p0: int):
        return run(np.asarray(toks, np.int32), np.arange(p0, p0 + len(toks), dtype=np.int32),
                   "last")

    prompt = list(prompt_tokens)
    out = [int(torch.argmax(prefill(prompt, 0)[0, -1]))]

    rng = np.random.default_rng(0)
    # Jacobi window levels [N-1, W], random-initialized like the reference
    window = rng.integers(1, cfg.vocab_size, size=(lvls, w)).astype(np.int64)
    pool: dict[int, list[tuple]] = {}

    pending = [out[-1]]  # committed tokens whose K/V is not yet ingested
    accepted_total = 0
    steps = 0
    while len(out) < n_new:
        m = len(pending)
        p0 = len(prompt) + len(out) - m  # position of pending[0]
        base = p0 + m  # first speculative storage slot
        if base + (n - m) + (t_batch - n) >= max_len:
            break
        toks = np.zeros(t_batch, np.int32)
        pos = np.zeros(t_batch, np.int32)
        slots = np.zeros(t_batch, np.int32)
        mask = np.zeros((1, t_batch, max_len), bool)

        # pending block (padded to N columns; pads attend only themselves)
        for j in range(n):
            if j < m:
                toks[j] = pending[j]
                pos[j] = slots[j] = p0 + j
                mask[0, j, :p0 + j + 1] = True
            else:
                pos[j] = slots[j] = base + (j - m)
                mask[0, j, slots[j]] = True
        col_w0 = n
        # Jacobi window: level j column i attends the prefix + its column below
        for j in range(lvls):
            for i in range(w):
                c = col_w0 + j * w + i
                toks[c] = window[j, i]
                pos[c] = base + i + j
                slots[c] = base + (n - m) + (c - n)  # after the pending pads
                mask[0, c, :base] = True
                for j2 in range(j):
                    mask[0, c, slots[col_w0 + j2 * w + i]] = True
                mask[0, c, slots[c]] = True
        # verification grams for the current last token
        col_v0 = col_w0 + lvls * w
        cands = list(pool.get(pending[-1], []))[:g]
        for gi in range(g):
            gram = cands[gi] if gi < len(cands) else (0,) * lvls
            for t in range(lvls):
                c = col_v0 + gi * lvls + t
                toks[c] = gram[t]
                pos[c] = base + t
                slots[c] = base + (n - m) + (c - n)
                mask[0, c, :base] = True
                for t2 in range(t):
                    mask[0, c, slots[col_v0 + gi * lvls + t2]] = True
                mask[0, c, slots[c]] = True

        logits = run(toks, pos, mask=torch.from_numpy(mask).to(dev),
                     kv_positions=torch.from_numpy(slots[None]).to(dev))
        arg = torch.argmax(logits[0], dim=-1).cpu().numpy()

        x_next = int(arg[m - 1])  # greedy continuation of the last pending
        accepted = [x_next]
        best, best_out = 0, []  # the longest verified gram chain
        for gi, gram in enumerate(cands):
            cur, outs = x_next, []
            for t in range(lvls):
                if gram[t] != cur:
                    break
                cur = int(arg[col_v0 + gi * lvls + t])
                outs.append(cur)
            if len(outs) > best:
                best, best_out = len(outs), outs
        accepted += best_out
        accepted_total += best
        steps += 1

        # harvest trajectory n-grams: key = the old level-0 token of column
        # i, gram = levels 1..N-2 + the freshly computed last level
        new_last = arg[col_w0 + (lvls - 1) * w:col_w0 + lvls * w]
        for i in range(w):
            gram = tuple(int(window[j, i]) for j in range(1, lvls)) + (int(new_last[i]),)
            lst = pool.setdefault(int(window[0, i]), [])
            if gram not in lst:
                lst.insert(0, gram)
                del lst[g:]
        # Jacobi shift: levels move down, the last level is the new one
        window[:-1] = window[1:]
        window[-1] = new_last

        out.extend(accepted)
        pending = accepted[:n]  # the next step ingests these (at most a block)
        if len(accepted) > n:  # a longer acceptance: ingest the tail by a prefill
            extra = accepted[n:]
            prefill(extra, len(prompt) + len(out) - len(extra))
    stats = {"steps": steps, "tokens": len(out), "accepted_from_grams": accepted_total,
             "tokens_per_step": len(out) / max(steps, 1)}
    return out[:n_new], stats


def main(argv=None):
    from .models.loader import Model

    ap = argparse.ArgumentParser(prog="python -m zllm_torch.lookahead",
                                 description="lookahead decoding (reference examples/lookahead)")
    ap.add_argument("model")
    ap.add_argument("-p", "--prompt", default="Hello")
    ap.add_argument("-n", type=int, default=64)
    ap.add_argument("-W", type=int, default=8, help="lookahead window")
    ap.add_argument("-N", type=int, default=4, help="n-gram size")
    ap.add_argument("-G", type=int, default=8, help="verification grams")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)

    m = Model.load(args.model, device=args.device, dtype=torch.bfloat16)
    if m.tokenizer is None:
        ap.error("model has no tokenizer")
    out, stats = lookahead_generate(m, m.tokenizer.encode(args.prompt), args.n, w=args.W,
                                    n=args.N, g=args.G)
    print(m.tokenizer.decode(out))
    print(f"\n{stats}", file=sys.stderr)


if __name__ == "__main__":
    main()
