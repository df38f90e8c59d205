"""One-shot completion CLI: the main path of `tools/cli.py` on the port.

Loads a GGUF, tokenizes the prompt, generates with a sampler chain, and
prints the text.  Runs on the GPU unless `--device cpu` is given.

Usage:
  python -m zllm_torch.cli MODEL.gguf -p "prompt" -n 64 [--greedy] [--device cpu]
  python -m zllm_torch.cli MODEL.gguf -f PROMPT.txt -r STOP --prompt-cache SESSION.npz

`--prompt-cache FILE` (zllm's rules): when FILE holds a session of this
model, the longest prefix it shares with the prompt is reused if it is at
least 16 tokens (one token is always prefilled); after the run the prompt
and the generated tokens but the last are saved back to FILE.
"""

from __future__ import annotations

import argparse
import os
import sys

MIN_REUSE = 16  # a shorter shared prefix is not worth reusing


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m zllm_torch.cli")
    ap.add_argument("model")
    ap.add_argument("-p", "--prompt", default=None)
    ap.add_argument("-f", "--file", default=None, help="read the prompt from a file")
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-r", "--reverse-prompt", action="append", default=[],
                    help="stop generation at this string (repeatable)")
    ap.add_argument("--prompt-cache", default="", metavar="FILE",
                    help="session file: reuse the cached prompt's KV on a shared prefix and "
                         "save the updated session after generation")
    ap.add_argument("-c", "--ctx", type=int, default=2048)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--min-p", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    prompt = args.prompt
    if prompt is None and args.file:
        with open(args.file, encoding="utf-8") as fh:
            prompt = fh.read()
    if prompt is None:
        raise SystemExit("need -p PROMPT or -f FILE")

    import torch

    from .models.loader import Model
    from .runtime.generate import Generator
    from .sampling.samplers import SamplerChain

    print(f"loading {args.model} ...", file=sys.stderr)
    m = Model.load(args.model, device=args.device, dtype=torch.bfloat16)
    if m.tokenizer is None:
        raise SystemExit("model has no tokenizer")
    gen = Generator(m, max_len=args.ctx, prefill_chunk=min(256, args.ctx))
    chain = SamplerChain(temp=args.temp, top_k_n=args.top_k, top_p_p=args.top_p,
                         min_p_p=args.min_p, greedy=args.greedy)
    rng = torch.Generator(device=m.device)
    rng.manual_seed(args.seed)

    def sample(logits):
        return int(chain.sample(logits, rng))

    ids = m.tokenizer.encode(prompt, add_special=True, parse_special=True)
    start = 0
    if args.prompt_cache and os.path.exists(args.prompt_cache):
        from .runtime.state import load_session

        try:
            # restored in place: a stale tail past the reused prefix is
            # rewritten before any query attends it
            _, cached, n_past = load_session(args.prompt_cache, m, gen.kv)
            limit = min(n_past, len(ids) - 1)
            ncp = 0
            while ncp < limit and cached[ncp] == ids[ncp]:
                ncp += 1
            if ncp >= MIN_REUSE:
                start = ncp
                print(f"[prompt cache: reused {ncp} tokens]", file=sys.stderr)
        except ValueError as e:
            print(f"[prompt cache ignored: {e}]", file=sys.stderr)
    res = gen.generate(ids, max_new=args.n_predict, sampler=sample, eos_id=m.tokenizer.eos_id,
                       start=start, stop_strings=tuple(args.reverse_prompt))
    if args.prompt_cache:
        from .runtime.state import save_session

        hist = ids + res.tokens[:-1]
        save_session(args.prompt_cache, m, gen.kv, hist, len(hist))
    print(res.text)
    pp_tps = res.n_prefill / res.t_prefill if res.t_prefill else 0
    tg_tps = (len(res.tokens) - 1) / res.t_decode if res.t_decode else 0
    print(f"[{m.device}: prefill {res.n_prefill} tok @ {pp_tps:.1f} t/s | "
          f"decode {len(res.tokens)} tok @ {tg_tps:.1f} t/s]", file=sys.stderr)


if __name__ == "__main__":
    main()
