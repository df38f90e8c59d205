"""One-shot completion CLI: the main path of `tools/cli.py` on the port.

Loads a GGUF, tokenizes the prompt, generates with a sampler chain, and
prints the text.  Runs on the GPU unless `--device cpu` is given.

Usage:
  python -m zllm_torch.cli MODEL.gguf -p "prompt" -n 64 [--greedy] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m zllm_torch.cli")
    ap.add_argument("model")
    ap.add_argument("-p", "--prompt", required=True)
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-c", "--ctx", type=int, default=2048)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--min-p", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

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

    ids = m.tokenizer.encode(args.prompt, add_special=True, parse_special=True)
    res = gen.generate(ids, max_new=args.n_predict, sampler=sample, eos_id=m.tokenizer.eos_id)
    print(res.text)
    pp_tps = res.n_prefill / res.t_prefill if res.t_prefill else 0
    tg_tps = (len(res.tokens) - 1) / res.t_decode if res.t_decode else 0
    print(f"[{m.device}: prefill {res.n_prefill} tok @ {pp_tps:.1f} t/s | "
          f"decode {len(res.tokens)} tok @ {tg_tps:.1f} t/s]", file=sys.stderr)


if __name__ == "__main__":
    main()
