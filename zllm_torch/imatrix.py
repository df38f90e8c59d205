"""Importance-matrix collection: the counterpart of `tools/imatrix.py`.

The analogue of llama-imatrix (reference: tools/imatrix/imatrix.cpp
collect_imatrix via the eval callback): runs a calibration corpus through
the model in chunks of `--ctx` tokens, `--batch` chunks a forward (with no
KV cache: each matmul a GEMM at M = batch x ctx, K6 for the attention),
and sums each matmul input's squares per input column on the device
(`forward(..., taps=)`).  The sums come to the host once, at the end.

The file is zllm's (and llama-imatrix's GGUF form): "<tensor>.in_sum2"
f32[K] and "<tensor>.counts" f32[1] a tapped tensor, with general.type
"imatrix", imatrix.datasets, imatrix.chunk_size and general.base_model;
`python -m zllm_torch.quantize --imatrix` and zllm's `tools/quantize.py
--imatrix` read it as sum / count.

Unlike zllm, a last partial batch runs with its real chunks alone (zllm
pads it with all-zero token rows and counts them), and a corpus shorter
than one context raises.

Usage: python -m zllm_torch.imatrix MODEL.gguf corpus.txt OUT.imatrix.gguf
           [--ctx 512] [--batch 2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .gguf.reader import read_gguf
from .gguf.writer import GGUFWriter


def collect_imatrix(model, token_ids, n_ctx: int = 512, batch: int = 2,
                    progress: bool = False) -> tuple[dict[str, np.ndarray], dict[str, float]]:
    """Sum of squares a tapped tensor's input column over the corpus's
    whole chunks of n_ctx tokens, `batch` chunks a forward (the last
    forward takes the chunks left).  Returns ({name: f32[K]}, {name:
    tokens counted})."""
    from .models.llama import forward

    ids = np.asarray(token_ids, dtype=np.int64)
    n_chunks = len(ids) // n_ctx
    if n_chunks == 0:
        raise ValueError(f"the corpus has {len(ids)} tokens, fewer than one context of {n_ctx}")
    dev = model.device
    chunks = torch.as_tensor(ids[:n_chunks * n_ctx].reshape(n_chunks, n_ctx),
                             dtype=torch.int32, device=dev)
    sums: dict[str, torch.Tensor] = {}
    counts: dict[str, float] = {}
    with torch.inference_mode():
        for start in range(0, n_chunks, batch):
            toks = chunks[start:start + batch]
            nb = toks.shape[0]
            positions = torch.arange(n_ctx, dtype=torch.int32, device=dev).expand(nb, n_ctx)
            taps: dict = {}
            forward(model.params, model.cfg, toks, positions, None, taps=taps)
            for name, v in taps.items():
                s = torch.sum(v.float() ** 2, dim=(0, 1))
                if name in sums:
                    sums[name] += s
                else:
                    sums[name] = s
                counts[name] = counts.get(name, 0.0) + nb * n_ctx
            if progress:
                print(f"[{start + nb}/{n_chunks}] chunks", file=sys.stderr)
    return {k: v.cpu().numpy() for k, v in sums.items()}, counts


def write_imatrix(path: str, model_path: str, sums: dict, counts: dict, n_ctx: int = 512):
    w = GGUFWriter(path)
    w.add("general.type", "imatrix")
    w.add("imatrix.datasets", ["zllm"])
    w.add("imatrix.chunk_size", n_ctx)
    w.add("general.base_model", model_path)
    for name, s in sums.items():
        w.add_tensor(name + ".in_sum2", np.asarray(s, np.float32))
        w.add_tensor(name + ".counts", np.asarray([counts[name]], np.float32))
    w.write()


def read_imatrix(path: str) -> dict[str, np.ndarray]:
    """-> {tensor name: mean-square weights f32[K]} (sum / count)."""
    out = {}
    with read_gguf(path) as f:
        for name in f.tensors:
            if name.endswith(".in_sum2"):
                base = name[: -len(".in_sum2")]
                s = f.tensor_f32(name)
                cnt = f.tensor_f32(base + ".counts")[0] if base + ".counts" in f.tensors else 1.0
                out[base] = s / max(cnt, 1.0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model")
    ap.add_argument("corpus")
    ap.add_argument("output")
    ap.add_argument("--ctx", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from .models.loader import Model

    m = Model.load(args.model, device=args.device, dtype=torch.bfloat16)
    if m.tokenizer is None:
        sys.exit(f"{args.model} has no tokenizer")
    with open(args.corpus, encoding="utf-8") as fh:
        ids = m.tokenizer.encode(fh.read(), add_special=True)
    sums, counts = collect_imatrix(m, ids, n_ctx=args.ctx, batch=args.batch, progress=True)
    write_imatrix(args.output, args.model, sums, counts, n_ctx=args.ctx)
    print(f"wrote {len(sums)} tensors to {args.output}")


if __name__ == "__main__":
    main()
