"""OpenAI-compatible continuous-batching server (counterpart of
`tools/server.py`).

Usage: python -m zllm_torch.server MODEL.gguf [--host 127.0.0.1 --port 8080
       --slots 4 --ctx 2048 --kv-type bf16 --kv-layout auto --jinja
       --spec --draft-max 6 --model-draft DRAFT.gguf --lookahead --device cuda]
       python -m zllm_torch.server --models-dir DIR [--models-max 2
       --replicas 1 --slots 4 --ctx 2048 --device cuda]   (router mode)

Runs on the GPU unless --device cpu is given.  `--kv-type f16` serves from
an f16 KV cache (llama.cpp's default -ctk/-ctv f16; paged by default, or
contiguous), `--kv-type q8` from the int8 KV cache (llama.cpp's -ctk/-ctv
q8_0), which takes the contiguous layout.  Without a model and with
--models-dir it runs the router (`server/router.py`): every GGUF in the
directory, loaded on demand, at most --models-max at once, --replicas
engines a model.  `--spec` speculates for greedy requests with n-gram
prompt lookup, `--model-draft` with a draft model loaded on the same
device (`--draft-max` tokens a step), `--lookahead` decodes them by
Jacobi lookahead; each picks the contiguous layout under "auto".  The
four fall back to zllm's environment variables ZLLM_ARG_SPEC=1,
ZLLM_ARG_DRAFT_MAX, ZLLM_ARG_MODEL_DRAFT and ZLLM_ARG_LOOKAHEAD=1.  It
offers only what the port serves: no multi-device serving or media.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

# --kv-type -> the engine's kv_dtype (zllm's tools/server.py maps the same)
KV_TYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32, "q8": "q8"}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m zllm_torch.server")
    ap.add_argument("model", nargs="?", default="",
                    help="GGUF file (llama, Qwen2/3, OLMo-2; omit with --models-dir)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--slots", type=int, default=4, help="concurrent sequences")
    ap.add_argument("--ctx", type=int, default=2048,
                    help="context per slot (paged: rounded up to 128)")
    ap.add_argument("--kv-type", default="bf16", choices=list(KV_TYPES),
                    help="KV cache element type (f16 = llama.cpp's default -ctk/-ctv f16; q8 = "
                         "int8-quantized cache, llama.cpp's -ctk/-ctv q8_0)")
    ap.add_argument("--kv-layout", default="auto", choices=["auto", "paged", "contiguous"],
                    help="KV cache layout: paged = shared page pool + cross-slot prefix "
                         "sharing (auto: paged; contiguous for q8, speculation and lookahead)")
    ap.add_argument("--jinja", action="store_true",
                    help="render the GGUF's embedded jinja chat template")
    env = os.environ
    ap.add_argument("--spec", action="store_true", default=env.get("ZLLM_ARG_SPEC", "") == "1",
                    help="n-gram speculative decoding for greedy requests [ZLLM_ARG_SPEC=1]")
    ap.add_argument("--draft-max", type=int, default=int(env.get("ZLLM_ARG_DRAFT_MAX", 6)),
                    help="draft tokens per step [ZLLM_ARG_DRAFT_MAX]")
    ap.add_argument("--model-draft", default=env.get("ZLLM_ARG_MODEL_DRAFT", ""),
                    help="draft model GGUF for speculative decoding [ZLLM_ARG_MODEL_DRAFT]")
    ap.add_argument("--lookahead", action="store_true",
                    default=env.get("ZLLM_ARG_LOOKAHEAD", "") == "1",
                    help="Jacobi lookahead decoding for greedy requests "
                         "[ZLLM_ARG_LOOKAHEAD=1]")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cpu: the kernels' plain versions)")
    ap.add_argument("--models-dir", default="",
                    help="router mode: serve every GGUF in this directory")
    ap.add_argument("--models-max", type=int, default=2,
                    help="router mode: models loaded at once (least recently used evicted)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="router mode: engines a model, round robin")
    args = ap.parse_args(argv)

    if not args.model and args.models_dir:
        from .router import RouterServer

        r = RouterServer(args.models_dir, host=args.host, port=args.port,
                         models_max=args.models_max, n_slots=args.slots, max_len=args.ctx,
                         replicas=args.replicas, device=args.device)
        print(f"router on http://{args.host}:{args.port} serving {r.available()}",
              file=sys.stderr)
        try:
            r.serve_forever()
        except KeyboardInterrupt:
            r.shutdown()
        return
    if not args.model:
        ap.error("MODEL.gguf or --models-dir required")

    from ..models.loader import Model
    from .http import ZllmServer

    print(f"loading {args.model} ...", file=sys.stderr)
    m = Model.load(args.model, device=args.device, dtype=torch.bfloat16)
    if m.tokenizer is None:
        ap.error(f"{args.model} has no tokenizer")
    draft = None
    if args.model_draft:
        print(f"loading draft {args.model_draft} ...", file=sys.stderr)
        draft = Model.load(args.model_draft, device=args.device, dtype=torch.bfloat16)
    srv = ZllmServer(m, n_slots=args.slots, max_len=args.ctx, host=args.host, port=args.port,
                     speculative=args.spec, n_draft=args.draft_max, kv_layout=args.kv_layout,
                     draft_model=draft, jinja=args.jinja, kv_dtype=KV_TYPES[args.kv_type],
                     lookahead=args.lookahead)
    print(f"listening on http://{args.host}:{args.port}", file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == "__main__":
    main()
