"""The serving engine on the Qwen slice: the port's `Engine` against zllm's
on the 2-layer qwen2 (G 6, head_dim 128, q/k/v biases) and qwen3 (per-head
q/k norms) F32 files of `test_torch_qwen.py`, in the paged, contiguous f32
and q8 layouts.  Traffic: a chatml chat prompt with non-ASCII text (both
packages' chat formatting and tokenizers give the same ids) stopping on
the file's eos, <|im_end|>; two random prompts, one across the first
128-token page; then a re-send sharing 130 tokens and the chat prompt
again with one of its generated tokens as a stop token.  Tokens, texts
decoded through each package's `IncrementalDecoder`, finish reasons,
reused prompt tokens and step counters must be equal."""

import time

import numpy as np
import pytest
import torch
from test_torch_qwen import make_file

from zllm.gguf.constants import GGMLType

COUNTERS = ("tokens_generated_total", "tokens_prefilled_total", "tokens_prefix_reused_total",
            "decode_steps_total", "prefill_steps_total", "context_shifts_total",
            "pages_cow_unshared_total", "engine_errors_total")
MESSAGES = [{"role": "user", "content": "Grüße aus 東京 — ¿qué tal? 😀 Çà và"}]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    folder = tmp_path_factory.mktemp("qwen_engine")
    return {name: make_file(folder / f"{name}.gguf", name, GGMLType.F32)
            for name in ("qwen2", "qwen3")}


def _run(engine, make_request, chat_ids, decoder):
    r = np.random.default_rng(3)

    def toks(n):
        return [int(x) for x in r.integers(3, 3200, size=n)]

    long = toks(140)  # crosses the first 128-token page
    stop = frozenset({engine.model.tokenizer.eos_id})
    waves = [[dict(prompt_tokens=chat_ids, max_new=8, stop_tokens=stop),
              dict(prompt_tokens=long, max_new=8), dict(prompt_tokens=toks(37), max_new=8)],
             [dict(prompt_tokens=long[:130] + [7], max_new=6)]]
    before = dict(engine.metrics)
    got = []
    for wave in waves + [None]:
        if wave is None:  # the chat prompt again, stopping on its third token
            wave = [dict(prompt_tokens=chat_ids, max_new=8, stop_tokens=stop | {got[0][0][2]})]
        # submitted from the engine thread between two steps, so both
        # engines admit a wave at the same step
        reqs = engine.run_in_loop(lambda wave=wave: [engine.submit(make_request(**kw))
                                                     for kw in wave])
        deadline = time.time() + 120
        while not all(q.done for q in reqs):
            assert time.time() < deadline, "engine timed out"
            time.sleep(0.005)
        for q in reqs:
            dec = decoder()
            text = "".join(dec.push(t) for t in q.out_tokens) + dec.flush()
            got.append((list(q.out_tokens), text, q.finish_reason, q.n_prompt_reused, q.error))
    return got, {k: engine.metrics[k] - before[k] for k in COUNTERS}


@pytest.mark.parametrize("name", ["qwen2", "qwen3"])
@pytest.mark.parametrize("layout", ["paged", "contiguous", "q8"])
def test_engine_matches_zllm(files, name, layout):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.server import chat as zchat
    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm.tokenizer import IncrementalDecoder as ZDecoder
    from zllm_torch.models.loader import Model
    from zllm_torch.server import chat
    from zllm_torch.server.engine import Engine, Request
    from zllm_torch.tokenizer import IncrementalDecoder

    path = files[name]
    zm, tm = ZModel.load(path, dtype=jnp.float32), Model.load(path, device="cpu",
                                                               dtype=torch.float32)
    assert chat.detect_format(tm) == zchat.detect_format(zm) == "chatml"
    text = chat.apply_chat_template(tm, MESSAGES)
    assert text == zchat.apply_chat_template(zm, MESSAGES) and "<|im_start|>" in text
    chat_ids = tm.tokenizer.encode(text, add_special=True, parse_special=True)
    assert chat_ids == zm.tokenizer.encode(text, add_special=True, parse_special=True)
    assert tm.tokenizer.vocab.tokens[tm.tokenizer.eos_id] == "<|im_end|>"
    zkw, tkw = {"paged": (dict(kv_dtype=jnp.float32), dict(kv_dtype=torch.float32)),
                "contiguous": (dict(kv_layout="contiguous", kv_dtype=jnp.float32),
                               dict(kv_layout="contiguous", kv_dtype=torch.float32)),
                "q8": (dict(kv_dtype="q8"), dict(kv_dtype="q8"))}[layout]
    out = {}
    for side, engine, make_request, decoder in (
            ("zllm", ZEngine(zm, n_slots=2, max_len=256, prefill_chunk=16, **zkw),
             lambda **kw: ZRequest(temp=0.0, **kw), lambda: ZDecoder(zm.tokenizer)),
            ("port", Engine(tm, n_slots=2, max_len=256, prefill_chunk=16, **tkw),
             lambda **kw: Request(temp=0.0, **kw), lambda: IncrementalDecoder(tm.tokenizer))):
        if side == "port":
            assert engine.paged == (layout == "paged")
        engine.start()
        try:
            out[side] = _run(engine, make_request, chat_ids, decoder)
        finally:
            engine.stop()
    (tgot, tcount), (zgot, zcount) = out["port"], out["zllm"]
    assert all(err == "" for *_, err in tgot), tgot
    assert tgot == zgot and tcount == zcount
    assert tcount["decode_steps_total"] > 0 and tcount["prefill_steps_total"] > 0
    assert tgot[3][3] >= 128  # the re-send reuses the long prompt's prefix
    # the chat prompt again stops where its third token first comes
    assert tgot[4][2] == "stop" and len(tgot[4][0]) == tgot[0][0].index(tgot[0][0][2]) + 1
    assert tgot[4][0] == tgot[0][0][:len(tgot[4][0])]
