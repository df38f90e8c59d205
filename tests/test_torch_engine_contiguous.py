"""The port's engine in the contiguous layout, with an f32 cache and with
the q8 cache, against zllm's, on the CPU.

Both engines serve one F32 llama file (SMALL_LLAMA's geometry, byte-level
vocab) with f32 weights, two slots, 16-token chunks and greedy requests:
`kv_layout="contiguous"` with an f32 KV cache, and `kv_dtype="q8"` (whose
"auto" layout is the contiguous one).  The cases are those of
tests/test_engine_q8.py (one prompt; a context shift at max_len 48), two
concurrent prompts and a same-slot prefix reuse; every case holds the
port to zllm's out_tokens, finish_reason, n_prompt_reused and counter
deltas, exactly.  On the CPU zllm's attention is its reference (after
dequantizing a q8 cache), the port's the plain versions of K2/K6 (f32) or
K7 (q8, scales on the scores and probabilities): the logits agree to f32
rounding, far below the gaps between the random model's top logits."""

import time

import numpy as np
import pytest
import torch
from test_torch_oracle import SMALL_LLAMA

from zllm.gguf.constants import GGMLType

COUNTERS = ("tokens_generated_total", "tokens_prefilled_total", "tokens_prefix_reused_total",
            "decode_steps_total", "prefill_steps_total", "context_shifts_total",
            "pages_cow_unshared_total", "engine_errors_total")
LAYOUTS = ("contiguous_f32", "q8")
CASES = {"one_prompt": 128, "two_prompts": 128, "prefix_reuse": 128, "context_shift": 48}


def _toks(r, n):
    return [int(x) for x in r.integers(3, 500, size=n)]


def _script(engine, make_request, max_len):
    """Run the cases of one max_len in order on one started engine; returns
    {case: ([(out_tokens, finish_reason, n_prompt_reused, error)], counter
    deltas)}."""
    r = np.random.default_rng(max_len)
    out = {}

    def run(case, waves):
        before = dict(engine.metrics)
        got = []
        for wave in waves:
            # a wave is submitted from the engine thread between two steps,
            # so it is admitted at one step on both sides
            reqs = engine.run_in_loop(lambda: [engine.submit(make_request(**kw)) for kw in wave])
            deadline = time.time() + 120
            while not all(q.done for q in reqs):
                assert time.time() < deadline, "engine timed out"
                time.sleep(0.005)
            got += [(list(q.out_tokens), q.finish_reason, q.n_prompt_reused, q.error)
                    for q in reqs]
        out[case] = (got, {k: engine.metrics[k] - before[k] for k in COUNTERS})

    if max_len == 48:
        run("context_shift", [[dict(prompt_tokens=_toks(r, 30), max_new=30)]])
        return out
    run("one_prompt", [[dict(prompt_tokens=_toks(r, 21), max_new=10)]])
    run("two_prompts", [[dict(prompt_tokens=_toks(r, n), max_new=8) for n in (37, 5)]])
    prompt = _toks(r, 40)
    run("prefix_reuse", [[dict(prompt_tokens=prompt, max_new=4)],
                         [dict(prompt_tokens=prompt[:30] + [7, 9], max_new=4)]])
    return out


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    path = str(tmp_path_factory.mktemp("engc") / "f32.gguf")
    return make_llama_gguf(path, **dict(SMALL_LLAMA, gtype=GGMLType.F32), with_tokenizer=True)


@pytest.fixture(scope="module")
def runs(gguf):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.kvcache import KVCache, KVCacheQ8
    from zllm_torch.server.engine import Engine, Request

    zm = ZModel.load(gguf, dtype=jnp.float32)
    tm = Model.load(gguf, device="cpu", dtype=torch.float32)
    layouts = {"contiguous_f32": (dict(kv_layout="contiguous", kv_dtype=jnp.float32),
                                  dict(kv_layout="contiguous", kv_dtype=torch.float32), KVCache),
               "q8": (dict(kv_dtype="q8"), dict(kv_dtype="q8"), KVCacheQ8)}
    out = {}
    for layout, (zkw, tkw, cache_type) in layouts.items():
        for side, make_engine, make_request in (
                ("zllm", lambda **kw: ZEngine(zm, **zkw, **kw), lambda **kw: ZRequest(temp=0.0, **kw)),
                ("port", lambda **kw: Engine(tm, **tkw, **kw), lambda **kw: Request(temp=0.0, **kw))):
            got = out.setdefault((layout, side), {})
            for max_len in sorted(set(CASES.values())):
                eng = make_engine(n_slots=2, max_len=max_len, prefill_chunk=16)
                if side == "port":
                    assert type(eng.kv) is cache_type and not eng.paged
                    assert eng.max_len == max_len and eng.kv.max_len == max_len + 16
                eng.start()
                try:
                    got.update(_script(eng, make_request, max_len))
                finally:
                    eng.stop()
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_contiguous_engine_matches_zllm(runs, layout, case):
    zgot, zcount = runs[(layout, "zllm")][case]
    tgot, tcount = runs[(layout, "port")][case]
    assert all(err == "" for *_, err in tgot), tgot
    assert tgot == zgot
    assert tcount == zcount
    assert tcount["engine_errors_total"] == 0 and tcount["pages_cow_unshared_total"] == 0
    if case == "context_shift":
        assert tcount["context_shifts_total"] >= 1 and len(tgot[0][0]) == 30
    elif case == "prefix_reuse":  # the idle slot's own cache, not page-rounded
        assert tgot[1][2] == 30 and tcount["tokens_prefix_reused_total"] == 30
    elif case == "two_prompts":
        assert [len(t[0]) for t in tgot] == [8, 8] and tcount["prefill_steps_total"] > 0


@pytest.mark.parametrize("kw,match", [
    (dict(kv_dtype="q8", kv_layout="paged"), "contiguous KV layout"),
    (dict(kv_dtype="q5"), "unsupported kv_dtype"),
    (dict(kv_layout="striped"), "unknown kv_layout"),
], ids=["q8_paged", "q5", "layout"])
def test_invalid_kv_settings_raise_value_error(gguf, kw, match):
    """zllm refuses q8 with paged and an unknown kv_dtype string with
    ValueError; the port refuses the same, and an unknown layout too."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.server.engine import Engine as ZEngine
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine

    if "kv_layout" not in kw or kw.get("kv_dtype"):
        with pytest.raises(ValueError):
            ZEngine(ZModel.load(gguf, dtype=jnp.float32), n_slots=1, max_len=128, **kw)
    with pytest.raises(ValueError, match=match):
        Engine(Model.load(gguf, device="cpu", dtype=torch.float32), n_slots=1, max_len=128, **kw)


def test_contiguous_max_len_is_not_rounded(gguf):
    """Only the paged layout rounds max_len up to whole pages."""
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine

    m = Model.load(gguf, device="cpu", dtype=torch.float32)
    assert Engine(m, n_slots=1, max_len=100, kv_dtype="q8").max_len == 100
    assert Engine(m, n_slots=1, max_len=100, kv_layout="contiguous").max_len == 100
    assert Engine(m, n_slots=1, max_len=100).max_len == 128


def test_server_main_takes_kv_type_and_layout(gguf, monkeypatch):
    """`python -m zllm_torch.server M.gguf --kv-type q8` serves from the
    int8 cache; `--kv-type f32 --kv-layout contiguous` from an f32 stripe."""
    from zllm_torch.runtime.kvcache import KVCache, KVCacheQ8
    from zllm_torch.server import __main__ as server_main
    from zllm_torch.server.http import ZllmServer

    made = []
    monkeypatch.setattr(ZllmServer, "serve_forever", lambda self: made.append(self))
    server_main.main([gguf, "--kv-type", "q8", "--device", "cpu", "--port", "0"])
    server_main.main([gguf, "--kv-type", "f32", "--kv-layout", "contiguous", "--device", "cpu",
                      "--port", "0"])
    assert type(made[0].engine.kv) is KVCacheQ8 and not made[0].engine.paged
    assert type(made[1].engine.kv) is KVCache and made[1].engine.kv.dtype == torch.float32
