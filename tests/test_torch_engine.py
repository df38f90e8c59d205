"""The port's continuous-batching engine against zllm's, on the CPU.

Both engines serve one F32 llama file (SMALL_LLAMA's geometry, byte-level
vocab) with f32 weights, an f32 paged KV cache, 128-token pages, two slots,
16-token chunks and greedy requests; zllm's default layout for a plain
llama is the paged one.  The same request script goes through both, case by
case, on two engine configurations (max_len 256 and 128); every case holds
the port to zllm's out_tokens, finish_reason, n_prompt_reused and counter
deltas, exactly.  On the CPU zllm's attention is the gather + reference
path and the port's the plain versions of K9/K10, both f32, and the dense
matmuls are f32 on both sides: the logits agree to f32 rounding, far below
the gaps between the random model's top logits."""

import time

import numpy as np
import pytest
import torch
from test_torch_oracle import SMALL_LLAMA

from zllm.gguf.constants import GGMLType

COUNTERS = ("tokens_generated_total", "tokens_prefilled_total", "tokens_prefix_reused_total",
            "decode_steps_total", "prefill_steps_total", "context_shifts_total",
            "pages_cow_unshared_total", "engine_errors_total")
CONFIGS = {"A": dict(max_len=256), "B": dict(max_len=128)}
CASES = {  # case -> engine configuration it runs on
    "three_prompts": "A", "prefix_sharing": "A", "cow_shared_page": "A",
    "stop_strings": "A", "grammar": "A", "context_shift": "B", "cow_window": "B",
}
GRAMMAR = "root ::= [a-c]+\n"


def _toks(r, n, lo=3, hi=500):
    return [int(x) for x in r.integers(lo, hi, size=n)]


def _script(engine, make_request, make_grammar, tok, config):
    """Run config's cases in order on one started engine; returns
    {case: ([(out_tokens, finish_reason, n_prompt_reused, error)], counter
    deltas)}."""
    r = np.random.default_rng(0 if config == "A" else 1)
    out = {}

    def wait(reqs):
        deadline = time.time() + 120
        while not all(q.done for q in reqs):
            assert time.time() < deadline, "engine timed out"
            time.sleep(0.005)

    def run(case, waves):
        before = dict(engine.metrics)
        got = []
        for wave in waves:
            # a wave is submitted from the engine thread between two steps,
            # so it is admitted at one step on both sides
            reqs = engine.run_in_loop(lambda: [engine.submit(make_request(**kw)) for kw in wave])
            wait(reqs)
            got += [(list(q.out_tokens), q.finish_reason, q.n_prompt_reused, q.error)
                    for q in reqs]
        out[case] = (got, {k: engine.metrics[k] - before[k] for k in COUNTERS})

    if config == "A":
        run("three_prompts", [[dict(prompt_tokens=_toks(r, n), max_new=8) for n in (37, 5, 21)]])
        prefix = _toks(r, 160)
        run("prefix_sharing", [[dict(prompt_tokens=prefix + [7], max_new=4)],
                               [dict(prompt_tokens=prefix + [9], max_new=4)]])
        # slot 0 holds the prefix; the next wave puts a request back into it
        # and another into slot 1, which shares slot 0's full page; that
        # one reaches max_len and must copy-on-write unshare the page,
        # shift and keep generating
        prefix = _toks(r, 130)
        run("cow_shared_page", [[dict(prompt_tokens=prefix + [5], max_new=4)],
                                [dict(prompt_tokens=prefix + [8], max_new=4),
                                 dict(prompt_tokens=prefix + [6], max_new=140)]])
        prompt = tok.encode("qq", add_special=True)
        base = engine.submit(make_request(prompt_tokens=prompt, max_new=10))
        wait([base])
        text = tok.decode(base.out_tokens)
        stop = text[2:4]
        run("stop_strings", [[dict(prompt_tokens=prompt, max_new=10, stop_strings=(stop,))]])
        run("grammar", [[dict(prompt_tokens=tok.encode("x", add_special=True), max_new=6,
                              grammar=make_grammar(GRAMMAR))]])
    else:
        run("context_shift", [[dict(prompt_tokens=_toks(r, 90), max_new=80)]])
        shared = _toks(r, 70, hi=100)  # tests/test_paged_engine.py's CoW case
        run("cow_window", [[dict(prompt_tokens=shared + _toks(r, 8, hi=100), max_new=70)],
                           [dict(prompt_tokens=shared + _toks(r, 8, lo=100, hi=200),
                                 max_new=70)]])
    return out


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    path = str(tmp_path_factory.mktemp("eng") / "f32.gguf")
    return make_llama_gguf(path, **dict(SMALL_LLAMA, gtype=GGMLType.F32), with_tokenizer=True)


@pytest.fixture(scope="module")
def runs(gguf):
    import jax.numpy as jnp

    from zllm.grammar import GrammarSampler as ZGrammar
    from zllm.grammar import parse_gbnf as zparse
    from zllm.models.loader import Model as ZModel
    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.grammar import GrammarSampler, parse_gbnf
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request

    zm = ZModel.load(gguf, dtype=jnp.float32)
    tm = Model.load(gguf, device="cpu", dtype=torch.float32)
    sides = {
        "zllm": (lambda **kw: ZEngine(zm, kv_dtype=jnp.float32, **kw),
                 lambda **kw: ZRequest(temp=0.0, **kw),
                 lambda g: ZGrammar(zparse(g), zm.tokenizer), zm.tokenizer),
        "port": (lambda **kw: Engine(tm, kv_dtype=torch.float32, **kw),
                 lambda **kw: Request(temp=0.0, **kw),
                 lambda g: GrammarSampler(parse_gbnf(g), tm.tokenizer), tm.tokenizer),
    }
    out = {}
    for side, (make_engine, make_request, make_grammar, tok) in sides.items():
        out[side] = {}
        for config, kw in CONFIGS.items():
            eng = make_engine(n_slots=2, prefill_chunk=16, **kw)
            assert type(eng.kv).__name__ == "PagedKVCache"
            eng.start()
            try:
                out[side].update(_script(eng, make_request, make_grammar, tok, config))
            finally:
                eng.stop()
    out["tokenizer"] = tm.tokenizer
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_zllm(runs, case):
    zgot, zcount = runs["zllm"][case]
    tgot, tcount = runs["port"][case]
    assert all(err == "" for *_, err in tgot), tgot
    assert tgot == zgot
    assert tcount == zcount
    assert tcount["engine_errors_total"] == 0
    if case == "prefix_sharing":
        assert tgot[1][2] >= 128 and tcount["tokens_prefix_reused_total"] >= 128
    elif case == "cow_shared_page":
        assert tgot[1][2] == tgot[2][2] == 128 and len(tgot[2][0]) == 140
        assert tcount["pages_cow_unshared_total"] >= 1 and tcount["context_shifts_total"] >= 1
    elif case == "context_shift":
        assert tcount["context_shifts_total"] >= 1 and len(tgot[0][0]) == 80
    elif case == "cow_window":
        assert len(tgot[1][0]) == 70  # the second slot keeps generating
    elif case == "stop_strings":
        assert tgot[0][1] == "stop"
    elif case == "grammar":
        text = runs["tokenizer"].decode(tgot[0][0])
        assert text and set(text) <= set("abc"), text
    elif case == "three_prompts":
        assert [len(t[0]) for t in tgot] == [8, 8, 8]
        assert tcount["decode_steps_total"] > 0 and tcount["prefill_steps_total"] > 0


@pytest.mark.parametrize("kw", [{}, dict(kv_layout="contiguous"), dict(kv_dtype="q8")],
                         ids=["paged", "contiguous", "q8"])
def test_engine_counts_no_kernel_launch_on_cpu(gguf, kw):
    """A CPU engine runs the plain versions, in every layout: no kernel
    counter moves."""
    from zllm_torch.models.loader import Model
    from zllm_torch.ops import attention, qmatmul
    from zllm_torch.server.engine import Engine, Request

    kernels = (attention.paged_attention, attention.paged_attn_decode_update,
               attention.attn_decode_qkv, attention.flash_attention,
               attention.flash_attention_blockwise, qmatmul.q4k_gemm, qmatmul.dequant_gemm,
               qmatmul.q4k_matvec, qmatmul.int8_matvec)
    before = [k.launches for k in kernels]
    eng = Engine(Model.load(gguf, device="cpu", dtype=torch.float32), n_slots=2, max_len=128,
                 prefill_chunk=16, **kw)
    eng.start()
    try:
        req = eng.submit(Request(prompt_tokens=[1, 5, 9, 40], max_new=3, temp=0.0))
        deadline = time.time() + 60
        while not req.done:
            assert time.time() < deadline
            time.sleep(0.01)
    finally:
        eng.stop()
    assert len(req.out_tokens) == 3 and req.error == ""
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("kw,item", [(dict(tp=2), "10"), (dict(dp=2), "10"), (dict(pp=2), "10"),
                                     (dict(coordinated=True), "10")],
                         ids=["tp", "dp", "pp", "coordinated"])
def test_unported_options_raise(gguf, kw, item):
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine

    m = Model.load(gguf, device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP queue 1 item {item}\)"):
        Engine(m, n_slots=1, max_len=128, **kw)


@pytest.mark.parametrize("kw", [dict(speculative=True), dict(kv_layout="paged"),
                                dict(kv_dtype="q8"), dict(prefill_chunk=16)],
                         ids=["speculative", "paged", "q8", "small_chunk"])
def test_lookahead_rejects_bad_combos(gguf, kw):
    """zllm's tests/test_lookahead_engine.py refusals (and a prefill_chunk
    narrower than the default lookahead step, 3 + (4 + 4) * 2 = 19
    columns): ValueError with zllm's message."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.server.engine import Engine as ZEngine
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine

    with pytest.raises(ValueError) as want:
        ZEngine(ZModel.load(gguf, dtype=jnp.float32), n_slots=2, max_len=256, lookahead=True,
                **kw)
    with pytest.raises(ValueError) as got:
        Engine(Model.load(gguf, device="cpu", dtype=torch.float32), n_slots=2, max_len=256,
               lookahead=True, **kw)
    assert str(got.value) == str(want.value)


def test_sliding_window_model_is_refused(gguf, tmp_path):
    """A llama file with attention.sliding_window: zllm reads the window
    (its forward applies none on the llama block, swa_pattern 1, while its
    engine builds a KVCacheSWA), and the released model would window, so
    the port refuses it rather than attend the full context."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm_torch.gguf import GGUFWriter, read_gguf
    from zllm_torch.models.loader import Model

    out = str(tmp_path / "swa.gguf")
    with read_gguf(gguf) as f:
        w = GGUFWriter(out, alignment=f.alignment)
        for key, val in f.metadata.items():
            w.add(key, val)
        w.add("llama.attention.sliding_window", 64)
        for name, meta in f.tensors.items():
            w.add_tensor(name, np.asarray(f.tensor_bytes(name)), logical_shape=meta.shape,
                         gtype=meta.gtype)
        w.write()
    assert ZModel.load(out, dtype=jnp.float32).cfg.sliding_window == 64
    with pytest.raises(NotImplementedError, match="sliding-window"):
        Model.load(out, device="cpu", dtype=torch.float32)


def test_media_and_oversized_prompts_are_refused(gguf):
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request

    eng = Engine(Model.load(gguf, device="cpu", dtype=torch.float32), n_slots=1, max_len=100)
    assert eng.max_len == 128  # rounded up to whole pages
    with pytest.raises(NotImplementedError, match=r"media.*ROADMAP queue 1 item 4\.8\)"):
        eng.submit(Request(prompt_tokens=[1, 2], media=[(0, np.zeros((1, 4)))]))
    with pytest.raises(ValueError, match="exceeds context"):
        eng.submit(Request(prompt_tokens=list(range(128))))


# the engine's switches, on the paged and contiguous layouts: (layout,
# switch) -> the engine keywords
SWITCHES = {
    (layout, switch): dict(kw, **({"kv_layout": "contiguous"} if layout == "contiguous" else {}))
    for layout in ("paged", "contiguous")
    for switch, kw in (("no_prefix_reuse", dict(prefix_reuse=False, max_len=256)),
                       ("no_context_shift", dict(context_shift=False, max_len=128)))}


@pytest.fixture(scope="module")
def switch_runs(gguf):
    """Each switch's script on zllm's engine and the port's: shared-prefix
    traffic with prefix_reuse=False; a request running into max_len with
    context_shift=False."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request

    zm = ZModel.load(gguf, dtype=jnp.float32)
    tm = Model.load(gguf, device="cpu", dtype=torch.float32)
    sides = {"zllm": (lambda **kw: ZEngine(zm, kv_dtype=jnp.float32, **kw),
                      lambda **kw: ZRequest(temp=0.0, **kw)),
             "port": (lambda **kw: Engine(tm, kv_dtype=torch.float32, **kw),
                      lambda **kw: Request(temp=0.0, **kw))}
    out = {}
    for side, (make_engine, make_request) in sides.items():
        for (layout, switch), kw in SWITCHES.items():
            eng = make_engine(n_slots=2, prefill_chunk=16, **kw)
            eng.start()
            try:
                r = np.random.default_rng(3)
                if switch == "no_prefix_reuse":
                    prefix = _toks(r, 150)
                    waves = [[dict(prompt_tokens=prefix + [7], max_new=4)],
                             [dict(prompt_tokens=prefix + [9], max_new=4),
                              dict(prompt_tokens=prefix + [11], max_new=4)]]
                else:
                    waves = [[dict(prompt_tokens=_toks(r, 90), max_new=80)]]
                before = dict(eng.metrics)
                got = []
                for wave in waves:
                    reqs = eng.run_in_loop(lambda wave=wave: [
                        eng.submit(make_request(**w)) for w in wave])
                    deadline = time.time() + 120
                    while not all(q.done for q in reqs):
                        assert time.time() < deadline, "engine timed out"
                        time.sleep(0.005)
                    got += [(list(q.out_tokens), q.finish_reason, q.n_prompt_reused, q.error)
                            for q in reqs]
                out[side, layout, switch] = (got, {k: eng.metrics[k] - before[k]
                                                   for k in COUNTERS})
            finally:
                eng.stop()
    return out


@pytest.mark.parametrize("layout,switch", list(SWITCHES), ids=["-".join(k) for k in SWITCHES])
def test_engine_switches_match_zllm(switch_runs, layout, switch):
    zgot, zcount = switch_runs["zllm", layout, switch]
    tgot, tcount = switch_runs["port", layout, switch]
    assert all(err == "" for *_, err in tgot), tgot
    assert tgot == zgot and tcount == zcount
    if switch == "no_prefix_reuse":
        assert tcount["tokens_prefix_reused_total"] == 0 and tcount["tokens_prefilled_total"] == 453
        assert [g[2] for g in tgot] == [0, 0, 0]
    else:  # finished at max_len, never shifted: prompt 90 + 38 tokens = 128
        assert tcount["context_shifts_total"] == 0
        assert tgot[0][1] == "length" and len(tgot[0][0]) == 128 - 90
