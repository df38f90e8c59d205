"""Speculative decoding in the port against zllm's, on the CPU: n-gram
proposals, the single-sequence `SpeculativeDecoder`, and the serving
engine's n-gram, draft-model and self speculation.

  * `ngram_propose` returns zllm's proposal on seeded random lists;
  * `SpeculativeDecoder` (zllm's tests/test_speculative.py geometry: an
    F32 2-layer target, a 1-layer draft, f32 weights, so its verify GEMM
    and its decode matvecs round alike) gives zllm's tokens and counts and
    the port's plain greedy `Generator` tokens, with and without a draft;
  * the `Engine` (zllm's tests/test_spec_engine.py geometry in F32, f32
    KV, 2 slots, chunk 32, n_draft 4): n-gram, draft-model and
    self-speculation give zllm's Engine's tokens and counters, exactly
    (the four speculation and lookahead counters among them), and the
    port's plain engine's tokens; a sampled request rides along
    unspeculated;
  * the same on an OLMo-2 F32 file against zllm; over a paged and a q8
    cache and on a Q4_K file (the GEMM plain versions) the port's
    speculating engine gives its plain engine's tokens;
  * `python -m zllm_torch.server --spec` (and `--model-draft`) speculates.

On the CPU both sides' matmuls are f32 (or the same plain versions) and
their attention f32; the card's per-column bits are held by
tests/test_torch_verify_step.py and tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
from test_torch_oracle import SMALL_LLAMA, run_waves, serve_and_read_metrics

from zllm.gguf.constants import GGMLType

COUNTERS = ("spec_drafted_total", "spec_accepted_total", "lookahead_steps_total",
            "lookahead_accepted_total", "decode_steps_total", "prefill_steps_total",
            "tokens_generated_total", "engine_errors_total")
REPEAT = ([5, 6, 7, 8] * 6)[:24]  # a repetitive prompt gives the n-gram proposer material
TARGET = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128)
DRAFT = dict(n_layers=1, n_embd=32, n_heads=2, n_kv_heads=2, n_ff=64)


def _load(path):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm_torch.models.loader import Model

    return (ZModel.load(path, quantized=False, dtype=jnp.float32),
            Model.load(path, device="cpu", dtype=torch.float32))


# -- ngram_propose -----------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_ngram_propose_matches_zllm(seed):
    from zllm.runtime.speculative import ngram_propose as zpropose
    from zllm_torch.runtime.speculative import ngram_propose

    r = np.random.default_rng(seed)
    hits = 0
    for _ in range(300):
        toks = [int(t) for t in r.integers(0, 2 + seed, size=int(r.integers(0, 40)))]
        n_draft, max_ngram = int(r.integers(1, 10)), int(r.integers(1, 6))
        min_ngram = int(r.integers(1, max_ngram + 1))
        want = zpropose(toks, n_draft, max_ngram, min_ngram)
        assert ngram_propose(toks, n_draft, max_ngram, min_ngram) == want
        hits += bool(want)
    assert hits > 50  # the small alphabets repeat: most lists propose


def test_ngram_propose_cases():
    from zllm_torch.runtime.speculative import ngram_propose

    assert ngram_propose([1, 2, 3, 9, 9, 1, 2, 3], n_draft=2)[:2] == [9, 9]
    assert ngram_propose([1, 2, 3, 4], n_draft=4) == []


# -- SpeculativeDecoder ------------------------------------------------------

@pytest.fixture(scope="module")
def decoder_models(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    d = tmp_path_factory.mktemp("spec")
    tgt = make_llama_gguf(str(d / "target.gguf"), **TARGET, vocab_size=64,
                          gtype=GGMLType.F32, seed=0)
    drf = make_llama_gguf(str(d / "draft.gguf"), **DRAFT, vocab_size=64, gtype=GGMLType.F32,
                          seed=1)
    return _load(tgt), _load(drf)


@pytest.mark.parametrize("use_draft", [False, True], ids=["ngram", "draft"])
def test_speculative_decoder_matches_zllm_and_greedy(decoder_models, use_draft):
    from zllm.runtime.speculative import SpeculativeDecoder as ZDecoder
    from zllm_torch.runtime.generate import Generator
    from zllm_torch.runtime.speculative import SpeculativeDecoder

    (ztarget, target), (zdraft, draft) = decoder_models
    prompt = [5, 9, 5, 9, 5, 9, 13]
    want = Generator(target, max_len=256, prefill_chunk=8,
                     kv_dtype=torch.float32).generate(prompt, max_new=16).tokens
    zspec = ZDecoder(ztarget, zdraft if use_draft else None, n_draft=4, max_len=256)
    ztoks = zspec.generate(prompt, max_new=16)
    spec = SpeculativeDecoder(target, draft if use_draft else None, n_draft=4, max_len=256)
    got = spec.generate(prompt, max_new=16)
    assert got == ztoks == want
    assert (spec.n_drafted, spec.n_accepted) == (zspec.n_drafted, zspec.n_accepted)
    assert spec.n_drafted > 0


# -- the engine ----------------------------------------------------------------

def _engines(zmodel, model, **kw):
    """(side, engine, make_request) for zllm and the port, f32 KV."""
    import jax.numpy as jnp

    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.server.engine import Engine, Request

    zkw = dict(kw)
    if "draft_model" in kw:
        zkw["draft_model"] = kw["draft_model"][0]
        kw = dict(kw, draft_model=kw["draft_model"][1])
    base = dict(n_slots=2, max_len=256, prefill_chunk=32, n_draft=4)
    return [("zllm", ZEngine(zmodel, kv_dtype=jnp.float32, **base, **zkw), ZRequest),
            ("port", Engine(model, kv_dtype=torch.float32, **base, **kw), Request)]


def _greedy(**kw):
    return dict(temp=0.0, **kw)


# mode -> (engine keywords, waves); "draft"/"self" name the draft model
SPEC_CASES = {
    "ngram": (dict(speculative=True),
              [[_greedy(prompt_tokens=REPEAT, max_new=48)],
               [_greedy(prompt_tokens=[3, 9, 4, 1] * 4, max_new=32),
                dict(prompt_tokens=[9, 2, 9, 2] * 2, max_new=32, temp=0.9, seed=7)]]),
    "draft": (dict(draft_model="draft"), [[_greedy(prompt_tokens=REPEAT, max_new=48)]]),
    "self": (dict(draft_model="self"), [[_greedy(prompt_tokens=[9, 3, 11, 40, 2, 77],
                                                 max_new=24)]]),
}


@pytest.fixture(scope="module")
def engine_models(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    d = tmp_path_factory.mktemp("spec_engine")
    tgt = make_llama_gguf(str(d / "spec.gguf"), **TARGET, vocab_size=256, gtype=GGMLType.F32)
    drf = make_llama_gguf(str(d / "draft.gguf"), **DRAFT, vocab_size=256, gtype=GGMLType.F32)
    return _load(tgt), _load(drf)


@pytest.fixture(scope="module")
def spec_runs(engine_models):
    from zllm_torch.server.engine import Engine, Request

    (zm, m), draft = engine_models
    out = {}
    for mode, (kw, waves) in SPEC_CASES.items():
        if "draft_model" in kw:
            kw = dict(kw, draft_model=draft if kw["draft_model"] == "draft" else (zm, m))
        for side, eng, req in _engines(zm, m, **kw):
            out[mode, side] = run_waves(eng, req, waves, COUNTERS)
        plain = Engine(m, n_slots=2, max_len=256, prefill_chunk=32, kv_dtype=torch.float32)
        out[mode, "plain"] = run_waves(plain, Request, waves, COUNTERS)
    return out


@pytest.mark.parametrize("mode", list(SPEC_CASES))
def test_spec_engine_matches_zllm(spec_runs, mode):
    (zgot, zcount), (got, count) = spec_runs[mode, "zllm"], spec_runs[mode, "port"]
    plain, _ = spec_runs[mode, "plain"]
    waves = SPEC_CASES[mode][1]
    reqs = [kw for wave in waves for kw in wave]
    assert all(err == "" for *_, err in got), got
    for kw, z, p, ref in zip(reqs, zgot, got, plain):
        if kw["temp"] == 0:  # greedy: zllm's tokens, and plain greedy's
            assert p == z and p[0] == ref[0], (p, z, ref)
        else:  # sampled rides along: its length, not its draws
            assert len(p[0]) == len(z[0]) == kw["max_new"]
    assert count == zcount
    assert count["spec_drafted_total"] > 0 and count["engine_errors_total"] == 0
    if mode == "self":  # the target drafting for itself: every draft accepted
        assert count["spec_accepted_total"] == count["spec_drafted_total"]


def test_spec_engine_refusals_and_defaults(engine_models):
    """A draft model implies speculation and picks the contiguous layout;
    n_draft is capped at prefill_chunk - 1; the q8 cache and an explicit
    paged layout take speculation, as zllm's engine does."""
    from zllm_torch.server.engine import Engine

    (_, m), (_, d) = engine_models
    eng = Engine(m, n_slots=1, max_len=128, prefill_chunk=4, draft_model=d, n_draft=9)
    assert eng.speculative and eng.draft is d and not eng.paged and eng.n_draft == 3
    assert eng.dkv.max_len == 128 + 4 and eng.dkv.n_layers == 1
    assert Engine(m, n_slots=1, max_len=128, speculative=True, kv_dtype="q8").speculative
    assert Engine(m, n_slots=1, max_len=128, speculative=True, kv_layout="paged").paged


def _port_pair(model, layout_kw, waves, **kw):
    """The port's speculating and plain engines on the same waves."""
    from zllm_torch.server.engine import Engine, Request

    base = dict(n_slots=2, max_len=256, prefill_chunk=32, **layout_kw)
    spec = run_waves(Engine(model, speculative=True, n_draft=4, **base, **kw), Request, waves,
                     COUNTERS)
    plain = run_waves(Engine(model, **base), Request, waves, COUNTERS)
    return spec, plain


@pytest.mark.parametrize("layout", ["paged", "q8", "q4_k"])
def test_spec_engine_layouts_match_plain(engine_models, tmp_path, layout):
    """Over pages (K9 a column), the q8 cache (K7's split form a column)
    and a Q4_K file (K3's plain version at M = 10 against M = 2 for
    decode) the speculating engine gives the plain engine's tokens."""
    if layout == "q4_k":
        from zllm_torch.models.loader import Model
        from zllm_torch.testing import make_llama_gguf

        path = make_llama_gguf(str(tmp_path / "q4k.gguf"), **SMALL_LLAMA)
        model, layout_kw = Model.load(path, device="cpu", dtype=torch.float32), {}
        waves = [[_greedy(prompt_tokens=[7, 8, 9, 10] * 5, max_new=24),
                  _greedy(prompt_tokens=[40, 41] * 8, max_new=24)]]
    else:
        model = engine_models[0][1]
        layout_kw = {"kv_layout": "paged"} if layout == "paged" else {"kv_dtype": "q8"}
        waves = [[_greedy(prompt_tokens=REPEAT, max_new=40)]]
    (got, count), (plain, _) = _port_pair(model, layout_kw, waves)
    assert got == plain
    assert count["spec_drafted_total"] > 0 and count["engine_errors_total"] == 0


def test_spec_engine_olmo2_matches_zllm(tmp_path):
    """OLMo-2 (K8 a column over the contiguous cache) against zllm."""
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "olmo2.gguf"), arch="olmo2", n_layers=2, n_embd=256,
                           n_heads=4, n_kv_heads=4, n_ff=512, vocab_size=512,
                           gtype=GGMLType.F32, norm_eps=1e-6, rope_base=500000.0)
    zm, m = _load(path)
    waves = [[_greedy(prompt_tokens=[11, 12, 13] * 6, max_new=32)]]
    (zgot, zcount), (got, count) = [run_waves(eng, req, waves, COUNTERS)
                                    for _, eng, req in _engines(zm, m, speculative=True)]
    assert got == zgot and count == zcount
    assert count["spec_drafted_total"] > 0


# -- python -m zllm_torch.server ------------------------------------------------

@pytest.fixture(scope="module")
def served_file(tmp_path_factory):
    from zllm_torch.testing import make_llama_gguf

    return make_llama_gguf(str(tmp_path_factory.mktemp("srv") / "m.gguf"), n_layers=1,
                           n_embd=256, n_heads=4, n_kv_heads=2, n_ff=256, vocab_size=260,
                           gtype=GGMLType.Q8_0, with_tokenizer=True)


@pytest.mark.parametrize("how", ["--spec", "ZLLM_ARG_SPEC", "--model-draft"])
def test_python_m_server_speculates(served_file, how):
    args, env = [served_file], {}
    if how == "--spec":
        args += ["--spec", "--draft-max", "3"]
    elif how == "ZLLM_ARG_SPEC":
        env = {"ZLLM_ARG_SPEC": "1", "ZLLM_ARG_DRAFT_MAX": "3"}
    else:
        args += ["--model-draft", served_file]
    m = serve_and_read_metrics(args, env, "abcabcabcabcabcabc")
    assert m["spec_drafted_total"] > 0 and m["engine_errors_total"] == 0
    if how == "--model-draft":  # the model drafting for itself
        assert m["spec_accepted_total"] == m["spec_drafted_total"]


def test_draft_engine_keeps_speculating_after_a_context_shift(engine_models):
    """A slot that shifts its context (max_len 64) keeps speculating with
    its draft: the draft's stripe is fed again from n_keep, and the greedy
    tokens equal the plain engine's across the shift (zllm's catch-up
    finds no token to feed there and fails the step; ROADMAP queue 3)."""
    from zllm_torch.server.engine import Engine, Request

    (_, m), (_, d) = engine_models
    waves = [[_greedy(prompt_tokens=REPEAT + [9, 10, 11] * 5, max_new=60)]]
    base = dict(n_slots=1, max_len=64, prefill_chunk=16, kv_dtype=torch.float32,
                kv_layout="contiguous")
    got, count = run_waves(Engine(m, draft_model=d, n_draft=4, **base), Request, waves,
                           COUNTERS + ("context_shifts_total",))
    plain, pcount = run_waves(Engine(m, **base), Request, waves,
                              COUNTERS + ("context_shifts_total",))
    assert got == plain and got[0][2] == ""
    assert count["context_shifts_total"] == pcount["context_shifts_total"] >= 1
    assert count["spec_drafted_total"] > 0 and count["engine_errors_total"] == 0
