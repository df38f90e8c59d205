"""Lookahead decoding in the port against zllm's, on the CPU: the masked
forward, `zllm_torch.lookahead` (zllm's tools/lookahead.py) and the serving
engine's lookahead.

  * `forward(..., mask=, kv_positions=)`: an explicit block mask over the
    contiguous cache, rows stored apart from their rope positions; the
    logits within nmse 1e-6 of zllm's forward in f32 and the cache equal
    (llama and OLMo-2 F32 files);
  * `lookahead_generate` (zllm's tests/test_lookahead.py cases: F32
    weights, an f32 cache) gives zllm's tokens and stats and plain greedy
    decoding's tokens;
  * the `Engine` with lookahead=True (zllm's tests/test_lookahead_engine.py
    geometry in F32, f32 KV, 2 slots, chunk 64): one prompt, a cyclic one
    over 96 tokens, a greedy and a sampled request together, and a second
    prompt arriving mid-generation (the flush of accepted tokens not yet
    in the cache): the greedy tokens and every counter equal zllm's
    Engine's, and the greedy tokens the port's plain engine's;
  * `python -m zllm_torch.server --lookahead` (and ZLLM_ARG_LOOKAHEAD=1)
    looks ahead; `python -m zllm_torch.lookahead` runs.

On the CPU the masked attention is f32 on both sides (zllm's XLA
reference, the port's `attention_ref`), as are the matmuls."""

import numpy as np
import pytest
import torch
from test_torch_oracle import nmse, serve_and_read_metrics, to_np

from zllm.gguf.constants import GGMLType

COUNTERS = ("spec_drafted_total", "spec_accepted_total", "lookahead_steps_total",
            "lookahead_accepted_total", "decode_steps_total", "prefill_steps_total",
            "tokens_generated_total", "engine_errors_total")
GEOMETRY = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128)
REPEAT = ([5, 6, 7, 8] * 6)[:24]


def _load(path):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm_torch.models.loader import Model

    return (ZModel.load(path, quantized=False, dtype=jnp.float32),
            Model.load(path, device="cpu", dtype=torch.float32))


# -- forward(mask=, kv_positions=) -------------------------------------------------

def _masked_step(seed: int, vocab: int, p0s: list[int], t: int, s: int):
    """A lookahead-shaped step: row b's tokens stored at slots p0 .. p0+t-1,
    at rope positions from p0 on (repeats allowed), each column attending
    the committed prefix [0, p0), its own slot and a random choice of the
    step's earlier slots."""
    r = np.random.default_rng(seed)
    b = len(p0s)
    toks = r.integers(1, vocab, size=(b, t)).astype(np.int32)
    pos = np.zeros((b, t), np.int32)
    slots = np.zeros((b, t), np.int32)
    mask = np.zeros((b, t, s), bool)
    for i, p0 in enumerate(p0s):
        slots[i] = p0 + np.arange(t)
        pos[i] = p0 + np.sort(r.integers(0, t, size=t))
        for c in range(t):
            mask[i, c, :p0] = True
            mask[i, c, p0 + c] = True
            mask[i, c, p0:p0 + c] = r.random(c) < 0.5
    return toks, pos, slots, mask


@pytest.mark.parametrize("arch", ["llama", "olmo2"])
def test_masked_forward_matches_zllm(tmp_path, arch):
    import jax.numpy as jnp

    from zllm.models.llama import forward as zforward
    from zllm.runtime.kvcache import KVCache as ZKV
    from zllm_torch.models.llama import forward
    from zllm_torch.runtime.kvcache import KVCache
    from zllm_torch.testing import make_llama_gguf

    vocab, s, t = 128, 64, 11
    shape = dict(GEOMETRY, **({"n_kv_heads": 4, "norm_eps": 1e-6} if arch == "olmo2" else {}))
    path = make_llama_gguf(str(tmp_path / f"{arch}.gguf"), arch=arch, **shape,
                           vocab_size=vocab, gtype=GGMLType.F32)
    zm, m = _load(path)
    cfg = zm.cfg
    b = 2
    zkv = ZKV.create(cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim, jnp.float32)
    kv = KVCache.create(cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim, torch.float32, "cpu")
    prompt = np.random.default_rng(3).integers(1, vocab, size=(b, 16)).astype(np.int32)
    ppos = np.tile(np.arange(16, dtype=np.int32), (b, 1))
    _, zkv = zforward(zm.params, cfg, jnp.asarray(prompt), jnp.asarray(ppos), zkv)
    with torch.inference_mode():
        forward(m.params, m.cfg, torch.from_numpy(prompt), torch.from_numpy(ppos), kv)
        for seed, p0s in ((0, [16, 9]), (1, [12, 16])):
            toks, pos, slots, mask = _masked_step(seed, vocab, p0s, t, s)
            zlog, zkv = zforward(zm.params, cfg, jnp.asarray(toks), jnp.asarray(pos), zkv,
                                 mask=jnp.asarray(mask), kv_positions=jnp.asarray(slots))
            log = forward(m.params, m.cfg, torch.from_numpy(toks), torch.from_numpy(pos), kv,
                          mask=torch.from_numpy(mask), kv_positions=torch.from_numpy(slots))
            assert log.shape == (b, t, vocab)
            assert nmse(to_np(log), to_np(zlog)) <= 1e-6
    for il in range(cfg.n_layers):
        assert nmse(to_np(kv.k[il]), to_np(zkv.k[il])) <= 1e-6
        assert nmse(to_np(kv.v[il]), to_np(zkv.v[il])) <= 1e-6


# -- lookahead_generate ------------------------------------------------------------

@pytest.fixture(scope="module")
def la_models(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path_factory.mktemp("la") / "la.gguf"), **GEOMETRY,
                           vocab_size=128, gtype=GGMLType.F32)
    return _load(path)


def _greedy_tokens(model, prompt, n_new):
    from zllm_torch.runtime.generate import Generator

    gen = Generator(model, max_len=256, prefill_chunk=16, kv_dtype=torch.float32)
    return gen.generate(prompt, max_new=n_new).tokens


@pytest.mark.parametrize("case", ["matches_greedy", "accepts_on_repetition"])
def test_lookahead_generate_matches_zllm(la_models, case):
    from tools.lookahead import lookahead_generate as zgenerate
    from zllm_torch.lookahead import lookahead_generate

    zm, m = la_models
    seed, size, n_new, wg = (0, 9, 24, 4) if case == "matches_greedy" else (1, 5, 48, 6)
    prompt = np.random.default_rng(seed).integers(1, 120, size=size).tolist()
    ztoks, zstats = zgenerate(zm, prompt, n_new, w=wg, n=3, g=wg, max_len=256)
    toks, stats = lookahead_generate(m, prompt, n_new, w=wg, n=3, g=wg, max_len=256)
    assert toks == ztoks == _greedy_tokens(m, prompt, n_new)
    assert stats == zstats
    assert stats["steps"] >= 1 and stats["tokens_per_step"] >= 1.0
    if case == "accepts_on_repetition":
        assert stats["accepted_from_grams"] >= 1


def test_python_m_lookahead_runs(tmp_path, capsys):
    from zllm_torch.lookahead import main
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "t.gguf"), **GEOMETRY, vocab_size=260,
                           gtype=GGMLType.F32, with_tokenizer=True)
    main([path, "-p", "abab", "-n", "12", "-W", "3", "-N", "3", "-G", "3", "--device", "cpu"])
    out = capsys.readouterr()
    assert "'steps':" in out.err and "'accepted_from_grams':" in out.err and out.out.strip()


# -- the engine ------------------------------------------------------------------------

def _script(engine, make_request) -> dict:
    """zllm's lookahead engine cases in order on one engine: {case:
    ([(out_tokens, finish_reason, error)], counter deltas)}."""
    import time

    hook = {}
    step = engine._step_once

    def hooked():  # on the engine thread, before every step
        if "fn" in hook:
            hook["fn"]()
        step()

    engine._step_once = hooked
    engine.start()
    out = {}

    def wait(reqs):
        deadline = time.time() + 300
        while not all(q.done for q in reqs):
            assert time.time() < deadline, "engine timed out"
            time.sleep(0.005)

    def run(case, reqs_kw, late=None):
        before = dict(engine.metrics)
        reqs = engine.run_in_loop(lambda: [engine.submit(make_request(**kw)) for kw in reqs_kw])
        if late is not None:
            # the late request enters when the first has 8 tokens, at a step
            # boundary, so both engines admit it at the same step
            r2 = make_request(**late)

            def submit_late():
                if len(reqs[0].out_tokens) >= 8:
                    engine.submit(r2)
                    hook.pop("fn")

            hook["fn"] = submit_late
            wait(reqs)
            reqs.append(r2)
        wait(reqs)
        out[case] = ([(list(q.out_tokens), q.finish_reason, q.error) for q in reqs],
                     {k: engine.metrics[k] - before[k] for k in COUNTERS})

    try:
        run("single", [dict(prompt_tokens=REPEAT, max_new=48, temp=0.0)])
        run("cyclic", [dict(prompt_tokens=([3, 9, 4, 1] * 8)[:32], max_new=96, temp=0.0)])
        run("mixed", [dict(prompt_tokens=REPEAT, max_new=48, temp=0.0),
                      dict(prompt_tokens=[9, 2, 9, 2], max_new=48, temp=0.9, seed=3)])
        run("interleaved", [dict(prompt_tokens=REPEAT, max_new=64, temp=0.0)],
            late=dict(prompt_tokens=([4, 4, 2, 2] * 5)[:20], max_new=32, temp=0.0))
    finally:
        engine.stop()
    return out


@pytest.fixture(scope="module")
def la_runs(tmp_path_factory):
    import jax.numpy as jnp

    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm.testing import make_llama_gguf
    from zllm_torch.server.engine import Engine, Request

    path = make_llama_gguf(str(tmp_path_factory.mktemp("lae") / "la.gguf"), **GEOMETRY,
                           vocab_size=256, gtype=GGMLType.F32)
    zm, m = _load(path)
    base = dict(n_slots=2, max_len=256, prefill_chunk=64)
    return {"zllm": _script(ZEngine(zm, kv_dtype=jnp.float32, lookahead=True, **base),
                            ZRequest),
            "port": _script(Engine(m, kv_dtype=torch.float32, lookahead=True, **base), Request),
            "plain": _script(Engine(m, kv_dtype=torch.float32, **base), Request)}


@pytest.mark.parametrize("case", ["single", "cyclic", "mixed", "interleaved"])
def test_lookahead_engine_matches_zllm(la_runs, case):
    (zgot, zcount), (got, count) = la_runs["zllm"][case], la_runs["port"][case]
    plain, _ = la_runs["plain"][case]
    assert all(err == "" for *_, err in got), got
    for z, p, ref in zip(zgot, got, plain):
        assert len(p[0]) == len(z[0]) == len(ref[0])
    greedy = [0, 1] if case == "interleaved" else [0]
    for i in greedy:
        assert got[i] == zgot[i] and got[i][0] == plain[i][0]
    assert count == zcount
    assert count["lookahead_steps_total"] > 0 and count["engine_errors_total"] == 0
    assert count["lookahead_steps_total"] <= count["tokens_generated_total"]
    if case == "cyclic":  # a prompt-seeded pool on a cyclic context accepts grams
        assert count["lookahead_accepted_total"] > 0


@pytest.mark.parametrize("how", ["--lookahead", "ZLLM_ARG_LOOKAHEAD"])
def test_python_m_server_looks_ahead(tmp_path, how):
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "m.gguf"), n_layers=1, n_embd=256, n_heads=4,
                           n_kv_heads=2, n_ff=256, vocab_size=260, gtype=GGMLType.Q8_0,
                           with_tokenizer=True)
    args, env = ([path, "--lookahead"], {}) if how == "--lookahead" else (
        [path], {"ZLLM_ARG_LOOKAHEAD": "1"})
    m = serve_and_read_metrics(args, env, "abcabcabcabcabc")
    assert m["lookahead_steps_total"] > 0 and m["engine_errors_total"] == 0


def test_last_logits_of_a_multirow_step_reach_the_gemm_contiguous(tmp_path, monkeypatch):
    """The lookahead flush is a [n_slots, la_n - 1] step with
    logits_for="last": its head reads each row's last column, a strided
    view, which the card's GEMM kernels refuse; `linear` hands them
    contiguous rows (the plain versions take any strides, so the CPU run
    alone would not show it)."""
    from zllm_torch.models.llama import forward
    from zllm_torch.models.loader import Model
    from zllm_torch.ops import linear as linmod
    from zllm_torch.runtime.kvcache import KVCache
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "q.gguf"), n_layers=1, n_embd=256, n_heads=4,
                           n_kv_heads=2, n_ff=256, vocab_size=260, gtype=GGMLType.Q8_0)
    m = Model.load(path, device="cpu", dtype=torch.float32)
    seen = []
    real = linmod.qmm.gemm

    def gemm(x, w):
        seen.append(x.is_contiguous())
        return real(x, w)

    monkeypatch.setattr(linmod.qmm, "gemm", gemm)
    kv = KVCache.create(1, 4, 64, 2, 64, torch.float32, "cpu")
    toks = torch.ones(4, 2, dtype=torch.int32)
    pos = torch.tensor([[5, 6], [9, 48], [48, 48], [48, 48]], dtype=torch.int32)
    with torch.inference_mode():
        out = forward(m.params, m.cfg, toks, pos, kv, logits_for="last")
    assert out.shape == (4, 1, 260) and seen and all(seen)
