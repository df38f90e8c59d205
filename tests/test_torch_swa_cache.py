"""The pruned sliding-window ring cache (`KVCacheSWA`, `ring_mask`) and the
engine's choices for a windowed model, in the port against zllm on the
CPU (mirroring tests/test_swa_cache.py).

  * `ring_mask` equals zllm's on live and trash positions; `create_swa`
    gives zllm's ring, horizon and per-layer slots;
  * a Gemma-2 file (zllm's converter, tests/test_torch_gemma.py's state
    dict: 4 layers, heads of 16, window 32) over the ring gives the full
    cache's logits through a chunk-aligned prefill and decode far past the
    window, and zllm's ring's; a trash row's writes leave a live row's next
    logits as a trash-free run's;
  * the engine (2 slots, chunk 16, greedy) gives zllm's Engine's tokens,
    finish reasons, reused prefixes and counters on the ring ("auto"), on
    the contiguous stripe with `context_shift=True` (every kernel windowed)
    and explicit paged (K9/K10 windowed), Gemma-2 and Gemma-3;
  * q8 and lookahead are refused with zllm's messages, slot state files on
    the ring with a ValueError; `python -m zllm_torch.server` serves a
    Gemma-2 file from the ring."""

import time

import numpy as np
import pytest
import torch
from test_arch_parity import ARCH_CFGS
from test_torch_oracle import (gemma_hf_state, gemma_tokenizer_kv, nmse,
                               serve_and_read_metrics, to_np)

from zllm.gguf.constants import GGMLType

WINDOW = 32
CHUNK = 16
COUNTERS = ("tokens_generated_total", "tokens_prefilled_total", "tokens_prefix_reused_total",
            "decode_steps_total", "prefill_steps_total", "context_shifts_total",
            "engine_errors_total")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from zllm.convert import convert_hf_llama

    folder = tmp_path_factory.mktemp("swa")
    out = {}
    for i, name in enumerate(("gemma2", "gemma3")):
        cfg = dict(ARCH_CFGS[name], vocab_size=300)
        out[name] = convert_hf_llama(gemma_hf_state(cfg, 10 + i), cfg, str(folder / f"{name}.gguf"),
                                     arch=name, gtype=GGMLType.F32,
                                     tokenizer_kv=gemma_tokenizer_kv(300))
    return out


@pytest.fixture(scope="module")
def models(files):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm_torch.models.loader import Model

    return {name: (ZModel.load(path, dtype=jnp.float32),
                   Model.load(path, device="cpu", dtype=torch.float32))
            for name, path in files.items()}


@pytest.mark.parametrize("ring,window", [(128, 32), (64, 0), (96, 40)])
def test_ring_mask_matches_zllm(ring, window):
    import jax.numpy as jnp

    from zllm.runtime.kvcache import ring_mask as zring_mask
    from zllm_torch.runtime.kvcache import ring_mask

    rng = np.random.default_rng(ring + window)
    pos = rng.integers(0, 400, (3, 5)).astype(np.int32)
    pos[1] = 512 + np.arange(5)  # a trash row
    want = np.asarray(zring_mask(jnp.asarray(pos), ring, ring + CHUNK, window))
    got = ring_mask(torch.from_numpy(pos), ring, ring + CHUNK, window).numpy()
    assert got.dtype == bool and np.array_equal(got, want)


def test_create_swa_matches_zllm(models):
    import jax.numpy as jnp

    from zllm.runtime.kvcache import KVCacheSWA as ZSWA
    from zllm_torch.runtime.kvcache import KVCacheSWA

    for zm, tm in models.values():
        for max_len in (64, 512):
            z = ZSWA.create_swa(zm.cfg, 2, max_len, CHUNK, jnp.float32)
            t = KVCacheSWA.create_swa(tm.cfg, 2, max_len, CHUNK, torch.float32, "cpu")
            assert (t.ring, t.horizon, t.swa_mask) == (z.ring, z.horizon, z.swa_mask)
            assert [tuple(x.shape) for x in t.k] == [tuple(x.shape) for x in z.k]
            assert t.max_len == z.max_len
            assert [t.ring_size(il) for il in range(t.n_layers)] == [
                z.ring_size(il) for il in range(t.n_layers)]


def test_ring_equals_full_cache_far_past_the_window(models):
    """Prefill 64 tokens in chunks of 16, then decode to position 200
    (ring 128 + 16 slots a windowed layer): the port's ring gives its full
    cache's logits and zllm's ring's."""
    import jax
    import jax.numpy as jnp

    from zllm.models.llama import forward as zforward
    from zllm.runtime.kvcache import KVCacheSWA as ZSWA
    from zllm_torch.models.llama import forward
    from zllm_torch.runtime.kvcache import KVCache, KVCacheSWA

    zm, tm = models["gemma2"]
    cfg, max_len = tm.cfg, 256
    ring = KVCacheSWA.create_swa(cfg, 1, max_len, CHUNK, torch.float32, "cpu")
    assert ring.k[0].shape[2] < max_len and ring.k[1].shape[2] == max_len + CHUNK
    full = KVCache.create(cfg.n_layers, 1, max_len + CHUNK, cfg.n_kv_heads, cfg.head_dim,
                          torch.float32, "cpu")
    zring = ZSWA.create_swa(zm.cfg, 1, max_len, CHUNK, jnp.float32)
    zstep = jax.jit(lambda p, t, q, kv: zforward(p, zm.cfg, t, q, kv, logits_for="last"))
    toks = np.random.default_rng(0).integers(3, 290, 64).astype(np.int32)

    def step(t, p):
        nonlocal zring
        tt, pp = torch.from_numpy(t[None]), torch.from_numpy(p[None])
        a = forward(tm.params, cfg, tt, pp, ring, logits_for="last")
        b = forward(tm.params, cfg, tt, pp, full, logits_for="last")
        zl, zring = zstep(zm.params, jnp.asarray(t[None]), jnp.asarray(p[None]), zring)
        return to_np(a)[0, -1], to_np(b)[0, -1], to_np(zl)[0, -1]

    for start in range(0, 64, CHUNK):
        a, b, z = step(toks[start:start + CHUNK], np.arange(start, start + CHUNK, dtype=np.int32))
        assert nmse(a, b) <= 1e-10 and nmse(a, z) <= 1e-10, start
    tok = int(np.argmax(b))
    for p in range(64, 200):
        a, b, z = step(np.array([tok], np.int32), np.array([p], np.int32))
        assert nmse(a, b) <= 1e-10 and nmse(a, z) <= 1e-10, p
        tok = int(np.argmax(b))


def test_trash_rows_stay_isolated(models):
    """Row 1 at the horizon writes a windowed layer's trash [ring, ring +
    chunk) while row 0 decodes: row 1's ring slots keep their bits, row 0's
    logits equal a one-row run's and zllm's."""
    import jax.numpy as jnp

    from zllm.models.llama import forward as zforward
    from zllm.runtime.kvcache import KVCacheSWA as ZSWA
    from zllm_torch.models.llama import forward
    from zllm_torch.runtime.kvcache import KVCacheSWA

    zm, tm = models["gemma2"]
    max_len, chunk = 128, 64
    toks = np.random.default_rng(1).integers(3, 290, (2, chunk)).astype(np.int32)
    pos = np.broadcast_to(np.arange(chunk, dtype=np.int32), (2, chunk)).copy()
    t2 = np.array([[9], [7]], np.int32)
    p2 = np.array([[chunk], [max_len]], np.int32)
    ring = KVCacheSWA.create_swa(tm.cfg, 2, max_len, chunk, torch.float32, "cpu")
    forward(tm.params, tm.cfg, torch.from_numpy(toks), torch.from_numpy(pos), ring)
    live = [k[1, :, :ring.ring].clone() for k in ring.k]
    trash = [k[1, :, ring.ring:].clone() for k in ring.k]
    got = to_np(forward(tm.params, tm.cfg, torch.from_numpy(t2), torch.from_numpy(p2), ring,
                        logits_for="last"))[0]
    for il in range(tm.cfg.n_layers):
        assert torch.equal(ring.k[il][1, :, :ring.ring], live[il]), il
        if ring.ring_size(il):
            assert not torch.equal(ring.k[il][1, :, ring.ring:], trash[il]), il
    one = KVCacheSWA.create_swa(tm.cfg, 1, max_len, chunk, torch.float32, "cpu")
    forward(tm.params, tm.cfg, torch.from_numpy(toks[:1]), torch.from_numpy(pos[:1]), one)
    alone = to_np(forward(tm.params, tm.cfg, torch.from_numpy(t2[:1]), torch.from_numpy(p2[:1]),
                          one, logits_for="last"))[0]
    zring = ZSWA.create_swa(zm.cfg, 2, max_len, chunk, jnp.float32)
    _, zring = zforward(zm.params, zm.cfg, jnp.asarray(toks), jnp.asarray(pos), zring)
    zl, _ = zforward(zm.params, zm.cfg, jnp.asarray(t2), jnp.asarray(p2), zring,
                     logits_for="last")
    assert nmse(got, alone) <= 1e-12
    assert nmse(got, to_np(zl)[0]) <= 1e-10


def _toks(r, n):
    return [int(x) for x in r.integers(3, 290, size=n)]


def _script(engine, make_request, seed):
    """Prompts past the window, two at once, then one whose first 50 ids
    an idle slot holds (the ring reuses 48, chunk-aligned; the contiguous
    stripe 50; paged none, no whole 128-slot page); each case's
    (out_tokens, finish_reason, n_prompt_reused, error) and counter
    deltas."""
    r = np.random.default_rng(seed)
    out = []

    def run(waves):
        before = dict(engine.metrics)
        got = []
        for wave in waves:
            reqs = engine.run_in_loop(lambda: [engine.submit(make_request(**kw)) for kw in wave])
            deadline = time.time() + 300
            while not all(q.done for q in reqs):
                assert time.time() < deadline, "engine timed out"
                time.sleep(0.005)
            got += [(list(q.out_tokens), q.finish_reason, q.n_prompt_reused, q.error)
                    for q in reqs]
        out.append((got, {k: engine.metrics[k] - before[k] for k in COUNTERS}))

    run([[dict(prompt_tokens=_toks(r, 45), max_new=24)]])
    run([[dict(prompt_tokens=_toks(r, n), max_new=20) for n in (37, 70)]])
    prompt = _toks(r, 60)
    run([[dict(prompt_tokens=prompt, max_new=4)],
         [dict(prompt_tokens=prompt[:50] + [7, 9], max_new=6)]])
    return out


# layout -> (zllm engine keywords, the port's, the port's cache type)
LAYOUTS = {"ring": ({}, {}, "KVCacheSWA"),
           "contiguous_shift": ({"context_shift": True}, {"context_shift": True}, "KVCache"),
           "paged": ({"kv_layout": "paged"}, {"kv_layout": "paged"}, "PagedKVCache")}


@pytest.fixture(scope="module")
def engine_runs(models):
    import jax.numpy as jnp

    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.server.engine import Engine, Request

    out = {}
    common = dict(n_slots=2, max_len=128, prefill_chunk=CHUNK)
    for name, (zm, tm) in models.items():
        for layout, (zkw, tkw, cache) in LAYOUTS.items():
            for side, make, req in (
                    ("zllm", lambda: ZEngine(zm, kv_dtype=jnp.float32, **zkw, **common),
                     lambda **kw: ZRequest(temp=0.0, **kw)),
                    ("port", lambda: Engine(tm, kv_dtype=torch.float32, **tkw, **common),
                     lambda **kw: Request(temp=0.0, **kw))):
                eng = make()
                if side == "port":
                    assert type(eng.kv).__name__ == cache, (layout, type(eng.kv))
                    assert eng.context_shift == (layout != "ring")  # the ring shifts nothing
                eng.start()
                try:
                    out[(name, layout, side)] = _script(eng, req, 7)
                finally:
                    eng.stop()
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", ["gemma2", "gemma3"])
def test_engine_matches_zllm(engine_runs, name, layout):
    zgot = engine_runs[(name, layout, "zllm")]
    tgot = engine_runs[(name, layout, "port")]
    for (tg, tc), (zg, zc) in zip(tgot, zgot):
        assert all(err == "" for *_, err in tg), tg
        assert tg == zg
        assert tc == zc
    assert [len(t[0]) for t in tgot[1][0]] == [20, 20]
    reused = tgot[2][0][1][2]
    assert reused == (48 if layout == "ring" else 50 if layout == "contiguous_shift" else 0)


def test_windowed_model_refuses_q8_and_lookahead_with_zllms_messages(models):
    from zllm.server.engine import Engine as ZEngine
    from zllm_torch.server.engine import Engine

    zm, tm = models["gemma2"]
    for kw in (dict(kv_dtype="q8"), dict(lookahead=True)):
        with pytest.raises(ValueError) as zerr:
            ZEngine(zm, n_slots=1, max_len=128, **kw)
        with pytest.raises(ValueError) as terr:
            Engine(tm, n_slots=1, max_len=128, **kw)
        assert str(terr.value) == str(zerr.value), kw


def test_ring_cache_has_no_state_file(models, tmp_path):
    from zllm_torch.runtime import state
    from zllm_torch.server.engine import Engine

    _, tm = models["gemma2"]
    eng = Engine(tm, n_slots=1, max_len=128, prefill_chunk=CHUNK)
    with pytest.raises(ValueError, match="ring cache"):
        state.seq_get(tm, eng.kv, 0, 4)
    with pytest.raises(ValueError, match="ring cache"):
        state.save_session(str(tmp_path / "s.bin"), tm, eng.kv, [1, 2], 2)


def test_server_serves_a_gemma2_file(files):
    got = serve_and_read_metrics([files["gemma2"]], {}, "A prompt that runs past the window "
                                 "of thirty-two tokens, and then some.")
    assert got["tokens_generated_total"] >= 1 and got["engine_errors_total"] == 0
