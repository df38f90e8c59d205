"""The port's session and slot state files (zllm_torch.runtime.state) against
zllm's (zllm.runtime.state), on the CPU.

The six cache kinds the port serves from (contiguous bf16, f32 and f16,
paged bf16 and f16, q8) are filled with the same seeded values on both
sides (2 layers, 2 slots, 2 kv heads of 16, 64 positions; paged: 16-token
pages under a shuffled table).  A slot file written by either package must
load in the other: bf16/f16/f32 K/V restore bit for bit, a q8 slot (saved
as zllm's bf16 product codes * scales) requantizes to zllm's codes and
scales exactly.  Then the round trips of tests/test_state.py on the port's
own Generator and forward, the refusals of another model's files, and the
engine's paged restore, which owns every page it writes."""

import json
import time
import types

import numpy as np
import pytest
import torch
from test_torch_oracle import SMALL_LLAMA

from zllm.gguf.constants import GGMLType

L, B, HKV, D, S, PS = 2, 2, 2, 16, 64, 16
N_PAST = 37
KINDS = ("bf16", "f32", "f16", "paged_bf16", "paged_f16", "q8")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}


def _model(**over):
    cfg = dict(arch="llama", n_layers=L, n_kv_heads=HKV, head_dim=D)
    cfg.update(over)
    return types.SimpleNamespace(cfg=types.SimpleNamespace(**cfg))


def _jnp(t: torch.Tensor):
    """A torch tensor as a jax array of the same bits."""
    import jax.numpy as jnp
    import ml_dtypes

    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _bits(x) -> np.ndarray:
    """A torch tensor or jax array as comparable numpy bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if str(a.dtype) == "bfloat16" else a


def _caches(kind: str, seed: int, zero: bool = False):
    """(port cache, zllm cache) of one kind holding the same values."""
    import jax.numpy as jnp

    from zllm.runtime import kvcache as zkv
    from zllm.runtime import paged as zpaged
    from zllm_torch.runtime.kvcache import KVCache, KVCacheQ8
    from zllm_torch.runtime.paged import PagedKVCache

    g = torch.Generator().manual_seed(seed)

    def rnd(shape, dtype):
        x = torch.randn(shape, generator=g)
        return torch.zeros(shape, dtype=dtype) if zero else x.to(dtype)

    if kind == "q8":
        shape = (B, HKV, S, D)

        def codes():
            return (torch.zeros(shape, dtype=torch.int8) if zero else
                    torch.randint(-127, 128, shape, generator=g, dtype=torch.int8))

        def scales():
            return (torch.ones(shape[:3] + (1,)) if zero else
                    torch.rand(shape[:3] + (1,), generator=g) * 0.05 + 1e-3)

        k = [codes() for _ in range(L)]
        v = [codes() for _ in range(L)]
        ks = [scales() for _ in range(L)]
        vs = [scales() for _ in range(L)]
        port = KVCacheQ8(k=k, v=v, ks=ks, vs=vs)
        z = zkv.KVCacheQ8(k=tuple(_jnp(x) for x in k), v=tuple(_jnp(x) for x in v),
                          ks=tuple(_jnp(x) for x in ks), vs=tuple(_jnp(x) for x in vs))
        return port, z
    if kind.startswith("paged"):
        dtype = DTYPES[kind.split("_")[1]]
        lp = S // PS
        n_pages = B * lp + 1
        perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
        table = np.zeros((B, lp + 1), np.int32)
        table[:, :lp] = perm.reshape(B, lp)
        k = [rnd((HKV, n_pages * PS, D), dtype) for _ in range(L)]
        v = [rnd((HKV, n_pages * PS, D), dtype) for _ in range(L)]
        port = PagedKVCache(k=k, v=v, table=torch.from_numpy(table), page_size=PS, horizon=S)
        z = zpaged.PagedKVCache(k=tuple(_jnp(x.transpose(1, 2).contiguous()) for x in k),
                                v=tuple(_jnp(x.transpose(1, 2).contiguous()) for x in v),
                                table=jnp.asarray(table), page_size=PS, horizon=S)
        return port, z
    dtype = DTYPES[kind]
    k = [rnd((B, HKV, S, D), dtype) for _ in range(L)]
    v = [rnd((B, HKV, S, D), dtype) for _ in range(L)]
    return KVCache(k=k, v=v), zkv.KVCache(k=tuple(_jnp(x) for x in k),
                                          v=tuple(_jnp(x) for x in v))


def _slot(cache, seq: int, n: int) -> dict:
    """One slot's stored arrays [L, Hkv, n, D] (q8: codes and scales) as
    numpy bits, from either package's cache."""
    if hasattr(cache, "ks"):
        return {name: np.stack([_bits(x)[seq, :, :n] for x in getattr(cache, name)])
                for name in ("k", "v", "ks", "vs")}
    if hasattr(cache, "page_size"):
        rows = [cache.gather_row(il, seq, n) for il in range(L)]
        return {"k": np.stack([_bits(r[0]) for r in rows]),
                "v": np.stack([_bits(r[1]) for r in rows])}
    return {name: np.stack([_bits(x)[seq, :, :n] for x in getattr(cache, name)])
            for name in ("k", "v")}


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_slot_file_arrays_equal_zllms(kind, tmp_path):
    """The same slot saved by each package: the same meta and the same
    k/v arrays, dtype and bits."""
    from zllm.runtime import state as zstate
    from zllm_torch.runtime import state

    port, z = _caches(kind, seed=1)
    state.seq_save_file(str(tmp_path / "port.bin"), _model(), port, 0, N_PAST)
    zstate.seq_save_file(str(tmp_path / "zllm.bin"), _model(), z, 0, N_PAST)
    a, b = np.load(tmp_path / "port.bin"), np.load(tmp_path / "zllm.bin")
    assert json.loads(str(a["meta"])) == json.loads(str(b["meta"]))
    assert sorted(a.files) == sorted(b.files)
    for name in ("k", "v"):
        assert a[name].dtype == b[name].dtype and a[name].shape == (L, HKV, N_PAST, D)
        np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("kind", KINDS)
def test_port_file_restores_in_zllm(kind, tmp_path):
    """A slot the port saved restores into another slot of zllm's cache as
    zllm's own file of that slot restores there."""
    from zllm.runtime import state as zstate
    from zllm_torch.runtime import state

    port, z = _caches(kind, seed=2)
    state.seq_save_file(str(tmp_path / "port.bin"), _model(), port, 0, N_PAST)
    zstate.seq_save_file(str(tmp_path / "zllm.bin"), _model(), z, 0, N_PAST)
    got, n = zstate.seq_load_file(str(tmp_path / "port.bin"), _model(), _caches(kind, 0, True)[1], 1)
    want, _ = zstate.seq_load_file(str(tmp_path / "zllm.bin"), _model(), _caches(kind, 0, True)[1], 1)
    assert n == N_PAST
    _equal(_slot(got, 1, N_PAST), _slot(want, 1, N_PAST))
    if kind != "q8":  # bf16/f16/f32: the source slot's bits
        _equal(_slot(got, 1, N_PAST), _slot(port, 0, N_PAST))


@pytest.mark.parametrize("kind", KINDS)
def test_zllm_file_restores_in_port(kind, tmp_path):
    """A slot zllm saved restores into another slot of the port's cache as
    into zllm's own (q8: the codes and scales of zllm's seq_set)."""
    from zllm.runtime import state as zstate
    from zllm_torch.runtime import state

    port, z = _caches(kind, seed=3)
    path = str(tmp_path / "zllm.bin")
    zstate.seq_save_file(path, _model(), z, 0, N_PAST)
    dst, zdst = _caches(kind, 0, True)
    got, n = state.seq_load_file(path, _model(), dst, 1)
    want, _ = zstate.seq_load_file(path, _model(), zdst, 1)
    assert n == N_PAST and got is dst
    _equal(_slot(got, 1, N_PAST), _slot(want, 1, N_PAST))
    if kind != "q8":
        _equal(_slot(got, 1, N_PAST), _slot(port, 0, N_PAST))
    # nothing but the slot's first n_past positions changed
    _equal(_slot(got, 0, S), _slot(_caches(kind, 0, True)[0], 0, S))


@pytest.mark.parametrize("src,dst", [("bf16", "q8"), ("q8", "bf16"), ("f32", "paged_bf16"),
                                     ("paged_f16", "f32"), ("q8", "paged_f16"), ("f16", "q8")])
def test_cross_kind_restore(src, dst, tmp_path):
    """A slot restores into a cache of another kind (cast, or requantized
    into q8) as zllm restores it."""
    from zllm.runtime import state as zstate
    from zllm_torch.runtime import state

    port, _ = _caches(src, seed=4)
    path = str(tmp_path / "s.bin")
    state.seq_save_file(path, _model(), port, 1, N_PAST)
    got, _ = state.seq_load_file(path, _model(), _caches(dst, 0, True)[0], 0)
    want, _ = zstate.seq_load_file(path, _model(), _caches(dst, 0, True)[1], 0)
    _equal(_slot(got, 0, N_PAST), _slot(want, 0, N_PAST))


@pytest.mark.parametrize("which", ["session", "slot"])
@pytest.mark.parametrize("key,value", [("n_layers", 99), ("n_kv_heads", 7), ("head_dim", 8),
                                       ("arch", "olmo2")])
def test_mismatched_model_is_refused(which, key, value, tmp_path):
    from zllm_torch.runtime import state
    from zllm_torch.runtime.kvcache import KVCache

    path = str(tmp_path / "s.bin")
    kv = KVCache.create(L, 1, S, HKV, D, torch.float32, "cpu")
    if which == "session":
        state.save_session(path, _model(), kv, [1, 2, 3], 3)
        with pytest.raises(ValueError, match=key):
            state.load_session(path, _model(**{key: value}), kv)
    else:
        state.seq_save_file(path, _model(), kv, 0, 3)
        with pytest.raises(ValueError, match=key):
            state.seq_load_file(path, _model(**{key: value}), kv, 0)


def test_longer_than_the_cache_and_foreign_files_are_refused(tmp_path):
    from zllm_torch.runtime import state
    from zllm_torch.runtime.kvcache import KVCache

    big = KVCache.create(L, 1, S, HKV, D, torch.float32, "cpu")
    small = KVCache.create(L, 1, 16, HKV, D, torch.float32, "cpu")
    path = str(tmp_path / "s.bin")
    state.save_session(path, _model(), big, list(range(40)), 40)
    with pytest.raises(ValueError, match="exceeds cache"):
        state.load_session(path, _model(), small)
    state.seq_save_file(path, _model(), big, 0, 40)
    with pytest.raises(ValueError, match="exceeds cache"):
        state.seq_load_file(path, _model(), small, 0)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, meta=json.dumps({"magic": "OTHER"}), k=np.zeros(1), v=np.zeros(1))
    with pytest.raises(ValueError, match="not a zllm"):
        state.seq_load_file(path, _model(), big, 0)
    meta = dict(magic=state.MAGIC, version=state.VERSION + 1, arch="llama", n_layers=L,
                n_kv_heads=HKV, head_dim=D, n_past=1, kv_dtype="float32")
    with open(path, "wb") as fh:
        np.savez_compressed(fh, meta=json.dumps(meta), tokens=np.zeros(1, np.int32),
                            k=np.zeros((L, 1, HKV, 1, D), np.float32),
                            v=np.zeros((L, 1, HKV, 1, D), np.float32))
    with pytest.raises(ValueError, match="version"):
        state.load_session(path, _model(), big)


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    path = str(tmp_path_factory.mktemp("state") / "f32.gguf")
    return make_llama_gguf(path, **dict(SMALL_LLAMA, gtype=GGMLType.F32), with_tokenizer=True)


@pytest.fixture(scope="module")
def model(gguf):
    from zllm_torch.models.loader import Model

    return Model.load(gguf, device="cpu", dtype=torch.float32)


def test_session_roundtrip_continues_as_the_original(model, gguf, tmp_path):
    """tests/test_state.py's session round trip on the port's Generator,
    and the session file crossing to zllm and back unchanged."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.runtime import state as zstate
    from zllm.runtime.kvcache import KVCache as ZKVCache
    from zllm_torch.runtime import state
    from zllm_torch.runtime.generate import Generator

    prompt = [1, 17, 42, 9, 23, 77, 5]
    gen = Generator(model, max_len=64, prefill_chunk=16, kv_dtype=torch.float32)
    first = int(torch.argmax(gen.prefill(prompt)))
    cont_a = gen.decode_steps(first, 5)
    path = str(tmp_path / "sess")  # no .npz: written to this path exactly
    n_past = len(prompt) + 5
    state.save_session(path, model, gen.kv, prompt + cont_a[:-1], n_past)

    gen2 = Generator(model, max_len=64, prefill_chunk=16, kv_dtype=torch.float32)
    _, toks, n = state.load_session(path, model, gen2.kv)
    assert toks == prompt + cont_a[:-1] and n == n_past
    gen2._cur_pos = n
    assert gen2.decode_steps(cont_a[-1], 4) == gen.decode_steps(cont_a[-1], 4)

    # zllm reads the port's session; the port reads zllm's save of it
    zm = ZModel.load(gguf, dtype=jnp.float32)
    zkv = ZKVCache.create(L, 1, 64, zm.cfg.n_kv_heads, zm.cfg.head_dim, jnp.float32)
    zkv, ztoks, zn = zstate.load_session(path, zm, zkv)
    assert ztoks == toks and zn == n_past
    for a, b in zip(zkv.k, state.load_session(path, model, Generator(
            model, max_len=64, prefill_chunk=16, kv_dtype=torch.float32).kv)[0].k):
        np.testing.assert_array_equal(np.asarray(a)[:, :, :n_past], b.numpy()[:, :, :n_past])
    zpath = str(tmp_path / "zsess.npz")
    zstate.save_session(zpath, zm, zkv, ztoks, zn)
    gen3 = Generator(model, max_len=64, prefill_chunk=16, kv_dtype=torch.float32)
    state.load_session(zpath, model, gen3.kv)
    for a, b in zip(gen3.kv.k + gen3.kv.v, gen2.kv.k + gen2.kv.v):
        np.testing.assert_array_equal(a.numpy()[:, :, :n_past], b.numpy()[:, :, :n_past])


def test_slot_migration(model, tmp_path):
    """tests/test_state.py's slot migration on the port's forward: slot 0's
    state restored into slot 1 of a fresh cache holds slot 0's K/V."""
    from zllm_torch.models.llama import forward
    from zllm_torch.runtime import state
    from zllm_torch.runtime.kvcache import KVCache

    cfg = model.cfg
    prompt = [5, 6, 7, 8]
    kv = KVCache.create(cfg.n_layers, 2, 64, cfg.n_kv_heads, cfg.head_dim, torch.bfloat16, "cpu")
    toks = torch.zeros((2, 4), dtype=torch.int32)
    toks[0] = torch.tensor(prompt)
    pos = torch.arange(4, dtype=torch.int32).expand(2, 4).contiguous()
    with torch.inference_mode():
        forward(model.params, cfg, toks, pos, kv)
    path = str(tmp_path / "seq.bin")
    state.seq_save_file(path, model, kv, 0, 4)
    kv3 = KVCache.create(cfg.n_layers, 2, 64, cfg.n_kv_heads, cfg.head_dim, torch.bfloat16, "cpu")
    _, n = state.seq_load_file(path, model, kv3, 1)
    assert n == 4
    for a, b in zip(kv.k + kv.v, kv3.k + kv3.v):
        assert torch.equal(a[0, :, :n], b[1, :, :n])
        assert not b[1, :, :n].eq(0).all()


def test_zllm_paged_restore_writes_into_shared_pages():
    """The quirk the port's engine avoids: zllm's seq_set scatters a paged
    slot through its table as it stands, so a slot that shares a page with
    another overwrites the other slot's prefix (zllm's Engine.restore_slot
    calls it without unsharing)."""
    import jax.numpy as jnp

    from zllm.runtime import state as zstate

    _, z = _caches("paged_bf16", seed=5)
    table = np.asarray(z.table).copy()
    table[1, 0] = table[0, 0]  # slot 1 maps slot 0's first page
    z = type(z)(k=z.k, v=z.v, table=jnp.asarray(table), page_size=PS, horizon=S)
    before = _slot(z, 0, PS)
    other, _ = _caches("paged_bf16", seed=6)
    st = {"meta": dict(magic="ZLLMSESS", version=1, arch="llama", n_layers=L, n_kv_heads=HKV,
                       head_dim=D, n_past=PS, kv_dtype="bfloat16"),
          "k": _slot(other, 0, PS)["k"].view(np.uint16), "v": _slot(other, 0, PS)["v"].view(np.uint16)}
    z, _ = zstate.seq_set(_model(), z, 1, st)
    assert not np.array_equal(_slot(z, 0, PS)["k"], before["k"])


def _wait(reqs):
    deadline = time.time() + 120
    while not all(r.done for r in reqs):
        assert time.time() < deadline, "engine timed out"
        time.sleep(0.005)


def test_engine_paged_restore_owns_its_pages(model, tmp_path):
    """A paged slot that shares a page with another is given pages of its
    own before a restore writes: the other slot's prefix is unchanged and
    the restored slot holds the file's K/V."""
    from zllm_torch.runtime import state
    from zllm_torch.runtime.kvcache import KVCache
    from zllm_torch.server.engine import Engine, Request, SlotState

    cfg = model.cfg
    eng = Engine(model, n_slots=2, max_len=256, prefill_chunk=16, kv_dtype=torch.float32)
    eng.start()
    try:
        r = np.random.default_rng(7)
        prefix = [int(x) for x in r.integers(3, 500, size=130)]
        first = eng.submit(Request(prompt_tokens=prefix + [5], max_new=2, temp=0.0))
        _wait([first])
        wave = eng.run_in_loop(lambda: [
            eng.submit(Request(prompt_tokens=prefix + [t], max_new=2, temp=0.0)) for t in (8, 6)])
        _wait(wave)
        assert wave[1].n_prompt_reused == 128
        assert eng.alloc.table[1, 0] == eng.alloc.table[0, 0]  # slot 1 shares slot 0's page
        before = [eng.kv.gather_row(il, 0, 128) for il in range(cfg.n_layers)]

        src = KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, torch.float32,
                             "cpu")
        g = torch.Generator().manual_seed(0)
        for x in src.k + src.v:
            x.copy_(torch.randn(x.shape, generator=g))
        path = str(tmp_path / "other.bin")
        state.seq_save_file(path, model, src, 0, 140)
        assert eng.restore_slot(1, path, tokens=list(range(140))) == {"id": 1, "n_past": 140}
        assert eng.alloc.exclusively_owned(1) and eng.alloc.exclusively_owned(0)
        for il in range(cfg.n_layers):
            k0, v0 = eng.kv.gather_row(il, 0, 128)
            assert torch.equal(k0, before[il][0]) and torch.equal(v0, before[il][1])
            k1, _ = eng.kv.gather_row(il, 1, 140)
            assert torch.equal(k1, src.k[il][0, :, :140])
        assert eng.slots[1].pos == 140 and eng.slots[1].cache_tokens == list(range(140))
        assert eng.erase_slot(1) == {"id": 1}
        assert eng.slots[1].pos == 0 and eng.slots[1].cache_tokens == []
    finally:
        eng.stop()
    # with the thread stopped, run_in_loop runs on the caller: a busy slot
    # refuses both
    eng.slots[0].state = SlotState.GENERATING
    with pytest.raises(ValueError, match="slot 0 is busy"):
        eng.restore_slot(0, path)
    with pytest.raises(ValueError, match="slot 0 is busy"):
        eng.erase_slot(0)
