"""The f16 KV cache: the plain versions of K2, K6, K8, K9 and K10 with f16
K/V against zllm's Pallas kernels run with interpret=True on the same
inputs, the f16 slices (Generator: llama, and OLMo-2, whose decode steps
take K8) and the f16 engines (paged and contiguous; OLMo-2 contiguous)
against zllm's, and the server's `--kv-type f16`, on the CPU.

Each kernel case runs with an f32 and a bf16 q (the kernels' two query
dtypes), at head_dim 64 and 128, and in a "wide" variant whose scores span
more than 17 nats, so that some probabilities rounded to f16 are f16
subnormals (under 2^-14) or round to 0: zllm rounds them in XLA's f16
conversion, which keeps subnormals on the CPU (checked below), and the
plain versions round them with torch's, which keeps them too.

Tolerances: kernel outputs nmse <= 1e-6 (the two sides differ in f32 sum
order and an ulp of exp, which can move one f16 rounding of a
probability: 2^-11 of one term); the caches and pools after an insert
equal zllm's bit for bit, but K2's roped k row, which may sit one f16 ulp
away (zllm ropes by a [D, D] rotation matmul, the port by a cos/sin
table).  The slice: nmse <= 1e-3 a step (measured <= 2.2e-4: the W4A8
path's per-32 int8 activation rounding sets the floor, as for bf16) and
equal greedy tokens; the OLMo-2 slice the same bound (zllm's CPU path
does not round its probabilities to f16, the port's K8 does, as zllm's
Pallas K8 does).  The engines: equal tokens, reuse and counters."""

import numpy as np
import pytest
import torch
from test_torch_engine_contiguous import _script as engine_script
from test_torch_oracle import SMALL_LLAMA, nmse, to_np
from test_torch_slice import N_DECODE, _port_run, _zllm_run

from zllm.gguf.constants import GGMLType
from zllm_torch.ops import attention as ta
from zllm_torch.ops import layers as tl

TOL = 1e-6
SCALE = 0.125
QDTYPES = {"q_f32": torch.float32, "q_bf16": torch.bfloat16}


def _q(rng, shape, qname, amp):
    """q as f32 numpy values (bf16-representable for a bf16 q) and its
    port and zllm forms."""
    import jax.numpy as jnp

    x = torch.from_numpy((rng.standard_normal(shape) * amp).astype(np.float32))
    tq = x.to(QDTYPES[qname])
    zq = jnp.asarray(to_np(tq)).astype(jnp.bfloat16 if qname == "q_bf16" else jnp.float32)
    return tq, zq


def _f16(rng, shape):
    """f16 K/V values: numpy float16, the port's tensor and zllm's array."""
    import jax.numpy as jnp

    x = rng.standard_normal(shape).astype(np.float16)
    return torch.from_numpy(x.copy()), jnp.asarray(x)


def _span(q, k, scale):
    """The widest spread of one query row's scores over all slots, in nats
    (q [.., Hq, D] f32 rows, k [Hkv, S, D])."""
    qf = q.reshape(-1, q.shape[-1]).astype(np.float64)
    s = qf @ k.reshape(-1, k.shape[-1]).astype(np.float64).T * scale
    return float((s.max(axis=1) - s.min(axis=1)).max())


def test_xla_cpu_f16_conversion_keeps_subnormals():
    """The reference rounds probabilities to f16 with XLA's CPU conversion:
    subnormal f16 results survive it, jitted or not, as they do in torch
    and numpy (unlike MXFP4's dequant, where XLA's CPU path flushes f32
    subnormal products)."""
    import jax
    import jax.numpy as jnp

    x = np.array([3e-5, 1e-6, 6e-8, 2.0 ** -20, 1e-3], np.float32)
    want = x.astype(np.float16)
    assert (want[:4] < 2.0 ** -14).all() and (want != 0).all()
    cast = jax.jit(lambda a: (a * 1.0).astype(jnp.float16))
    for got in (np.asarray(cast(jnp.asarray(x))), np.asarray(jnp.asarray(x).astype(jnp.float16)),
                torch.from_numpy(x).to(torch.float16).numpy()):
        np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize("wide", [False, True], ids=["normal", "wide"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("qname", list(QDTYPES))
def test_k2_plain_f16_cache_matches_pallas(qname, d, wide):
    """K2 over an f16 cache (rows at 37 and 300, a window in one case):
    the roped q and the probabilities rounded to f16, the new rows
    inserted in f16.  S is a multiple of 256: in interpret mode zllm's
    kernel writes a row in the last 256-slot block of a shorter S at pos -
    (256 - S % 256) (ROADMAP queue 3)."""
    import jax.numpy as jnp

    from zllm.ops.attention import attn_decode_qkv
    from zllm.ops.layers import RopeParams as ZRope
    from zllm.ops.layers import rope_rot_matrix

    b, hq, hkv, s = 2, 8, 2, 512
    rng = np.random.default_rng(d + 2 * wide + (qname == "q_bf16"))
    tq, zq = _q(rng, (b, hq + 2 * hkv, d), qname, 6.0 if wide else 1.0)
    tk, zk = _f16(rng, (b, hkv, s, d))
    tv, zv = _f16(rng, (b, hkv, s, d))
    pos = np.array([[37], [300]], np.int32)
    window = 200 if wide else 0
    kw = dict(dim=d, style="neox", base=10000.0)
    want, kz, vz = attn_decode_qkv(zq, zk, zv, jnp.asarray(pos),
                                   rope_rot_matrix(jnp.asarray(pos[:, 0]), ZRope(**kw), d),
                                   None, None, scale=SCALE, window=window, interpret=True)
    pt = torch.from_numpy(pos[:, 0])
    rope = tl.rope_table(pt, tl.RopeParams(**kw), d)
    got = ta.attn_decode_qkv(tq, tk, tv, pt, rope, scale=SCALE, window=window)
    assert got.dtype == tq.dtype and got.shape == (b, 1, hq, d)
    assert nmse(to_np(got), to_np(want)) <= TOL
    if wide:
        assert _span(to_np(tq)[1, :hq], to_np(tk)[1], SCALE) > 17
    # the insert: v equals zllm's and v_new in f16; k is the roped row in
    # f16, within one f16 ulp of zllm's
    kz, vz = np.asarray(kz).view(np.uint16), np.asarray(vz).view(np.uint16)
    rows = np.arange(b)
    np.testing.assert_array_equal(tv.numpy().view(np.uint16), vz)
    np.testing.assert_array_equal(tv.numpy()[rows, :, pos[:, 0]],
                                  to_np(tq)[:, hq + hkv:].astype(np.float16))
    knew = tl.rope_apply_table(tq[:, hq:hq + hkv].float(), rope).to(torch.float16)
    np.testing.assert_array_equal(tk.numpy()[rows, :, pos[:, 0]], knew.numpy())
    others = np.ones(s, bool)
    others[[37, 300]] = False
    np.testing.assert_array_equal(tk.numpy().view(np.uint16)[:, :, others], kz[:, :, others])
    np.testing.assert_allclose(tk.numpy()[rows, :, pos[:, 0]].astype(np.float32),
                               kz.view(np.float16)[rows, :, pos[:, 0]].astype(np.float32),
                               rtol=2.0 ** -10, atol=2.0 ** -24)


@pytest.mark.parametrize("wide", [False, True], ids=["normal", "wide"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("qname", list(QDTYPES))
def test_k6_plain_f16_cache_matches_pallas(qname, d, wide):
    """K6 over f16 K/V: a 16-token chunk from 100 (GQA 4), p normalized,
    then rounded to f16."""
    from zllm.ops.attention import flash_attention

    t, s, hq, hkv = 16, 256, 8, 2
    rng = np.random.default_rng(10 + d + 2 * wide + (qname == "q_bf16"))
    tq, zq = _q(rng, (1, t, hq, d), qname, 6.0 if wide else 1.0)
    tk, zk = _f16(rng, (1, hkv, s, d))
    tv, zv = _f16(rng, (1, hkv, s, d))
    positions = np.arange(100, 100 + t, dtype=np.int32)[None]
    import jax.numpy as jnp

    want = flash_attention(zq, zk, zv, jnp.asarray(positions), scale=SCALE, interpret=True)
    got = ta.flash_attention(tq, tk, tv, torch.from_numpy(positions), scale=SCALE)
    assert got.dtype == tq.dtype and got.shape == (1, t, hq, d)
    assert nmse(to_np(got), to_np(want)) <= TOL
    if wide:
        assert _span(to_np(tq)[0], to_np(tk)[0], SCALE) > 17


@pytest.mark.parametrize("wide", [False, True], ids=["normal", "wide"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("qname", list(QDTYPES))
def test_k8_plain_f16_cache_matches_pallas(qname, d, wide):
    """K8 over an f16 cache (rows at 37 and 300, GQA 4; a window and a
    trash row, pos == S, in the wide case): the unrounded q, the new rows
    inserted in f16 at min(pos, S - 1), p normalized, then rounded to f16;
    the caches after it equal zllm's bit for bit."""
    import jax.numpy as jnp

    from zllm.ops.attention import attn_decode_update as zk8

    b, hq, hkv, s = 2, 8, 2, 512
    rng = np.random.default_rng(40 + d + 2 * wide + (qname == "q_bf16"))
    tq, zq = _q(rng, (b, 1, hq, d), qname, 6.0 if wide else 1.0)
    tkn, zkn = _q(rng, (b, 1, hkv, d), qname, 1.0)
    tvn, zvn = _q(rng, (b, 1, hkv, d), qname, 1.0)
    tk, zk = _f16(rng, (b, hkv, s, d))
    tv, zv = _f16(rng, (b, hkv, s, d))
    pos = np.array([[37], [s if wide else 300]], np.int32)
    window = 200 if wide else 0
    want, kz, vz = zk8(zq, zkn, zvn, zk, zv, jnp.asarray(pos), scale=SCALE, window=window,
                       interpret=True)
    got = ta.attn_decode_update(tq, tkn, tvn, tk, tv, torch.from_numpy(pos), scale=SCALE,
                                window=window)
    assert got.dtype == tq.dtype and got.shape == (b, 1, hq, d)
    assert nmse(to_np(got), to_np(want)) <= TOL
    np.testing.assert_array_equal(tk.numpy().view(np.uint16), np.asarray(kz).view(np.uint16))
    np.testing.assert_array_equal(tv.numpy().view(np.uint16), np.asarray(vz).view(np.uint16))
    if wide:
        assert _span(to_np(tq)[1, 0], to_np(tk)[1], SCALE) > 17


def _pools_f16(rng, b, d, lp, ps):
    """f16 pools in zllm's layout [Hkv, D, P * ps] and the port's, and a
    scrambled table [b, lp + 1] (the last column the trash pin)."""
    import jax.numpy as jnp

    from zllm.runtime.paged import PagedKVCache as ZPaged

    z = ZPaged.create(1, b, lp * ps, 2, d, jnp.float16, page_size=ps)
    tbl = np.asarray(z.table).copy()
    tbl[:, :lp] = tbl[:, :lp][:, ::-1]
    kz = rng.standard_normal(z.k[0].shape).astype(np.float16)
    vz = rng.standard_normal(z.v[0].shape).astype(np.float16)

    def port(x):
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))

    return jnp.asarray(kz), jnp.asarray(vz), port(kz), port(vz), tbl


@pytest.mark.parametrize("wide", [False, True], ids=["normal", "wide"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("qname", list(QDTYPES))
def test_k10_plain_f16_pools_match_pallas(qname, d, wide):
    """K10 over f16 pools: a 16-token chunk from 300 (mid-page, across a
    page), one from 120 and the trash row; exp(s - running max) rounded to
    f16 a page."""
    import jax.numpy as jnp

    from zllm.ops.attention import paged_attention as zpa

    ps, lp = 128, 4
    rng = np.random.default_rng(20 + d + 2 * wide + (qname == "q_bf16"))
    kz, vz, kp, vp, tbl = _pools_f16(rng, 3, d, lp, ps)
    t = 16
    pos = np.stack([np.arange(p, p + t) for p in (300, 120, lp * ps)]).astype(np.int32)
    tq, zq = _q(rng, (3, t, 8, d), qname, 6.0 if wide else 1.0)
    want = zpa(zq, kz, vz, jnp.asarray(tbl), jnp.asarray(pos), page_size=ps, scale=SCALE,
               interpret=True)
    got = ta.paged_attention(tq, kp, vp, torch.from_numpy(tbl), torch.from_numpy(pos),
                             page_size=ps, scale=SCALE)
    assert got.dtype == tq.dtype and got.shape == (3, t, 8, d)
    assert nmse(to_np(got)[:2], to_np(want)[:2]) <= TOL
    if wide:
        assert _span(to_np(tq)[0], to_np(kp).reshape(2, -1, d), SCALE) > 17


@pytest.mark.parametrize("wide", [False, True], ids=["normal", "wide"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("qname", list(QDTYPES))
def test_k9_plain_f16_pools_match_pallas(qname, d, wide):
    """K9 over f16 pools: rows at 255 (a page edge) and 300, the new rows
    inserted in f16; the pools after it equal zllm's outside the trash
    page."""
    import jax.numpy as jnp

    from zllm.ops.attention import paged_attn_decode_update as zpd

    ps, lp = 128, 4
    rng = np.random.default_rng(30 + d + 2 * wide + (qname == "q_bf16"))
    kz, vz, kp, vp, tbl = _pools_f16(rng, 2, d, lp, ps)
    positions = np.array([[255], [300]], np.int32)
    tq, zq = _q(rng, (2, 1, 8, d), qname, 6.0 if wide else 1.0)
    tkn, zkn = _q(rng, (2, 1, 2, d), qname, 1.0)
    tvn, zvn = _q(rng, (2, 1, 2, d), qname, 1.0)
    att_z, kp_z, vp_z = zpd(zq, zkn, zvn, kz, vz, jnp.asarray(tbl), jnp.asarray(positions),
                            page_size=ps, scale=SCALE, interpret=True)
    att = ta.paged_attn_decode_update(tq, tkn, tvn, kp, vp, torch.from_numpy(tbl),
                                      torch.from_numpy(positions), page_size=ps, scale=SCALE)
    assert att.dtype == tq.dtype and att.shape == (2, 1, 8, d)
    assert nmse(to_np(att), to_np(att_z)) <= TOL
    for got, want in ((kp, kp_z), (vp, vp_z)):
        np.testing.assert_array_equal(got.numpy().view(np.uint16)[:, ps:],
                                      np.asarray(want).transpose(0, 2, 1).view(np.uint16)[:, ps:])
    if wide:
        assert _span(to_np(tq)[1, 0], to_np(kp), SCALE) > 17


# ---- the slice and the engines -----------------------------------------------

@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    path = str(tmp_path_factory.mktemp("f16kv") / "slice.gguf")
    make_llama_gguf(path, **SMALL_LLAMA, with_tokenizer=True)
    return path


def test_f16_slice_matches_zllm(gguf):
    """Generator(kv_dtype=float16): a two-chunk prefill and 8 greedy steps
    through the plain K2/K6 over the f16 cache, against zllm's Generator
    with an f16 cache and its Pallas matmuls in interpret mode."""
    import jax.numpy as jnp

    zlog, ztoks = _zllm_run(gguf, jnp.float16)
    tlog, ttoks = _port_run(gguf, torch.float16)
    assert len(tlog) == len(zlog) == N_DECODE + 1
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (SMALL_LLAMA["vocab_size"],)
        assert nmse(a, b) <= 1e-3, f"step {step}: nmse {nmse(a, b)}"
    assert ttoks == ztoks


@pytest.fixture(scope="module")
def olmo2_ggufs(tmp_path_factory):
    """2-layer OLMo-2 files (4 query heads over 2 kv heads), Q4_K and F32."""
    from zllm_torch.gguf.constants import GGMLType as TGGMLType
    from zllm_torch.testing import make_llama_gguf

    folder = tmp_path_factory.mktemp("olmo2f16")
    return {name: make_llama_gguf(str(folder / f"{name}.gguf"), arch="olmo2",
                                  **dict(SMALL_LLAMA, gtype=gtype), norm_eps=1e-6,
                                  rope_base=500000.0, with_tokenizer=True)
            for name, gtype in (("Q4_K", TGGMLType.Q4_K), ("F32", TGGMLType.F32))}


def test_olmo2_f16_slice_matches_zllm(olmo2_ggufs, monkeypatch):
    """Generator(kv_dtype=float16) on an OLMo-2 file: every decode step and
    column 0 of every chunk through K8's plain version over the f16 cache
    (two layers a call), against zllm's Generator with an f16 cache."""
    import jax.numpy as jnp

    from zllm_torch.models import llama as tllama

    calls = []
    real = tllama.attn_decode_update

    def spy(q, k_new, v_new, kc, vc, *a, **kw):
        calls.append(kc.dtype)
        return real(q, k_new, v_new, kc, vc, *a, **kw)

    monkeypatch.setattr(tllama, "attn_decode_update", spy)  # the name the forward calls
    zlog, ztoks = _zllm_run(olmo2_ggufs["Q4_K"], jnp.float16)
    tlog, ttoks = _port_run(olmo2_ggufs["Q4_K"], torch.float16)
    assert len(tlog) == len(zlog) == N_DECODE + 1
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (SMALL_LLAMA["vocab_size"],)
        assert nmse(a, b) <= 1e-3, f"step {step}: nmse {nmse(a, b)}"
    assert ttoks == ztoks
    assert calls and set(calls) == {torch.float16}


def test_olmo2_contiguous_f16_engine_matches_zllm(olmo2_ggufs):
    """The OLMo-2 engine over the contiguous f16 cache (K8 at every decode
    step and on column 0 of every mixed step; f32 weights, 2 slots, chunk
    16) against zllm's Engine(kv_dtype=float16, kv_layout="contiguous")."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.kvcache import KVCache
    from zllm_torch.server.engine import Engine, Request

    path = olmo2_ggufs["F32"]
    out = {}
    for side, make_engine, make_request in (
            ("zllm", lambda: ZEngine(ZModel.load(path, dtype=jnp.float32), n_slots=2, max_len=128,
                                     prefill_chunk=16, kv_dtype=jnp.float16,
                                     kv_layout="contiguous"),
             lambda **kw: ZRequest(temp=0.0, **kw)),
            ("port", lambda: Engine(Model.load(path, device="cpu", dtype=torch.float32),
                                    n_slots=2, max_len=128, prefill_chunk=16,
                                    kv_dtype=torch.float16, kv_layout="contiguous"),
             lambda **kw: Request(temp=0.0, **kw))):
        eng = make_engine()
        if side == "port":
            assert not eng.paged and type(eng.kv) is KVCache and eng.kv.dtype == torch.float16
        eng.start()
        try:
            out[side] = engine_script(eng, make_request, 128)
        finally:
            eng.stop()
    for case, (zgot, zcount) in out["zllm"].items():
        tgot, tcount = out["port"][case]
        assert all(err == "" for *_, err in tgot), tgot
        assert tgot == zgot, case
        assert tcount == zcount, case
    assert out["port"]["prefix_reuse"][1]["tokens_prefix_reused_total"] == 30


@pytest.fixture(scope="module")
def f32_gguf(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    path = str(tmp_path_factory.mktemp("f16eng") / "f32.gguf")
    return make_llama_gguf(path, **dict(SMALL_LLAMA, gtype=GGMLType.F32), with_tokenizer=True)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_f16_engine_matches_zllm(f32_gguf, layout):
    """The engine over an f16 cache (f32 weights, 2 slots, chunk 16) on
    both layouts, against zllm's Engine(kv_dtype=float16) on the same
    layout: one prompt, two concurrent prompts, a prefix re-sent."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request

    sides = {"zllm": (lambda **kw: ZEngine(ZModel.load(f32_gguf, dtype=jnp.float32),
                                           kv_dtype=jnp.float16, kv_layout=layout, **kw),
                      lambda **kw: ZRequest(temp=0.0, **kw)),
             "port": (lambda **kw: Engine(Model.load(f32_gguf, device="cpu",
                                                     dtype=torch.float32),
                                          kv_dtype=torch.float16, kv_layout=layout, **kw),
                      lambda **kw: Request(temp=0.0, **kw))}
    out = {}
    for side, (make_engine, make_request) in sides.items():
        eng = make_engine(n_slots=2, max_len=128, prefill_chunk=16)
        if side == "port":
            assert eng.paged == (layout == "paged") and eng.kv.k[0].dtype == torch.float16
        eng.start()
        try:
            out[side] = engine_script(eng, make_request, 128)
        finally:
            eng.stop()
    for case, (zgot, zcount) in out["zllm"].items():
        tgot, tcount = out["port"][case]
        assert all(err == "" for *_, err in tgot), tgot
        assert tgot == zgot, case
        assert tcount == zcount, case
    if layout == "contiguous":  # the idle slot's own 30 tokens (paged: no full page)
        assert out["port"]["prefix_reuse"][1]["tokens_prefix_reused_total"] == 30


def test_server_main_takes_kv_type_f16(gguf, monkeypatch):
    """`python -m zllm_torch.server M.gguf --kv-type f16` serves from f16
    pages; with `--kv-layout contiguous` from an f16 stripe."""
    from zllm_torch.runtime.kvcache import KVCache
    from zllm_torch.runtime.paged import PagedKVCache
    from zllm_torch.server import __main__ as server_main
    from zllm_torch.server.http import ZllmServer

    assert server_main.KV_TYPES["f16"] == torch.float16
    made = []
    monkeypatch.setattr(ZllmServer, "serve_forever", lambda self: made.append(self))
    server_main.main([gguf, "--kv-type", "f16", "--device", "cpu", "--port", "0"])
    server_main.main([gguf, "--kv-type", "f16", "--kv-layout", "contiguous", "--device", "cpu",
                      "--port", "0"])
    assert type(made[0].engine.kv) is PagedKVCache and made[0].engine.paged
    assert made[0].engine.kv.k[0].dtype == torch.float16
    assert type(made[1].engine.kv) is KVCache and made[1].engine.kv.dtype == torch.float16


def test_server_main_serves_olmo2_over_a_contiguous_f16_cache(olmo2_ggufs, monkeypatch):
    """`--kv-type f16 --kv-layout contiguous` with an OLMo-2 file: served
    (K8's f16 form), no longer refused."""
    from zllm_torch.runtime.kvcache import KVCache
    from zllm_torch.server import __main__ as server_main
    from zllm_torch.server.http import ZllmServer

    made = []
    monkeypatch.setattr(ZllmServer, "serve_forever", lambda self: made.append(self))
    server_main.main([olmo2_ggufs["Q4_K"], "--kv-type", "f16", "--kv-layout", "contiguous",
                      "--device", "cpu", "--port", "0"])
    eng = made[0].engine
    assert eng.model.cfg.arch == "olmo2" and type(eng.kv) is KVCache
    assert eng.kv.dtype == torch.float16
