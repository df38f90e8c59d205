"""A row's bits do not depend on the step it rides, on the CPU.

The serving engine's generating rows ride its mixed steps (T = chunk,
their one token in column 0, trash positions after it) and its decode
steps (T = 1).  The multi-row attention kernels (K10, K7's tensor-core
form) agree with the T=1 ones (K9, K7's split form) only to f32 rounding,
so `models/llama.py::_attend` attends column 0 of a one-token row through
the T=1 kernel in a mixed step too; over a contiguous bf16/f32 cache the
T=1 kernel is K2 for llama (K6 in the mixed step), which takes the raw
projection row, so `layer_forward` runs it after `_attend`, and K8 for
OLMo-2, which `_attend` runs.  And `rms_norm` sums its squares in f64, so
a row's norm does not depend on how many rows the reduction has.  Here:
the routing (the T=1 path's output lands in column 0 of the one-token
rows, and only there), the equality of a generating row's attention and
cache slot in the two steps through the plain versions (llama's contiguous
layout through `layer_forward`), K2's in-kernel rope against `apply_rope`,
and rms_norm's row independence.  On the card chip_smoke.py's serve phases hold concurrent
greedy texts to sequential ones, and tests/test_torch_cuda.py the logits
bit for bit."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zllm_torch.models import llama
from zllm_torch.ops.attention import attn_decode_qkv_plain
from zllm_torch.ops.layers import RopeParams, apply_rope, rms_norm, rope_table
from zllm_torch.runtime.kvcache import KVCache, KVCacheQ8
from zllm_torch.runtime.paged import PagedKVCache

B, HQ, HKV, D, T = 3, 4, 2, 16, 8
MAX_LEN, PAGE = 64, 16
SCALE = D ** -0.5
ROPE = RopeParams(dim=D)
# all that `_attend` and the llama attention block of `layer_forward` read
# of the config
CFG = SimpleNamespace(attn_logit_softcap=0.0, arch="llama", attn_scale=None, head_dim=D,
                      q_dim=HQ * D, kv_dim=HKV * D, rope=ROPE, norm_eps=1e-5)
OLMO2 = SimpleNamespace(**{**vars(CFG), "arch": "olmo2"})


def _rand(*shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _steps(trash: int):
    """(decode positions [B, 1], mixed positions [B, T], the generating rows):
    rows 0 and 2 generate at 37 and 20, row 1 prefills 8 tokens from 24 in
    the mixed step and idles (trash) in the decode step."""
    dec = torch.tensor([[37], [trash], [20]], dtype=torch.int32)
    mix = torch.full((B, T), trash, dtype=torch.int32)
    mix[0, 0], mix[2, 0] = 37, 20
    mix[1] = torch.arange(24, 24 + T, dtype=torch.int32)
    return dec, mix, [0, 2]


def _qkv(dec_seed, mix_seed, gen):
    """Mixed-step q, k, v whose generating rows' column 0 is the decode
    step's row; and the decode step's."""
    q1, k1, v1 = (_rand(B, 1, h, D, seed=dec_seed + i) for i, h in enumerate((HQ, HKV, HKV)))
    qm, km, vm = (_rand(B, T, h, D, seed=mix_seed + i) for i, h in enumerate((HQ, HKV, HKV)))
    for x, x1 in ((qm, q1), (km, k1), (vm, v1)):
        x[gen, :1] = x1[gen]
    return (q1, k1, v1), (qm, km, vm)


def _paged(dtype):
    kv = PagedKVCache.create(1, B, MAX_LEN, HKV, D, dtype=dtype, page_size=PAGE, device="cpu")
    kv.k[0].copy_(_rand(*kv.k[0].shape, seed=1).to(dtype))
    kv.v[0].copy_(_rand(*kv.v[0].shape, seed=2).to(dtype))
    return kv


def _q8():
    kv = KVCacheQ8.create(1, B, MAX_LEN + T, HKV, D, device="cpu")
    prefix = torch.arange(MAX_LEN, dtype=torch.int32)[None].repeat(B, 1)
    kv.update(0, _rand(B, MAX_LEN, HKV, D, seed=1), _rand(B, MAX_LEN, HKV, D, seed=2), prefix)
    return kv


def _contiguous(dtype):
    """The engine's contiguous stripe: max_len + chunk slots a row."""
    kv = KVCache.create(1, B, MAX_LEN + T, HKV, D, dtype=dtype, device="cpu")
    kv.k[0].copy_(_rand(*kv.k[0].shape, seed=1).to(dtype))
    kv.v[0].copy_(_rand(*kv.v[0].shape, seed=2).to(dtype))
    return kv


def _clone(kv):
    if isinstance(kv, PagedKVCache):
        return PagedKVCache([x.clone() for x in kv.k], [x.clone() for x in kv.v],
                            kv.table.clone(), kv.page_size, kv.horizon)
    if isinstance(kv, KVCache):
        return KVCache([x.clone() for x in kv.k], [x.clone() for x in kv.v])
    return KVCacheQ8([x.clone() for x in kv.k], [x.clone() for x in kv.v],
                     [x.clone() for x in kv.ks], [x.clone() for x in kv.vs])


def _cache(cache):
    if cache == "q8":
        return _q8()
    dtype = torch.bfloat16 if cache.endswith("bf16") else torch.float32
    return _contiguous(dtype) if cache.startswith("contiguous") else _paged(dtype)


def _llama_attention(monkeypatch):
    """The attention of llama's `layer_forward` from given q|k|v rows: the
    projections return them, wo is the identity and the FFN adds zero, so
    the block's output on x = 0 is its attention [B, T, Hq * D]."""
    monkeypatch.setattr(llama, "_projections", lambda layer, h: layer["qkv"])
    monkeypatch.setattr(llama, "linear", lambda h, w: h)
    monkeypatch.setattr(llama, "_ffn_core", lambda layer, h, *taps: torch.zeros_like(h))

    def run(q, k, v, kv, positions):
        b, t = q.shape[:2]
        qkv = torch.cat([x.reshape(b, t, -1) for x in (q, k, v)], dim=-1)
        layer = {"qkv": qkv, "wo": None, "attn_norm": torch.ones(HQ * D),
                 "ffn_norm": torch.ones(HQ * D)}
        x = torch.zeros(b, t, HQ * D)
        return llama.layer_forward(layer, CFG, x, positions, kv, 0).reshape(b, t, HQ, D)

    return run


def _attention(arch, monkeypatch):
    """The attention a generating row gets: through `layer_forward` for
    llama over a contiguous cache (K2 there), through `_attend` otherwise."""
    if arch == "llama_layer":
        return _llama_attention(monkeypatch)
    cfg = OLMO2 if arch == "olmo2" else CFG
    return lambda q, k, v, kv, positions: llama._attend(q, k, v, kv, 0, positions, cfg, SCALE)


@pytest.mark.parametrize("cache,arch", [
    ("paged_f32", "llama"), ("paged_bf16", "llama"), ("q8", "llama"),
    ("contiguous_f32", "llama_layer"), ("contiguous_bf16", "llama_layer"),
    ("contiguous_f32", "olmo2"), ("contiguous_bf16", "olmo2")])
def test_generating_row_attends_alike_in_both_steps(cache, arch, monkeypatch):
    """A generating row's attention in a mixed step equals, bit for bit,
    its attention in a decode step from the same cache, and leaves the
    cache as the decode step leaves it at the row's position."""
    kv = _cache(cache)
    attend = _attention(arch, monkeypatch)
    trash = MAX_LEN
    dec_pos, mix_pos, gen = _steps(trash)
    (q1, k1, v1), (qm, km, vm) = _qkv(10, 20, gen)
    kv_d, kv_m = _clone(kv), _clone(kv)
    out_d = attend(q1, k1, v1, kv_d, dec_pos)
    out_m = attend(qm, km, vm, kv_m, mix_pos)
    assert out_m.shape == (B, T, HQ, D)
    for r in gen:
        assert torch.equal(out_m[r, 0], out_d[r, 0])
        pos = int(dec_pos[r, 0])
        if cache == "q8":
            for name in ("k", "v", "ks", "vs"):
                a, b = getattr(kv_m, name)[0], getattr(kv_d, name)[0]
                assert torch.equal(a[r, :, pos], b[r, :, pos])
        elif cache.startswith("contiguous"):
            assert torch.equal(kv_m.k[0][r, :, pos], kv_d.k[0][r, :, pos])
            assert torch.equal(kv_m.v[0][r, :, pos], kv_d.v[0][r, :, pos])
        else:
            row = int(kv.table[r, pos // PAGE]) * PAGE + pos % PAGE
            assert torch.equal(kv_m.k[0][:, row], kv_d.k[0][:, row])
            assert torch.equal(kv_m.v[0][:, row], kv_d.v[0][:, row])


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_k2_rope_equals_apply_rope(cache):
    """K2 ropes the new k row itself (`rope_table` at positions[:, 0],
    one product and one sum a pair); its cache row equals apply_rope's k
    cast to the cache dtype, bit for bit, so re-inserting a mixed step's
    slot pos0 through K2 leaves a prompt row's slot as kv.update wrote it."""
    dtype = torch.bfloat16 if cache == "bf16" else torch.float32
    kv = _contiguous(dtype)
    pos = torch.tensor([[37], [5], [MAX_LEN]], dtype=torch.int32)
    qkv = _rand(B, 1, (HQ + 2 * HKV) * D, seed=30) * 3.0
    for style in ("norm", "neox"):
        rope = RopeParams(dim=D, base=500000.0, style=style)
        kc, vc = kv.k[0].clone(), kv.v[0].clone()
        attn_decode_qkv_plain(qkv.reshape(B, -1, D), kc, vc, pos, rope_table(pos[:, 0], rope, D),
                              scale=SCALE)
        k = qkv[..., HQ * D:(HQ + HKV) * D].reshape(B, 1, HKV, D)
        want = apply_rope(k, pos, rope).to(dtype)
        for r in range(B):
            assert torch.equal(kc[r, :, int(pos[r, 0])], want[r, 0])


@pytest.mark.parametrize("cache,arch", [("paged", "llama"), ("q8", "llama"),
                                        ("contiguous_f32", "llama_layer"),
                                        ("contiguous_bf16", "olmo2")])
def test_mixed_step_takes_the_t1_path_for_column_0(cache, arch, monkeypatch):
    """In a mixed step the T=1 path runs once on column 0 of every row, and
    its output replaces column 0 of the one-token rows only."""
    kv = _cache("paged_f32" if cache == "paged" else cache)
    attend = _attention(arch, monkeypatch)
    _, mix_pos, gen = _steps(MAX_LEN)
    _, (qm, km, vm) = _qkv(10, 20, gen)
    marker = 1234.5
    calls = []

    if cache == "q8":
        real = llama.flash_attention_blockwise

        def spy(q, *args, **kw):
            out = real(q, *args, **kw)
            if q.shape[1] == 1:
                calls.append(q.shape)
                out = torch.full_like(out, marker)
            return out

        monkeypatch.setattr(llama, "flash_attention_blockwise", spy)
    elif arch == "llama_layer":  # K2 on the raw q|k|v rows [B, Hq + 2 Hkv, D]
        def spy(qkv3, *args, **kw):
            calls.append(qkv3.shape)
            return torch.full((B, 1, HQ, D), marker)

        monkeypatch.setattr(llama, "attn_decode_qkv", spy)
    else:
        def spy(q, *args, **kw):
            calls.append(q.shape)
            return torch.full_like(q, marker)

        monkeypatch.setattr(llama, "attn_decode_update" if arch == "olmo2"
                            else "paged_attn_decode_update", spy)
    out = attend(qm, km, vm, kv, mix_pos)
    assert calls == [(B, HQ + 2 * HKV, D) if arch == "llama_layer" else (B, 1, HQ, D)]
    for r in range(B):
        assert bool((out[r, 0] == marker).all()) == (r in gen)
        assert not bool((out[r, 1:] == marker).any())


@pytest.mark.parametrize("positions,one", [
    ([[5, 6, 7], [9, 64, 64], [64, 64, 64]], [False, True, True]),
    ([[0, 1, 2], [63, 64, 64], [10, 11, 64]], [False, True, False]),
    ([[3, 4], [7, 64], [64, 64]], [False, True, True]),
    ([[9, 64, 65], [9, 64, 64], [5, 6, 64]], [False, True, False]),
])
def test_one_token_rows_are_those_with_trash_after_column_0(positions, one):
    """A row holds one generating token when columns 1 and 2 hold one
    (trash) position, or (T = 2) column 1 is not column 0's successor: a
    generating row, the last position's too (63, trash 64), or an idle one;
    a run of two or more tokens is not one, nor a prompt run of one token,
    which the engine pads with distinct trash positions (9, 64, 65)."""
    pos = torch.tensor(positions, dtype=torch.int32)
    t = pos.shape[1]
    out = torch.zeros(3, t, 2)
    first = torch.ones(3, 1, 2)
    got = llama._one_token_rows(out, pos, first)
    assert [bool(got[r, 0].eq(1).all()) for r in range(3)] == one
    assert not bool(got[:, 1:].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("width", [256, 2048, 5632])
def test_rms_norm_row_does_not_depend_on_its_neighbours(width, dtype):
    """The same rows normed alone, as one [4, 1, W] decode batch and inside
    a [4, 128, W] chunk give the same bits."""
    x = (_rand(4, 128, width, seed=width) * 3.0).to(dtype)
    w = _rand(width, seed=1) * 0.1 + 1.0
    full = rms_norm(x, w, 1e-5)
    assert torch.equal(rms_norm(x[:, :1].contiguous(), w, 1e-5), full[:, :1])
    assert torch.equal(rms_norm(x[1:2, 5:6].contiguous(), w, 1e-5), full[1:2, 5:6])
    assert full.dtype == dtype


def test_engine_pads_a_prompt_run_with_distinct_trash(tmp_path, monkeypatch):
    """The engine's mixed step pads a prompt chunk with the distinct trash
    positions max_len, max_len + 1, ... and a generating row with max_len
    alone; so a prompt chunk of one token (here a 17-token prompt's second
    chunk, beside a generating row) keeps the multi-row kernel's bits, as
    it does when it rides inside a longer chunk after another prefix."""
    import time

    from zllm_torch.models.loader import Model
    from zllm_torch.server import engine as engine_mod
    from zllm_torch.server.engine import Engine, Request
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "m.gguf"), n_layers=1, n_embd=64, n_heads=4,
                           n_kv_heads=2, n_ff=128, vocab_size=256)
    model = Model.load(path, device="cpu", dtype=torch.float32)
    eng = Engine(model, n_slots=2, max_len=64, prefill_chunk=16, kv_layout="contiguous",
                 kv_dtype=torch.float32)
    steps = []
    real = engine_mod.forward

    def spy(params, cfg, tokens, positions, kv, **kw):
        steps.append(positions.clone())
        return real(params, cfg, tokens, positions, kv, **kw)

    monkeypatch.setattr(engine_mod, "forward", spy)
    eng.start()
    try:
        first = eng.run_in_loop(lambda: [eng.submit(Request(prompt_tokens=[1, 5, 7],
                                                            max_new=8, temp=0.0))])
        while not first[0].out_tokens:
            time.sleep(0.005)
        reqs = eng.run_in_loop(lambda: [eng.submit(Request(prompt_tokens=list(range(3, 20)),
                                                           max_new=2, temp=0.0))])
        deadline = time.time() + 120
        while not all(r.done for r in first + reqs):
            assert time.time() < deadline, "engine timed out"
            time.sleep(0.005)
    finally:
        eng.stop()
    trash = 64 + torch.arange(15, dtype=torch.int32)
    rows = [row for pos in steps if pos.shape[1] == 16 for row in pos]
    one = [row for row in rows if int(row[0]) == 16 and bool((row[1:] == trash).all())]
    gen = [row for row in rows if int(row[0]) < 64 and bool((row[1:] == 64).all())]
    assert one and gen  # the prompt's one-token chunk beside a generating row
    for pos in steps:
        if pos.shape[1] == 16:
            flagged = llama._one_token_rows(torch.zeros(2, 16), pos, torch.ones(2, 1))[:, 0]
            assert flagged.tolist() == [float(bool((r[1:] == 64).all())) for r in pos]
