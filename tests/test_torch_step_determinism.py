"""A row's bits do not depend on the step it rides, on the CPU.

The serving engine's generating rows ride its mixed steps (T = chunk,
their one token in column 0, trash positions after it) and its decode
steps (T = 1).  The multi-row attention kernels (K10, K7's tensor-core
form) agree with the T=1 ones (K9, K7's split form) only to f32 rounding,
so `models/llama.py::_attend` attends column 0 of a one-token row through
the T=1 kernel in a mixed step too; and `rms_norm` sums its squares in
f64, so a row's norm does not depend on how many rows the reduction has.
Here: the routing (the T=1 path's output lands in column 0 of the
one-token rows, and only there), the equality of a generating row's
attention in the two steps through the plain versions, and rms_norm's row
independence.  On the card chip_smoke.py's serve phases hold concurrent
greedy texts to sequential ones, and tests/test_torch_cuda.py the logits
bit for bit."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zllm_torch.models import llama
from zllm_torch.ops.layers import rms_norm
from zllm_torch.runtime.kvcache import KVCacheQ8
from zllm_torch.runtime.paged import PagedKVCache

B, HQ, HKV, D, T = 3, 4, 2, 16, 8
MAX_LEN, PAGE = 64, 16
CFG = SimpleNamespace(attn_logit_softcap=0.0)  # all `_attend` reads of the config
SCALE = D ** -0.5


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


def _clone(kv):
    if isinstance(kv, PagedKVCache):
        return PagedKVCache([x.clone() for x in kv.k], [x.clone() for x in kv.v],
                            kv.table.clone(), kv.page_size, kv.horizon)
    return KVCacheQ8([x.clone() for x in kv.k], [x.clone() for x in kv.v],
                     [x.clone() for x in kv.ks], [x.clone() for x in kv.vs])


@pytest.mark.parametrize("cache", ["paged_f32", "paged_bf16", "q8"])
def test_generating_row_attends_alike_in_both_steps(cache):
    """A generating row's attention in a mixed step equals, bit for bit,
    its attention in a decode step from the same cache, and leaves the
    cache as the decode step leaves it at the row's position."""
    kv = _q8() if cache == "q8" else _paged(torch.bfloat16 if cache == "paged_bf16"
                                            else torch.float32)
    trash = MAX_LEN
    dec_pos, mix_pos, gen = _steps(trash)
    (q1, k1, v1), (qm, km, vm) = _qkv(10, 20, gen)
    kv_d, kv_m = _clone(kv), _clone(kv)
    out_d = llama._attend(q1, k1, v1, kv_d, 0, dec_pos, CFG, SCALE)
    out_m = llama._attend(qm, km, vm, kv_m, 0, mix_pos, CFG, SCALE)
    assert out_m.shape == (B, T, HQ, D)
    for r in gen:
        assert torch.equal(out_m[r, 0], out_d[r, 0])
        pos = int(dec_pos[r, 0])
        if cache == "q8":
            for name in ("k", "v", "ks", "vs"):
                a, b = getattr(kv_m, name)[0], getattr(kv_d, name)[0]
                assert torch.equal(a[r, :, pos], b[r, :, pos])
        else:
            row = int(kv.table[r, pos // PAGE]) * PAGE + pos % PAGE
            assert torch.equal(kv_m.k[0][:, row], kv_d.k[0][:, row])
            assert torch.equal(kv_m.v[0][:, row], kv_d.v[0][:, row])


@pytest.mark.parametrize("cache", ["paged", "q8"])
def test_mixed_step_takes_the_t1_path_for_column_0(cache, monkeypatch):
    """In a mixed step the T=1 path runs once on column 0 of every row, and
    its output replaces column 0 of the one-token rows only."""
    kv = _q8() if cache == "q8" else _paged(torch.float32)
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
    else:
        def spy(q, *args, **kw):
            calls.append(q.shape)
            return torch.full_like(q, marker)

        monkeypatch.setattr(llama, "paged_attn_decode_update", spy)
    out = llama._attend(qm, km, vm, kv, 0, mix_pos, CFG, SCALE)
    assert calls == [(B, 1, HQ, D)]
    for r in range(B):
        assert bool((out[r, 0] == marker).all()) == (r in gen)
        assert not bool((out[r, 1:] == marker).any())


@pytest.mark.parametrize("positions,one", [
    ([[5, 6, 7], [9, 64, 64], [64, 64, 64]], [False, True, True]),
    ([[0, 1, 2], [63, 64, 64], [10, 11, 64]], [False, True, False]),
    ([[3, 4], [7, 64], [64, 64]], [False, True, True]),
])
def test_one_token_rows_are_those_with_trash_after_column_0(positions, one):
    """A row holds one token when column 1 is not column 0's successor or
    columns 1 and 2 hold one (trash) position: a generating row, the last
    position's too (63, trash 64), or an idle one; a run of two or more
    tokens is not one."""
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
