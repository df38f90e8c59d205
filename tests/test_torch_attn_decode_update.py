"""K8 (`attn_decode_update`): the port's plain version against zllm's
`attn_decode_update` run with interpret=True, on the CPU.

Cases: a mid-cache position, the 256-slot block edge (255), the start (0),
two rows at different positions, a sliding window, a trash row (pos == S:
it writes slot S-1 and attends all S slots) and a logit softcap; over
groups G = 1 (MHA) and 4, head dims 64 and 128, S = 256 and 512, and f32,
bf16 and f16 caches (the f16 KV cache).  q is f32, as the forward hands it
over (the matvecs return f32), except in two cases with a bf16 q (bf16
and f16 caches).  Tolerances: with an f32 cache only the f32 sum order
differs, so max |diff| <= 1e-5; with a bf16 or f16 cache both sides round
the new rows and the probabilities to the cache dtype at the same points
(f16's subnormal probabilities kept on both), and an f32 sum-order
difference may move one probability by an ulp of that dtype, so nmse <=
1e-5.  The updated caches are bit-identical.  S stays a multiple of 256
as in the other K8 tests, though zllm's K8, unlike its K2, was found to
insert at the right slot for S 384 too."""

import numpy as np
import pytest
import torch
from test_torch_oracle import nmse, to_np

from zllm_torch.ops import attention as ta

# case -> (B, G, D, S, positions, window, softcap)
CASES = {
    "mid": (1, 1, 128, 512, [331], 0, 0.0),
    "block_edge": (1, 4, 64, 512, [255], 0, 0.0),
    "start": (1, 1, 64, 256, [0], 0, 0.0),
    "b2": (2, 4, 128, 512, [17, 300], 0, 0.0),
    "window": (2, 1, 128, 512, [400, 40], 100, 0.0),
    "trash_row": (2, 4, 64, 256, [256, 100], 0, 0.0),
    "softcap": (1, 4, 128, 256, [200], 0, 30.0),
}
HKV = 2


def _inputs(b, g, d, s, seed):
    rng = np.random.default_rng(seed)
    hq = g * HKV
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, 1, HKV, d)).astype(np.float32) for _ in range(2))
    kc, vc = (rng.standard_normal((b, HKV, s, d)).astype(np.float32) for _ in range(2))
    return q, kn, vn, kc, vc


def _run_both(case, cdtype, qdtype="float32"):
    import jax.numpy as jnp

    from zllm.ops.attention import attn_decode_update as zllm_k8

    b, g, d, s, pos, window, softcap = CASES[case]
    q, kn, vn, kc, vc = _inputs(b, g, d, s, sum(map(ord, case)))
    positions = np.asarray(pos, dtype=np.int32)[:, None]
    kw = dict(scale=d ** -0.5, softcap=softcap, window=window)
    jc, jq = getattr(jnp, cdtype), getattr(jnp, qdtype)
    want, zk, zv = zllm_k8(jnp.asarray(q, jq), jnp.asarray(kn, jq), jnp.asarray(vn, jq),
                           jnp.asarray(kc, jc), jnp.asarray(vc, jc), jnp.asarray(positions),
                           interpret=True, **kw)
    tc, tq = getattr(torch, cdtype), getattr(torch, qdtype)
    tk, tv = torch.from_numpy(kc).to(tc), torch.from_numpy(vc).to(tc)
    before = ta.attn_decode_update.launches
    got = ta.attn_decode_update(torch.from_numpy(q).to(tq), torch.from_numpy(kn).to(tq),
                                torch.from_numpy(vn).to(tq), tk, tv, torch.from_numpy(positions),
                                **kw)
    assert ta.attn_decode_update.launches == before  # the CPU runs the plain version
    assert got.shape == (b, 1, g * HKV, d) and got.dtype == tq
    return got, want, (tk, tv), (zk, zv)


def _check(got, want, caches, zcaches, cdtype):
    if cdtype == "float32":
        assert np.abs(to_np(got) - to_np(want)).max() <= 1e-5
    else:
        assert nmse(to_np(got), to_np(want)) <= 1e-5
    for a, b in zip(caches, zcaches):
        np.testing.assert_array_equal(to_np(a), to_np(b))


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", list(CASES))
def test_k8_plain_matches_pallas(case, cdtype):
    got, want, caches, zcaches = _run_both(case, cdtype)
    _check(got, want, caches, zcaches, cdtype)


@pytest.mark.parametrize("case", ["mid", "trash_row"])
def test_k8_bf16_q_matches_pallas(case):
    """A bf16 q is taken as it is (zllm's kernel reads it into f32)."""
    got, want, caches, zcaches = _run_both(case, "bfloat16", "bfloat16")
    assert nmse(to_np(got), to_np(want)) <= 1e-4  # the outputs themselves round to bf16
    for a, b in zip(caches, zcaches):
        np.testing.assert_array_equal(to_np(a), to_np(b))


@pytest.mark.parametrize("case", ["mid", "trash_row"])
def test_k8_bf16_q_f16_cache_matches_pallas(case):
    """A bf16 q over an f16 cache (the f16 form's one-part q)."""
    got, want, caches, zcaches = _run_both(case, "float16", "bfloat16")
    assert nmse(to_np(got), to_np(want)) <= 1e-4  # the outputs themselves round to bf16
    for a, b in zip(caches, zcaches):
        np.testing.assert_array_equal(to_np(a), to_np(b))


def test_k8_writes_only_the_clamped_row():
    """Rows at pos and at the trash position S write slot min(pos, S-1) of
    their own row and nothing else."""
    b, g, d, s = 2, 1, 64, 256
    q, kn, vn, kc, vc = (torch.from_numpy(x) for x in _inputs(b, g, d, s, 3))
    k0, v0 = kc.clone(), vc.clone()
    ta.attn_decode_update(q, kn, vn, kc, vc, torch.tensor([[7], [s]], dtype=torch.int32),
                          scale=0.125)
    changed = (kc != k0).any(dim=-1) | (vc != v0).any(dim=-1)  # [B, Hkv, S]
    assert changed[0].any(dim=0).nonzero().flatten().tolist() == [7]
    assert changed[1].any(dim=0).nonzero().flatten().tolist() == [s - 1]
    assert torch.equal(kc[1, :, s - 1], kn[1, 0]) and torch.equal(vc[0, :, 7], vn[0, 0])


def test_k8_shape_and_dtype_errors_raise():
    b, g, d, s = 1, 2, 64, 256
    q, kn, vn, kc, vc = (torch.from_numpy(x) for x in _inputs(b, g, d, s, 4))
    pos = torch.tensor([[5]], dtype=torch.int32)
    kw = dict(scale=0.125)
    with pytest.raises(ValueError, match="bad shapes"):
        ta.attn_decode_update(q.expand(b, 2, -1, -1), kn, vn, kc, vc, pos, **kw)  # T = 2
    with pytest.raises(ValueError, match="bad shapes"):
        ta.attn_decode_update(q[:, :, :3], kn, vn, kc, vc, pos, **kw)  # Hq % Hkv
    with pytest.raises(ValueError, match="bad shapes"):
        ta.attn_decode_update(q, kn, vn, kc, vc[:, :, :128], pos, **kw)
    with pytest.raises(ValueError, match="dtypes"):
        ta.attn_decode_update(q, kn, vn, kc, vc.to(torch.bfloat16), pos, **kw)
    with pytest.raises(ValueError, match="dtypes"):
        ta.attn_decode_update(q, kn.to(torch.bfloat16), vn, kc, vc, pos, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        ta.attn_decode_update(q.to("meta"), kn.to("meta"), vn.to("meta"), kc.to("meta"),
                              vc.to("meta"), pos.to("meta"), **kw)
