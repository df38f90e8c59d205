"""`runtime/kvcache.shift_context`, the whole-cache context shift, against
zllm's `shift_context` and a recompute, on the CPU.

  * zllm's tests/test_context_shift.py case: an F32 2-layer model's cache
    of 12 tokens, shifted by (n_keep 2, n_discard 4), equals at layer 0 the
    cache recomputed from the kept tokens at their new positions (K at
    layer 0 depends only on its own token and position), and the freed
    tail is zero;
  * a multi-row f32 and bf16 cache with random contents, both rope styles
    and several (n_keep, n_discard): zllm's shift of the same arrays
    within f32 rounding (its cos/sin are XLA's), the moved V and the kept
    prefix bit for bit;
  * shifting every row at once equals `shift_context_row` on each row, bit
    for bit; a cache of another kind is refused."""

import numpy as np
import pytest
import torch
from test_torch_oracle import nmse, to_np

from zllm.gguf.constants import GGMLType


def test_shift_matches_recompute(tmp_path):
    from zllm_torch.models.llama import forward
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.kvcache import KVCache, shift_context
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "m.gguf"), n_layers=2, n_embd=64, n_heads=4,
                           n_kv_heads=2, n_ff=128, vocab_size=64, gtype=GGMLType.F32)
    m = Model.load(path, device="cpu", dtype=torch.float32)
    cfg = m.cfg
    toks = np.random.default_rng(0).integers(0, 64, 12).astype(np.int32)
    n_keep, n_discard = 2, 4

    def prefill(ids):
        kv = KVCache.create(cfg.n_layers, 1, 32, cfg.n_kv_heads, cfg.head_dim, torch.float32,
                            "cpu")
        with torch.inference_mode():
            forward(m.params, cfg, torch.from_numpy(ids[None]),
                    torch.arange(len(ids), dtype=torch.int32)[None], kv)
        return kv

    shifted = shift_context(prefill(toks), cfg.rope, n_keep, n_discard)
    kept = np.concatenate([toks[:n_keep], toks[n_keep + n_discard:]])
    ref = prefill(kept)
    n = len(kept)
    for got, want in ((shifted.k[0], ref.k[0]), (shifted.v[0], ref.v[0])):
        np.testing.assert_allclose(to_np(got[:, :, :n]), to_np(want[:, :, :n]), rtol=1e-4,
                                   atol=1e-5)
    assert float(shifted.k[0][:, :, n + 4:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["neox", "norm"])
@pytest.mark.parametrize("n_keep,n_discard", [(0, 7), (4, 20), (13, 1)])
def test_shift_context_matches_zllm(dtype, style, n_keep, n_discard):
    import jax.numpy as jnp

    from zllm.ops.layers import RopeParams as ZRope
    from zllm.runtime.kvcache import KVCache as ZKV
    from zllm.runtime.kvcache import shift_context as zshift
    from zllm_torch.ops.layers import RopeParams
    from zllm_torch.runtime.kvcache import KVCache, shift_context

    b, h, s, d, layers = 3, 2, 48, 64, 2
    r = np.random.default_rng(n_keep + n_discard)
    ks = [r.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(layers)]
    vs = [r.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(layers)]
    rope = dict(dim=d, base=10000.0, style=style)
    zkv = zshift(ZKV(k=tuple(jnp.asarray(x, dtype) for x in ks),
                     v=tuple(jnp.asarray(x, dtype) for x in vs)), ZRope(**rope), n_keep,
                 n_discard)
    tdt = getattr(torch, dtype)
    kv = KVCache([torch.from_numpy(x).to(tdt) for x in ks], [torch.from_numpy(x).to(tdt)
                                                             for x in vs])
    out = shift_context(kv, RopeParams(**rope), n_keep, n_discard)
    assert out is kv
    moved = s - n_keep - n_discard
    for il in range(layers):
        zk, zv = to_np(zkv.k[il]), to_np(zkv.v[il])
        k, v = to_np(kv.k[il]), to_np(kv.v[il])
        assert np.array_equal(v, zv)  # slid, never rounded
        assert np.array_equal(k[:, :, :n_keep], zk[:, :, :n_keep])
        assert not k[:, :, n_keep + moved:].any() and not zk[:, :, n_keep + moved:].any()
        # bf16: the re-rotated K is rounded to bf16, where an ulp of cos/sin
        # may move one rounding
        assert nmse(k, zk) <= (1e-12 if dtype == "float32" else 1e-5)


def test_shift_context_equals_per_row_shift():
    from zllm_torch.ops.layers import RopeParams
    from zllm_torch.runtime.kvcache import KVCache, KVCacheQ8, shift_context, shift_context_row

    rope = RopeParams(dim=32, base=500000.0, style="neox")
    g = torch.Generator().manual_seed(0)
    base = KVCache([torch.randn(3, 2, 40, 32, generator=g).to(torch.bfloat16) for _ in range(2)],
                   [torch.randn(3, 2, 40, 32, generator=g).to(torch.bfloat16) for _ in range(2)])
    whole = KVCache([x.clone() for x in base.k], [x.clone() for x in base.v])
    rows = KVCache([x.clone() for x in base.k], [x.clone() for x in base.v])
    shift_context(whole, rope, 5, 11)
    for row in range(3):
        shift_context_row(rows, rope, row, 5, 11)
    for a, b in zip(whole.k + whole.v, rows.k + rows.v):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="KVCache"):
        shift_context(KVCacheQ8.create(1, 1, 8, 1, 32, device="cpu"), rope, 1, 2)
