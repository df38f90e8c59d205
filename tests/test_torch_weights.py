"""Weights carried across: zllm's Q4_K QTensor planes -> the port's QWeight
(params_from_jax), the port's own GGUF loader, and the two loaders on one
file.  Q4_K dequantization is exact in f32 on both sides, so every
comparison here is bit-exact."""

import numpy as np
import pytest
import torch
from test_torch_oracle import SMALL_LLAMA, jax_params_numpy, q4k_qtensor, qtensor_numpy, to_np

from zllm.gguf.constants import GGMLType
from zllm_torch.models.loader import params_from_jax
from zllm_torch.quant.repack import QWeight, concat_n, pad_n, repack


@pytest.mark.parametrize("npack", [True, False], ids=["npack", "fold"])
def test_params_from_jax_dequant_bit_exact(npack):
    import jax.numpy as jnp

    k, n = 512, 512
    qt, raw = q4k_qtensor(n, k, seed=5, npack=npack)
    got = params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")["output"]
    assert isinstance(got, QWeight) and got.shape == (k, n)
    want = np.asarray(qt.dequant(jnp.float32))
    assert np.array_equal(got.dequant().numpy(), want)
    # and the same planes as the port's own GGUF path
    own = repack(raw, (n, k), GGMLType.Q4_K, "cpu")
    for name, plane in own.planes().items():
        assert torch.equal(plane, getattr(got, name)), name


def test_concat_and_pad_n():
    import jax.numpy as jnp

    from zllm.quant import repack as rp

    parts = [q4k_qtensor(n, 256, seed=s, npack=False) for s, n in ((1, 128), (2, 64))]
    mine = concat_n([repack(raw, (qt.shape[1], 256), GGMLType.Q4_K, "cpu") for qt, raw in parts])
    theirs = rp.pad_n(rp.concat_n([qt for qt, _ in parts]), 256)
    mine = pad_n(mine, 256)
    assert mine.shape == theirs.shape == (256, 256)
    assert np.array_equal(mine.dequant().numpy(), np.asarray(theirs.dequant(jnp.float32)))


def test_non_q4k_does_not_carry_across():
    qt, _ = q4k_qtensor(256, 256, seed=1)
    desc = qtensor_numpy(qt)
    desc["fmt"] = int(GGMLType.Q6_K)
    with pytest.raises(NotImplementedError):
        params_from_jax({"output": desc, "layers": []}, device="cpu")


@pytest.fixture(scope="module")
def both_models(tmp_path_factory):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.testing import make_llama_gguf
    from zllm_torch.models.loader import Model

    path = str(tmp_path_factory.mktemp("w") / "m.gguf")
    make_llama_gguf(path, **SMALL_LLAMA, with_tokenizer=True)
    return ZModel.load(path, dtype=jnp.float32), Model.load(path, device="cpu",
                                                             dtype=torch.float32)


def test_config_fields_equal(both_models):
    zm, m = both_models
    for field in ("arch", "n_layers", "n_embd", "n_heads", "n_kv_heads", "head_dim", "n_ff",
                  "vocab_size", "ctx_len", "norm_eps", "rope", "attn_logit_softcap",
                  "final_logit_softcap", "logit_scale", "attn_scale", "neox_permuted",
                  "q_dim", "kv_dim"):
        want, got = getattr(zm.cfg, field), getattr(m.cfg, field)
        if field == "rope":  # two NamedTuple classes with the same fields
            want, got = want._asdict(), got._asdict()
        assert got == want, field


def _flat(params):
    out = {k: v for k, v in params.items() if k != "layers"}
    for il, layer in enumerate(params["layers"]):
        out.update({f"{il}.{k}": v for k, v in layer.items()})
    return out


def test_loaded_weights_equal(both_models):
    """Every tensor after fusion, the neox permutation and head padding."""
    import jax.numpy as jnp

    from zllm.quant.repack import QTensor

    zm, m = both_models
    zflat, flat = _flat(zm.params), _flat(m.params)
    assert sorted(zflat) == sorted(flat)
    for key, zv in zflat.items():
        v = flat[key]
        want = np.asarray(zv.dequant(jnp.float32)) if isinstance(zv, QTensor) else to_np(zv)
        got = v.dequant().numpy() if isinstance(v, QWeight) else to_np(v)
        assert isinstance(v, QWeight) == isinstance(zv, QTensor), key
        assert np.array_equal(got, want), key


def test_params_from_jax_matches_own_loader(both_models):
    zm, m = both_models
    carried = _flat(params_from_jax(jax_params_numpy(zm.params), device="cpu",
                                    dtype=torch.float32))
    for key, v in _flat(m.params).items():
        c = carried[key]
        if isinstance(v, QWeight):
            for name, plane in v.planes().items():
                assert torch.equal(plane, getattr(c, name)), (key, name)
        else:
            assert torch.equal(v, c), key
