"""Weights carried across: zllm's Q4_K, Q6_K and Q8_0 QTensor planes -> the
port's QWeights (params_from_jax), the port's own GGUF loader, and the two
loaders on one file (uniform Q4_K, Q4_K_M and Q8_0).  Dequantization is
exact in f32 on both sides (Q6_K's scale is the same fp16-rounded plane on
both), so every comparison here is bit-exact."""

import numpy as np
import pytest
import torch
from test_torch_oracle import (SMALL_LLAMA, jax_params_numpy, q4k_qtensor, qtensor_numpy,
                               quant_qtensor, to_np, zllm_quantized_gguf)

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
    """A format the port does not keep quantized (Q8_K, which zllm does not
    repack either) raises."""
    qt, _ = q4k_qtensor(256, 256, seed=1)
    desc = qtensor_numpy(qt)
    desc["fmt"] = int(GGMLType.Q8_K)
    with pytest.raises(NotImplementedError):
        params_from_jax({"output": desc, "layers": []}, device="cpu")


INT_FMTS = [GGMLType.Q6_K, GGMLType.Q8_0]


@pytest.mark.parametrize("fmt", INT_FMTS, ids=lambda t: t.name)
def test_params_from_jax_int_formats_bit_exact(fmt):
    import jax.numpy as jnp

    k, n = 512, 384
    qt, raw = quant_qtensor(fmt, n, k, seed=9)
    got = params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")["output"]
    assert isinstance(got, QWeight) and got.fmt == fmt and got.shape == (k, n)
    assert np.array_equal(got.dequant().numpy(), np.asarray(qt.dequant(jnp.float32)))
    own = repack(raw, (n, k), fmt, "cpu")
    for name, plane in own.planes().items():
        assert torch.equal(plane, getattr(got, name)), name


def test_q6k_random_blocks_column_by_column():
    """Random Q6_K bytes (every nibble and crumb position, signed scales),
    one column at a time: the port's layout against zllm's repack."""
    import jax.numpy as jnp

    from zllm.quant import repack as rp

    n, k = 128, 512
    raw = np.random.default_rng(4).integers(0, 256, size=(n * k // 256, 210), dtype=np.uint8)
    raw[:, 208:210] = np.frombuffer(np.float16(0.01).tobytes(), np.uint8)
    raw = raw.reshape(n, -1)
    want = np.asarray(rp.repack(raw, (n, k), GGMLType.Q6_K).dequant(jnp.float32))
    got = repack(raw, (n, k), GGMLType.Q6_K, "cpu").dequant().numpy()
    for col in range(n):
        assert np.array_equal(got[:, col], want[:, col]), col


@pytest.mark.parametrize("fmt", INT_FMTS, ids=lambda t: t.name)
def test_concat_pad_permute_int_formats(fmt):
    import jax.numpy as jnp

    from zllm.models.loader import _permute_cols
    from zllm.quant import repack as rp

    parts = [quant_qtensor(fmt, n, 256, seed=s) for s, n in ((1, 128), (2, 256))]
    mine = concat_n([repack(raw, (qt.shape[1], 256), fmt, "cpu") for qt, raw in parts])
    theirs = rp.concat_n([qt for qt, _ in parts])
    perm = np.random.default_rng(3).permutation(384)
    mine, theirs = pad_n(mine.permute_n(perm), 1024), rp.pad_n(_permute_cols(theirs, perm), 1024)
    assert mine.shape == theirs.shape == (256, 1024) and mine.fmt == fmt
    got, want = mine.dequant().numpy(), np.asarray(theirs.dequant(jnp.float32))
    assert np.array_equal(got, want)
    assert not got[:, 384:].any()  # padded columns dequantize to zero


def test_concat_n_refuses_mixed_formats():
    a = repack(quant_qtensor(GGMLType.Q4_K, 128, 256, 1)[1], (128, 256), GGMLType.Q4_K, "cpu")
    b = repack(quant_qtensor(GGMLType.Q6_K, 128, 256, 2)[1], (128, 256), GGMLType.Q6_K, "cpu")
    with pytest.raises(ValueError, match="one format"):
        concat_n([a, b])


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


@pytest.fixture(scope="module", params=["Q4_K_M", "Q8_0"])
def mixed_models(request, tmp_path_factory):
    """A Q4_K_M file (zllm's quantizer from F16) and a Q8_0 file (zllm's
    factory, so the token embedding is Q8_0 too), loaded by both packages."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.testing import make_llama_gguf
    from zllm_torch.models.loader import Model

    folder = tmp_path_factory.mktemp(request.param)
    if request.param == "Q4_K_M":
        path = zllm_quantized_gguf(folder, "Q4_K_M")
    else:
        path = make_llama_gguf(str(folder / "q8.gguf"), **dict(SMALL_LLAMA, gtype=GGMLType.Q8_0),
                               with_tokenizer=True)
    return request.param, ZModel.load(path, dtype=jnp.float32), Model.load(
        path, device="cpu", dtype=torch.float32)


def test_mixed_file_weights_equal(mixed_models):
    """Q6_K and Q8_0 tensors load quantized, each weight dequantizes equal to
    zllm's, and fusion follows formats: in Q4_K_M, wq/wk (Q4_K) and wv (Q6_K)
    stay apart while gate|up fuse."""
    import jax.numpy as jnp

    from zllm.quant.repack import QTensor

    ftype, zm, m = mixed_models
    zflat, flat = _flat(zm.params), _flat(m.params)
    assert sorted(zflat) == sorted(flat)
    for key, zv in zflat.items():
        v = flat[key]
        assert isinstance(v, QWeight) == isinstance(zv, QTensor), key
        if isinstance(v, QWeight):
            assert v.fmt == zv.fmt, key
            assert np.array_equal(v.dequant().numpy(), np.asarray(zv.dequant(jnp.float32))), key
        else:
            assert np.array_equal(to_np(v), to_np(zv)), key
    layer0 = m.params["layers"][0]
    if ftype == "Q4_K_M":
        assert "wqkv" not in layer0 and layer0["wv"].fmt == GGMLType.Q6_K
        assert layer0["ffn_gateup"].fmt == GGMLType.Q4_K
        assert [layer["ffn_down"].fmt for layer in m.params["layers"]] == [GGMLType.Q6_K,
                                                                           GGMLType.Q4_K]
        assert m.params["output"].fmt == GGMLType.Q6_K
    else:
        assert layer0["wqkv"].fmt == GGMLType.Q8_0 and not isinstance(m.params["tok_emb"],
                                                                      QWeight)
    assert m.params["output"].shape[1] % 1024 == 0


def test_mixed_file_params_from_jax_matches_own_loader(mixed_models):
    _, zm, m = mixed_models
    carried = _flat(params_from_jax(jax_params_numpy(zm.params), device="cpu",
                                    dtype=torch.float32))
    for key, v in _flat(m.params).items():
        c = carried[key]
        assert type(c) is type(v), key
        if isinstance(v, QWeight):
            for name, plane in v.planes().items():
                assert torch.equal(plane, getattr(c, name)), (key, name)
        else:
            assert torch.equal(v, c), key
