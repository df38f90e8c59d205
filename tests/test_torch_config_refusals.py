"""`ModelConfig.from_gguf` refuses the `{arch}.*` metadata zllm applies to a
llama or OLMo-2 file and the port's forward does not: each of the seven
keys below at a value that changes zllm's model, and per-layer arrays of
the head counts or the FFN width.  Each case writes a small F32 file with
the port's factory, adds one key, and asserts both that zllm's config
takes the value (so zllm would compute another model) and that the port
raises a typed NotImplementedError naming the key, for the llama and the
OLMo-2 architecture.  The same keys at their defaults still load.
`attention.query_pre_attn_scalar` (Gemma-2/3's) applies: the port's score
scale and logits equal zllm's for it, on both architectures."""

import numpy as np
import pytest
import torch  # noqa: F401  (thread count set by the oracle module)
from test_torch_oracle import SMALL_LLAMA

from zllm.gguf.constants import GGMLType

# key -> (a value that changes zllm's model, zllm's config field and the
# value it then holds)
CHANGED = {
    "embedding_scale": (2.0, "emb_scale", 2.0),
    "residual_scale": (0.5, "residual_scale", 0.5),
    "attention.clamp_kqv": (0.01, "clamp_kqv", np.float32(0.01)),
    "attention.output_scale": (0.25, "attn_scale", 0.25),
    "use_parallel_residual": (True, "parallel_residual", "separate"),
    "swin_norm": (True, "swin_norm", True),
    "attention.max_alibi_bias": (8.0, "alibi_bias_max", 8.0),
    # per-layer arrays: zllm takes the largest entry
    "attention.head_count": ([4, 4], "n_heads", 4),
    "attention.head_count_kv": ([2, 2], "n_kv_heads", 2),
    "feed_forward_length": ([512, 512], "n_ff", 512),
}
# the keys at values that leave zllm's model the port's
DEFAULTS = {"embedding_scale": 1.0, "residual_scale": 1.0, "attention.clamp_kqv": 0.0,
            "attention.query_pre_attn_scalar": 0, "attention.output_scale": 0.0,
            "use_parallel_residual": False, "swin_norm": False,
            "attention.max_alibi_bias": 0.0}
ARCHES = ("llama", "olmo2")


@pytest.fixture(scope="module")
def base_files(tmp_path_factory):
    from zllm_torch.testing import make_llama_gguf

    folder = tmp_path_factory.mktemp("cfg")
    shape = {k: v for k, v in SMALL_LLAMA.items() if k != "gtype"}
    return {arch: make_llama_gguf(str(folder / f"{arch}.gguf"), **shape, arch=arch,
                                  gtype=GGMLType.F32, with_tokenizer=True)
            for arch in ARCHES}


def _with_keys(src: str, out: str, extra: dict) -> str:
    """A copy of GGUF `src` with `extra` ({arch}-relative keys) set."""
    from zllm_torch.gguf import read_gguf
    from zllm_torch.gguf.writer import GGUFWriter

    with read_gguf(src) as f:
        arch = f.architecture
        keys = {f"{arch}.{k}": v for k, v in extra.items()}
        w = GGUFWriter(out, alignment=f.alignment)
        for key, val in f.metadata.items():
            if key not in keys:
                w.add(key, val)
        for key, val in keys.items():
            w.add(key, val)
        for name, meta in f.tensors.items():
            w.add_tensor(name, np.asarray(f.tensor_bytes(name)), logical_shape=meta.shape,
                         gtype=meta.gtype)
        w.write()
    return out


def _zllm_config(path):
    from zllm.gguf.reader import read_gguf
    from zllm.models.config import ModelConfig

    with read_gguf(path) as f:
        return ModelConfig.from_gguf(f)


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("key", [*CHANGED, "defaults"])
def test_unported_metadata_is_refused(base_files, tmp_path, arch, key):
    from zllm_torch.models.loader import Model

    if key == "defaults":
        path = _with_keys(base_files[arch], str(tmp_path / "d.gguf"), DEFAULTS)
        zcfg = _zllm_config(path)
        assert zcfg.emb_scale == 1.0 and zcfg.parallel_residual == "none"
        m = Model.load(path, device="cpu", dtype=torch.float32)
        assert m.cfg.arch == arch and m.cfg.attn_scale == zcfg.attn_scale == 0.0
        return
    value, field, held = CHANGED[key]
    path = _with_keys(base_files[arch], str(tmp_path / "k.gguf"), {key: value})
    assert getattr(_zllm_config(path), field) == held
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        Model.load(path, device="cpu", dtype=torch.float32)


def test_output_scale_beside_attention_scale_loads(base_files, tmp_path):
    """zllm takes attention.scale before attention.output_scale, so a file
    with both is the port's model and loads."""
    from zllm_torch.models.loader import Model

    path = _with_keys(base_files["llama"], str(tmp_path / "s.gguf"),
                      {"attention.scale": 0.125, "attention.output_scale": 0.3})
    zcfg = _zllm_config(path)
    m = Model.load(path, device="cpu", dtype=torch.float32)
    assert m.cfg.attn_scale == zcfg.attn_scale == np.float32(0.125)


@pytest.mark.parametrize("arch", ARCHES)
def test_query_pre_attn_scalar_applies(base_files, tmp_path, arch):
    """attention.query_pre_attn_scalar 16: the score scale 1/sqrt(16), and a
    prefill's logits within nmse 1e-5 of zllm's forward."""
    import jax.numpy as jnp

    from zllm.models.llama import forward as zforward
    from zllm.models.loader import Model as ZModel
    from zllm_torch.models.llama import forward
    from zllm_torch.models.loader import Model

    path = _with_keys(base_files[arch], str(tmp_path / "q.gguf"),
                      {"attention.query_pre_attn_scalar": 16})
    zm = ZModel.load(path, dtype=jnp.float32)
    m = Model.load(path, device="cpu", dtype=torch.float32)
    assert m.cfg.attn_scale == zm.cfg.attn_scale == 0.25
    toks = np.arange(3, 23, dtype=np.int32)[None]
    pos = np.arange(20, dtype=np.int32)[None]
    want = np.asarray(zforward(zm.params, zm.cfg, jnp.asarray(toks), jnp.asarray(pos), None)[0])
    got = forward(m.params, m.cfg, torch.from_numpy(toks), torch.from_numpy(pos)).numpy()
    assert np.mean((got - want) ** 2) <= 1e-5 * np.mean(want ** 2)
