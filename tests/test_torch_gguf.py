"""zllm_torch GGUF I/O and codecs against zllm's: the same metadata and
tensor bytes on read, byte-identical files on write, byte-identical Q4_K,
Q6_K, Q8_0 and F16 encoding and bit-exact decoding."""

import numpy as np
import pytest
import torch  # noqa: F401  (thread count set by the oracle module)
from test_torch_oracle import SMALL_LLAMA

from zllm.gguf import read_gguf as zread
from zllm.gguf.constants import GGMLType
from zllm.quant import blocks as zqb
from zllm.testing import make_llama_gguf as zmake
from zllm_torch.gguf import GGUFWriter, read_gguf
from zllm_torch.quant import blocks as qb
from zllm_torch.testing import make_llama_gguf

RNG = np.random.default_rng(21)


@pytest.fixture(scope="module")
def small_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("g") / "small.gguf")
    zmake(path, **SMALL_LLAMA, with_tokenizer=True)
    return path


def _same_value(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b)) and np.asarray(a).dtype == np.asarray(b).dtype
    return type(a) is type(b) and a == b


def test_reader_matches_zllm(small_gguf):
    with zread(small_gguf) as zf, read_gguf(small_gguf) as f:
        assert f.version == zf.version and f.alignment == zf.alignment
        assert f.data_offset == zf.data_offset
        assert list(f.metadata) == list(zf.metadata)
        for key in zf.metadata:
            assert _same_value(f.metadata[key], zf.metadata[key]), key
        assert list(f.tensors) == list(zf.tensors)
        for name, meta in zf.tensors.items():
            m2 = f.tensors[name]
            assert (m2.shape, int(m2.gtype), m2.offset, m2.nbytes) == (
                meta.shape, int(meta.gtype), meta.offset, meta.nbytes)
            assert np.array_equal(f.tensor_bytes(name), zf.tensor_bytes(name)), name


@pytest.mark.parametrize("with_tokenizer", [False, True])
def test_make_llama_gguf_byte_identical(tmp_path, with_tokenizer):
    """The port's factory (writer + Q4_K encoder) writes zllm's bytes."""
    a, b = str(tmp_path / "z.gguf"), str(tmp_path / "t.gguf")
    kw = dict(SMALL_LLAMA, seed=3, with_tokenizer=with_tokenizer)
    zmake(a, **kw)
    make_llama_gguf(b, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("gtype", [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1],
                         ids=lambda t: t.name)
def test_make_llama_gguf_q4_legacy_byte_identical(tmp_path, gtype):
    """gtype Q4_0/Q4_1/Q5_0/Q5_1 (the port's 32-block encoders) writes
    zllm's bytes."""
    a, b = str(tmp_path / "z.gguf"), str(tmp_path / "t.gguf")
    kw = dict(SMALL_LLAMA, gtype=gtype, seed=6, with_tokenizer=True)
    zmake(a, **kw)
    make_llama_gguf(b, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_make_llama_gguf_arch_llama_byte_identical(tmp_path):
    """Naming arch="llama" (the factory's default) still writes zllm's bytes."""
    a, b = str(tmp_path / "z.gguf"), str(tmp_path / "t.gguf")
    zmake(a, **SMALL_LLAMA, seed=4)
    make_llama_gguf(b, **SMALL_LLAMA, seed=4, arch="llama")
    assert open(a, "rb").read() == open(b, "rb").read()


def test_make_olmo2_gguf_has_olmo2_tensors(tmp_path):
    """arch="olmo2" writes llama.cpp's OLMo-2 tensor names and metadata, no
    pre-norms, and zllm reads the file as an olmo2 model; other arches are
    refused."""
    import jax.numpy as jnp

    from zllm.models.loader import Model

    path = make_llama_gguf(str(tmp_path / "o.gguf"), **SMALL_LLAMA, arch="olmo2", norm_eps=1e-6)
    with read_gguf(path) as f:
        assert f.architecture == "olmo2"
        assert f.metadata["olmo2.attention.layer_norm_rms_epsilon"] == pytest.approx(1e-6)
        blk = sorted(n.split(".", 2)[2] for n in f.tensors if n.startswith("blk.0."))
        assert blk == sorted(["attn_q.weight", "attn_k.weight", "attn_v.weight",
                              "attn_output.weight", "attn_q_norm.weight", "attn_k_norm.weight",
                              "post_attention_norm.weight", "ffn_gate.weight", "ffn_up.weight",
                              "ffn_down.weight", "post_ffw_norm.weight"])
        q_dim = SMALL_LLAMA["n_heads"] * (SMALL_LLAMA["n_embd"] // SMALL_LLAMA["n_heads"])
        assert f.tensors["blk.1.attn_q_norm.weight"].shape == (q_dim,)
    m = Model.load(path, dtype=jnp.float32)
    assert m.cfg.arch == "olmo2" and "attn_norm" not in m.params["layers"][0]
    with pytest.raises(ValueError, match="the factory writes"):
        make_llama_gguf(str(tmp_path / "g.gguf"), arch="phi3")


def test_writer_rewrites_file_byte_identical(small_gguf, tmp_path):
    """Read a file with the port and write it back with the port's writer."""
    out = str(tmp_path / "copy.gguf")
    with read_gguf(small_gguf) as f:
        w = GGUFWriter(out, alignment=f.alignment)
        for key, val in f.metadata.items():
            w.add(key, val)
        for name, meta in f.tensors.items():
            w.add_tensor(name, np.asarray(f.tensor_bytes(name)), logical_shape=meta.shape,
                         gtype=meta.gtype)
        w.write()
    assert open(out, "rb").read() == open(small_gguf, "rb").read()


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_q4k_encode_byte_identical(rows):
    x = (RNG.standard_normal((rows, 512)) * RNG.uniform(0.01, 3.0)).astype(np.float32)
    x[0, :40] = 0.0  # all-zero groups take the safe-inverse branch
    assert np.array_equal(qb.quantize(x, GGMLType.Q4_K), zqb.quantize(x, GGMLType.Q4_K))


@pytest.mark.parametrize("fmt", [GGMLType.Q6_K, GGMLType.Q8_0, GGMLType.F16],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("rows", [1, 64])
def test_encode_byte_identical(fmt, rows):
    """The Q4_K_M file's other encoders: Q6_K (attn_v, half of ffn_down, the
    head), Q8_0, and F16 (the quantizer's fallback)."""
    x = (RNG.standard_normal((rows, 512)) * RNG.uniform(0.01, 3.0)).astype(np.float32)
    x[0, :40] = 0.0  # all-zero groups take the safe-inverse branch
    assert np.array_equal(qb.quantize(x, fmt), zqb.quantize(x, fmt))


@pytest.mark.parametrize("fmt", [GGMLType.F32, GGMLType.F16, GGMLType.Q4_K, GGMLType.Q6_K,
                                 GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q4_1],
                         ids=lambda t: t.name)
def test_decode_bit_exact(fmt):
    x = RNG.standard_normal((16, 512)).astype(np.float32)
    raw = zqb.quantize(x, fmt)
    assert np.array_equal(qb.dequantize(raw, fmt), zqb.dequantize(raw, fmt))


def test_q6k_decode_random_blocks_bit_exact():
    """Random bytes, not an encoder's output: every nibble and crumb position
    of ql/qh and every sign of the int8 scales is exercised, so a bit-order
    slip cannot hide behind symmetric weights."""
    raw = RNG.integers(0, 256, size=(32, 210), dtype=np.uint8)
    raw[:, 208:210] = np.frombuffer(np.float16(0.01).tobytes(), np.uint8)  # finite d
    assert np.array_equal(qb.dequantize(raw, GGMLType.Q6_K), zqb.dequantize(raw, GGMLType.Q6_K))


@pytest.mark.parametrize("fmt,row", [(GGMLType.Q4_0, 18), (GGMLType.Q4_1, 20)],
                         ids=["Q4_0", "Q4_1"])
def test_q4_legacy_decode_random_blocks_bit_exact(fmt, row):
    """Random code bytes (every nibble position) under finite fp16 scales
    and mins: ggml's in-block order (byte j holds codes j and j + 16)."""
    raw = RNG.integers(0, 256, size=(32, row), dtype=np.uint8)
    raw[:, :2] = np.frombuffer(np.float16(0.01).tobytes(), np.uint8)
    if fmt == GGMLType.Q4_1:
        raw[:, 2:4] = np.frombuffer(np.float16(-0.07).tobytes(), np.uint8)
    assert np.array_equal(qb.dequantize(raw, fmt), zqb.dequantize(raw, fmt))


def test_unsupported_format_raises():
    """Q8_K (llama.cpp's activation type): zllm encodes and decodes it, the
    port neither."""
    x = RNG.standard_normal((2, 256)).astype(np.float32)
    with pytest.raises(NotImplementedError):
        qb.quantize(x, GGMLType.Q8_K)
    with pytest.raises(NotImplementedError):
        qb.dequantize(zqb.quantize(x, GGMLType.Q8_K), GGMLType.Q8_K)
