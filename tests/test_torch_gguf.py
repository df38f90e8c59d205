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
                                 GGMLType.Q8_0], ids=lambda t: t.name)
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


def test_unsupported_format_raises():
    x = RNG.standard_normal((2, 256)).astype(np.float32)
    with pytest.raises(NotImplementedError):
        qb.quantize(x, GGMLType.Q5_K)
    with pytest.raises(NotImplementedError):
        qb.dequantize(zqb.quantize(x, GGMLType.Q5_K), GGMLType.Q5_K)
