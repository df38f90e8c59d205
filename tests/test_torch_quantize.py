"""`zllm_torch.quantize` against `tools/quantize.py`: the same per-tensor
type choice for every preset and byte-identical output files (Q4_K_M,
Q4_K_S, Q6_K, Q8_0, Q4_0, Q4_1, Q5_0, Q5_1, Q5_K_S, Q5_K_M, Q2_K, Q3_K_M,
IQ4_NL, IQ4_XS, MXFP4, and IQ2_XXS with the grid fit on the CPU), from
one F16 synthetic model; a preset naming a type without an encoder
raises before writing.  The imatrix-weighted presets:
tests/test_torch_imatrix.py."""

import os

import numpy as np
import pytest
import torch  # noqa: F401  (thread count set by the oracle module)
from test_torch_oracle import SMALL_LLAMA, f16_llama_gguf

from zllm.gguf.constants import GGMLType
from zllm_torch import quantize as tq


@pytest.fixture(scope="module")
def f16_gguf(tmp_path_factory):
    return f16_llama_gguf(str(tmp_path_factory.mktemp("q") / "f16.gguf"), seed=2)


@pytest.mark.parametrize("ftype", ["Q4_K_M", "Q4_K_S", "Q6_K", "Q8_0", "Q4_0", "Q4_1", "Q5_0",
                                   "Q5_1", "Q5_K_S", "Q5_K_M", "Q2_K", "Q3_K_M", "IQ4_NL",
                                   "IQ4_XS", "MXFP4"])
def test_quantize_file_byte_identical(f16_gguf, tmp_path, ftype):
    from tools.quantize import quantize_file

    want, got = str(tmp_path / "z.gguf"), str(tmp_path / "t.gguf")
    quantize_file(f16_gguf, want, ftype, quiet=True)
    types = tq.quantize_file(f16_gguf, got, ftype, quiet=True)
    assert open(got, "rb").read() == open(want, "rb").read()
    if ftype == "Q4_K_M":
        assert types["output.weight"][:2] == ("F16", "Q6_K")
        assert types["blk.0.attn_v.weight"][:2] == ("F16", "Q6_K")
        assert types["blk.0.ffn_down.weight"][:2] == ("F16", "Q6_K")
        assert types["blk.1.ffn_down.weight"][:2] == ("F16", "Q4_K")
    if ftype == "Q5_K_M":  # attn_v and the head Q6_K, no ffn_down bump
        assert types["output.weight"][:2] == ("F16", "Q6_K")
        assert types["blk.0.attn_v.weight"][:2] == ("F16", "Q6_K")
        assert types["blk.0.ffn_down.weight"][:2] == ("F16", "Q5_K")
        assert types["blk.1.attn_q.weight"][:2] == ("F16", "Q5_K")
    if ftype == "Q3_K_M":  # attn_v Q5_K, the head Q6_K
        assert types["blk.0.attn_v.weight"][:2] == ("F16", "Q5_K")
        assert types["blk.1.ffn_down.weight"][:2] == ("F16", "Q3_K")
        assert types["output.weight"][:2] == ("F16", "Q6_K")
    if ftype in ("Q4_0", "Q4_1", "Q5_0", "Q5_1"):
        # the embedding is bumped to Q4_K, the rest keeps the preset
        assert types["token_embd.weight"][:2] == ("F16", "Q4_K")
        assert {t for name, (_, t, _) in types.items() if name != "token_embd.weight"
                and not name.endswith("norm.weight")} == {ftype}


def test_olmo2_q4km_byte_identical(tmp_path):
    """An F16 OLMo-2 file (the port's factory) requantized to Q4_K_M: the
    same bytes as tools/quantize.py; the q/k norms and post-norms stay F32."""
    from tools.quantize import quantize_file

    from zllm_torch.testing import make_llama_gguf

    shape = {k: v for k, v in SMALL_LLAMA.items() if k != "gtype"}
    src = make_llama_gguf(str(tmp_path / "f16.gguf"), **shape, arch="olmo2", norm_eps=1e-6,
                          gtype=GGMLType.F16, seed=5, with_tokenizer=True)
    want, got = str(tmp_path / "z.gguf"), str(tmp_path / "t.gguf")
    quantize_file(src, want, "Q4_K_M", quiet=True)
    types = tq.quantize_file(src, got, "Q4_K_M", quiet=True)
    assert open(got, "rb").read() == open(want, "rb").read()
    assert types["blk.0.attn_q_norm.weight"][:2] == ("F32", "F32")
    assert types["blk.1.post_ffw_norm.weight"][:2] == ("F32", "F32")
    assert types["blk.0.attn_v.weight"][:2] == ("F16", "Q6_K")
    assert types["blk.0.attn_q.weight"][:2] == ("F16", "Q4_K")


def test_cli_writes_the_same_file(f16_gguf, tmp_path):
    from tools.quantize import quantize_file

    want, got = str(tmp_path / "z.gguf"), str(tmp_path / "t.gguf")
    quantize_file(f16_gguf, want, "Q4_K_M", quiet=True)
    tq.main([f16_gguf, got, "Q4_K_M"])
    assert open(got, "rb").read() == open(want, "rb").read()


def test_pick_type_matches_every_preset():
    """Every preset names the same type as zllm's for every role, including
    the F16 fallback of rows no block divides."""
    from tools.quantize import FTYPES, pick_type

    assert sorted(tq.FTYPES) == sorted(FTYPES)
    names = ["token_embd.weight", "output.weight", "output_norm.weight"] + [
        f"blk.{il}.{t}.weight" for il in range(5)
        for t in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down")]
    for ftype in FTYPES:
        for name in names:
            il = int(name.split(".")[1]) if name.startswith("blk.") else 0
            for shape in ((512, 256), (512, 96), (256,)):
                want = pick_type(name, shape, il, 5, FTYPES[ftype])
                assert tq.pick_type(name, shape, il, 5, tq.FTYPES[ftype]) == want, (ftype, name)


def test_unported_encoder_raises_before_writing(f16_gguf, tmp_path, monkeypatch):
    """A preset naming a type the port has no encoder for (Q8_1, which
    zllm encodes) raises before anything is written."""
    monkeypatch.setitem(tq.FTYPES, "Q8_1", dict(default=GGMLType.Q8_1))
    out = str(tmp_path / "q8_1.gguf")
    with pytest.raises(NotImplementedError, match="Q8_1"):
        tq.quantize_file(f16_gguf, out, "Q8_1", quiet=True)
    assert not os.path.exists(out)


def test_iq2_xxs_writes_zllms_bytes(f16_gguf, tmp_path):
    """IQ2_XXS, the grid fit on the CPU: the same file as tools/quantize.py."""
    from tools.quantize import quantize_file

    want, got = str(tmp_path / "z.gguf"), str(tmp_path / "t.gguf")
    zstats = quantize_file(f16_gguf, want, "IQ2_XXS", quiet=True)
    tq.main([f16_gguf, got, "IQ2_XXS", "--device", "cpu"])
    assert open(got, "rb").read() == open(want, "rb").read()
    assert tq.quantize_file(f16_gguf, str(tmp_path / "t2.gguf"), "IQ2_XXS", quiet=True,
                            device="cpu") == zstats


def test_q4km_tensor_types_round_trip(f16_gguf, tmp_path):
    """The written Q4_K_M file reads back with the planned types and
    decodes within the formats' own error of the F16 source."""
    from zllm_torch.gguf import read_gguf

    out = str(tmp_path / "m.gguf")
    types = tq.quantize_file(f16_gguf, out, "Q4_K_M", quiet=True)
    with read_gguf(f16_gguf) as src, read_gguf(out) as f:
        for name, meta in f.tensors.items():
            assert meta.gtype == GGMLType[types[name][1]], name
            a, b = f.tensor_f32(name), src.tensor_f32(name)
            assert a.shape == b.shape
            rel = np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2))
            assert rel < 0.1, (name, rel)  # Q4_K's 4 bits: ~5e-2 on Gaussian weights
