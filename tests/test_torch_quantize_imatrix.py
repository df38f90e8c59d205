"""`zllm_torch.quantize --imatrix` against `tools/quantize.py --imatrix` on
the CPU, with an importance matrix the port collected
(`zllm_torch.imatrix.collect_imatrix`).

  * every preset, with and without the imatrix (the IQ grid fit on
    device="cpu"), writes tools/quantize.py's bytes and stats on a
    1-layer F16 file;
  * Q4_K_M --imatrix by the CLI on the oracle's 2-layer F16 file: the same
    bytes and stats; attn_v, which zllm taps under no name, is quantized
    unweighted;
  * IQ2_XXS and IQ1_M with the imatrix write zllm's bytes (every 256-block
    of every tensor equal), and the port runs the file as zllm does:
    prefill and 4 teacher-forced decode-step logits within nmse 2e-4
    (zllm's kernels in interpret mode) and the same greedy tokens."""

import os
import sys

import numpy as np
import pytest
import torch
from test_torch_oracle import f16_llama_gguf, nmse, to_np

from zllm.gguf.constants import GGMLType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

CTX = 32
VOCAB = 256


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(3, VOCAB, n).tolist()


def _port_model(path):
    from zllm_torch.models.loader import Model

    return Model.load(path, device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def f16_with_imatrix(tmp_path_factory):
    """The oracle's F16 llama and an imatrix the port collected on it."""
    from zllm_torch.imatrix import collect_imatrix, write_imatrix

    folder = tmp_path_factory.mktemp("q")
    src = f16_llama_gguf(str(folder / "f16.gguf"), seed=2)
    sums, counts = collect_imatrix(_port_model(src), _ids(4 * CTX, 2), n_ctx=CTX)
    im = str(folder / "f16.imatrix.gguf")
    write_imatrix(im, src, sums, counts, n_ctx=CTX)
    return src, im


def _zllm_quantize(src, dst, ftype, im):
    from imatrix import read_imatrix as zread
    from quantize import quantize_file

    return quantize_file(src, dst, ftype, zread(im), quiet=True)


def test_q4km_with_imatrix_writes_zllms_bytes(f16_with_imatrix, tmp_path):
    from zllm_torch import quantize as tq
    from zllm_torch.imatrix import read_imatrix

    src, im = f16_with_imatrix
    want, got = str(tmp_path / "z.gguf"), str(tmp_path / "t.gguf")
    zstats = _zllm_quantize(src, want, "Q4_K_M", im)
    tq.main([src, got, "Q4_K_M", "--imatrix", im])
    assert open(got, "rb").read() == open(want, "rb").read()
    stats = tq.quantize_file(src, str(tmp_path / "t2.gguf"), "Q4_K_M", read_imatrix(im),
                             quiet=True)
    assert stats == zstats
    # attn_v and ffn_up have no tap: unweighted, as in zllm
    plain = tq.quantize_file(src, str(tmp_path / "p.gguf"), "Q4_K_M", quiet=True)
    assert stats["blk.0.attn_v.weight"] == plain["blk.0.attn_v.weight"]
    assert stats["blk.0.attn_q.weight"] != plain["blk.0.attn_q.weight"]


@pytest.fixture(scope="module")
def one_layer_f16(tmp_path_factory):
    """A 1-layer F16 llama (n_embd 256, n_ff 256: every row a whole
    super-block) and an imatrix the port collected on it."""
    from zllm_torch.imatrix import collect_imatrix, write_imatrix
    from zllm_torch.testing import make_llama_gguf

    folder = tmp_path_factory.mktemp("presets")
    src = make_llama_gguf(str(folder / "f16.gguf"), n_layers=1, n_embd=256, n_heads=4,
                          n_kv_heads=2, n_ff=256, vocab_size=320, gtype=GGMLType.F16, seed=5,
                          with_tokenizer=True)
    sums, counts = collect_imatrix(_port_model(src), _ids(2 * CTX, 5), n_ctx=CTX)
    im = str(folder / "f16.imatrix.gguf")
    write_imatrix(im, src, sums, counts, n_ctx=CTX)
    return src, im


def _presets():
    from zllm_torch.quantize import FTYPES

    return sorted(FTYPES)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "imatrix"])
@pytest.mark.parametrize("ftype", _presets())
def test_every_preset_writes_zllms_bytes(one_layer_f16, tmp_path, ftype, weighted):
    """Every preset, with and without the imatrix (the IQ grid fit on the
    CPU): tools/quantize.py's file, byte for byte, and its stats."""
    from quantize import quantize_file

    from zllm_torch import quantize as tq
    from zllm_torch.imatrix import read_imatrix

    src, im = one_layer_f16
    want, got = str(tmp_path / "z.gguf"), str(tmp_path / "t.gguf")
    if weighted:
        zstats = _zllm_quantize(src, want, ftype, im)
        stats = tq.quantize_file(src, got, ftype, read_imatrix(im), quiet=True, device="cpu")
    else:
        zstats = quantize_file(src, want, ftype, quiet=True)
        stats = tq.quantize_file(src, got, ftype, quiet=True, device="cpu")
    assert open(got, "rb").read() == open(want, "rb").read()
    assert stats == zstats


def _equal_share(a: str, b: str) -> dict:
    """The share of equal blocks of each tensor of two GGUF files."""
    from zllm_torch.gguf import read_gguf
    from zllm_torch.gguf.constants import GGML_BLOCK_SIZES

    out = {}
    with read_gguf(a) as fa, read_gguf(b) as fb:
        assert list(fa.tensors) == list(fb.tensors)
        for name, meta in fa.tensors.items():
            assert fb.tensors[name].gtype == meta.gtype, name
            bsz = GGML_BLOCK_SIZES[meta.gtype][1]
            x = np.asarray(fa.tensor_bytes(name)).reshape(-1, bsz)
            y = np.asarray(fb.tensor_bytes(name)).reshape(-1, bsz)
            out[name] = float((x == y).all(1).mean())
    return out


def _zllm_logits(path, steps):
    import jax.numpy as jnp

    from zllm.models.loader import Model
    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.runtime.generate import Generator

    qmatmul.install(interpret=True)
    try:
        gen = Generator(Model.load(path, dtype=jnp.float32), max_len=128, prefill_chunk=16,
                        kv_dtype=jnp.float32)
        prompt = [1] + list(range(40, 59))
        logits = [to_np(gen.prefill(prompt))]
        toks = [int(np.argmax(logits[0]))]
        for i in range(steps):
            tok = jnp.full((1, 1), toks[-1], jnp.int32)
            pos = jnp.full((1, 1), len(prompt) + i, jnp.int32)
            lg, gen.kv = gen._step(tok, pos, gen.kv, logits_for="last")
            logits.append(to_np(lg[0, -1]))
            toks.append(int(np.argmax(logits[-1])))
    finally:
        linmod.set_fused_matmul(None)
        linmod.set_fused_decode(None, None)
    return prompt, logits, toks


@pytest.mark.parametrize("ftype", ["IQ2_XXS", "IQ1_M"])
def test_iq_preset_with_imatrix(f16_with_imatrix, tmp_path, ftype):
    from zllm_torch import quantize as tq
    from zllm_torch.imatrix import read_imatrix
    from zllm_torch.runtime.generate import Generator

    src, im = f16_with_imatrix
    want, got = str(tmp_path / "z.gguf"), str(tmp_path / "t.gguf")
    zstats = _zllm_quantize(src, want, ftype, im)
    stats = tq.quantize_file(src, got, ftype, read_imatrix(im), quiet=True, device="cpu")
    shares = _equal_share(got, want)
    assert all(v == 1.0 for v in shares.values()), {k: v for k, v in shares.items() if v < 1}
    assert open(got, "rb").read() == open(want, "rb").read()
    assert stats == zstats
    assert stats["blk.0.ffn_gate.weight"][1] == ftype
    prompt, zlog, ztoks = _zllm_logits(got, 4)
    gen = Generator(_port_model(got), max_len=128, prefill_chunk=16, kv_dtype=torch.float32)
    tlog = [to_np(gen.prefill(prompt))]
    for i in range(4):
        tlog.append(to_np(gen._decode_one(ztoks[i], len(prompt) + i)))
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert nmse(a, b) <= 2e-4, f"step {step}: nmse {nmse(a, b)}"
    gen.reset()
    assert gen.generate(prompt, max_new=5).tokens == ztoks
