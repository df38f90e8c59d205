"""The importance-matrix slice on the CPU, against zllm: the activation taps
of `forward(..., taps=)` and `zllm_torch.imatrix` against
`tools/imatrix.py` (`zllm_torch.quantize --imatrix`:
tests/test_torch_quantize_imatrix.py).

  * taps: 2-layer llama, OLMo-2 and Qwen3 files with F32 weights (dense
    f32 matmuls on both sides): the same keys as zllm's taps, each tap of
    the GGUF tensor's width and within nmse 1e-6 of zllm's (measured
    under 1e-12), with no padding or permutation of the loader's in them;
  * collection: 4 chunks at batch 2 (two forwards of B = 2, no cache):
    sums within rtol 1e-4 of zllm's, counts equal; a last odd chunk runs
    alone at B = 1 and counts its tokens only (zllm pads it with an
    all-zero row and counts that: a quirk not copied), and a corpus
    shorter than one context raises;
  * files: zllm's reader reads the port's file and the port's reader
    zllm's, to equal dicts."""

import os
import sys

import numpy as np
import pytest
import torch
from test_torch_oracle import nmse, to_np

from zllm.gguf.constants import GGMLType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

SHAPE = dict(n_layers=2, n_embd=128, n_heads=4, n_kv_heads=2, n_ff=256, vocab_size=256)
ARCHES = {"llama": {}, "olmo2": dict(arch="olmo2", n_kv_heads=4, norm_eps=1e-6),
          "qwen3": dict(arch="qwen3", head_dim=64, tied=True, norm_eps=1e-6)}
CTX = 32


@pytest.fixture(scope="module")
def f32_files(tmp_path_factory):
    from zllm_torch.testing import make_llama_gguf

    folder = tmp_path_factory.mktemp("imatrix")
    return {arch: make_llama_gguf(str(folder / f"{arch}.gguf"), **dict(SHAPE, **extra),
                                  gtype=GGMLType.F32, seed=7)
            for arch, extra in ARCHES.items()}


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(3, SHAPE["vocab_size"], n).tolist()


def _zllm_model(path):
    import jax.numpy as jnp

    from zllm.models.loader import Model

    return Model.load(path, quantized=False, dtype=jnp.float32)


def _port_model(path):
    from zllm_torch.models.loader import Model

    return Model.load(path, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("arch", list(ARCHES))
def test_taps_match_zllm(f32_files, arch):
    import jax
    import jax.numpy as jnp

    from zllm.models.llama import forward as zforward

    from zllm_torch.models.llama import forward

    zm, tm = _zllm_model(f32_files[arch]), _port_model(f32_files[arch])
    toks = np.asarray(_ids(2 * CTX, 1), np.int32).reshape(2, CTX)
    pos = np.broadcast_to(np.arange(CTX, dtype=np.int32), (2, CTX))

    @jax.jit
    def ztaps(params, t, p):
        taps: dict = {}
        zforward(params, zm.cfg, t, p, None, taps=taps)
        return taps

    want = {k: to_np(v) for k, v in ztaps(zm.params, jnp.asarray(toks), jnp.asarray(pos)).items()}
    got: dict = {}
    with torch.inference_mode():
        forward(tm.params, tm.cfg, torch.from_numpy(toks), torch.from_numpy(pos.copy()), None,
                taps=got)
    assert set(got) == set(want)
    assert len(got) == 5 * SHAPE["n_layers"] + 1
    q_dim = 4 * (64 if arch == "qwen3" else SHAPE["n_embd"] // 4)
    widths = {"attn_q.weight": SHAPE["n_embd"], "attn_output.weight": q_dim,
              "ffn_gate.weight": SHAPE["n_embd"], "ffn_down.weight": SHAPE["n_ff"],
              "l_out": SHAPE["n_embd"]}
    for name, v in got.items():
        role = name.split(".", 2)[-1] if name.startswith("blk.") else name
        assert tuple(v.shape) == (2, CTX, widths.get(role, SHAPE["n_embd"])), name
        assert nmse(to_np(v), want[name]) <= 1e-6, name


def test_collect_matches_zllm(f32_files):
    from imatrix import collect_imatrix as zcollect

    from zllm_torch.imatrix import collect_imatrix

    ids = _ids(4 * CTX)
    zs, zc = zcollect(_zllm_model(f32_files["llama"]), ids, n_ctx=CTX, batch=2, progress=False)
    ts, tc = collect_imatrix(_port_model(f32_files["llama"]), ids, n_ctx=CTX, batch=2)
    assert set(ts) == set(zs) and tc == zc
    for name in zs:
        np.testing.assert_allclose(ts[name], zs[name], rtol=1e-4, err_msg=name)


def test_odd_last_chunk_runs_alone(f32_files):
    """3 chunks at batch 2: the third runs at B = 1, the sums are the
    three chunks' own (as one chunk at a time gives them), counted 3 x ctx."""
    from zllm_torch.imatrix import collect_imatrix

    m = _port_model(f32_files["llama"])
    ids = _ids(3 * CTX + 5)  # and 5 tokens no whole chunk takes
    s2, c2 = collect_imatrix(m, ids, n_ctx=CTX, batch=2)
    s1, c1 = collect_imatrix(m, ids, n_ctx=CTX, batch=1)
    assert c2 == c1 and set(c2.values()) == {3 * CTX}
    for name in s1:
        np.testing.assert_allclose(s2[name], s1[name], rtol=1e-5, err_msg=name)


def test_short_corpus_raises(f32_files):
    from zllm_torch.imatrix import collect_imatrix

    with pytest.raises(ValueError, match="fewer than one context"):
        collect_imatrix(_port_model(f32_files["llama"]), _ids(CTX - 1), n_ctx=CTX, batch=2)


def test_files_cross_read(f32_files, tmp_path):
    from imatrix import read_imatrix as zread
    from imatrix import write_imatrix as zwrite

    from zllm_torch.imatrix import collect_imatrix, read_imatrix, write_imatrix

    sums, counts = collect_imatrix(_port_model(f32_files["llama"]), _ids(2 * CTX), n_ctx=CTX)
    mine, theirs = str(tmp_path / "t.imatrix.gguf"), str(tmp_path / "z.imatrix.gguf")
    write_imatrix(mine, f32_files["llama"], sums, counts, n_ctx=CTX)
    zwrite(theirs, f32_files["llama"], sums, counts)
    for a, b in ((zread(mine), read_imatrix(mine)), (read_imatrix(theirs), zread(theirs))):
        assert set(a) == set(b) == set(sums)
        for name in a:
            assert np.array_equal(a[name], b[name]), name
            np.testing.assert_allclose(a[name], sums[name] / counts[name], rtol=1e-6)


def test_cli_writes_the_file(f32_files, tmp_path):
    """python -m zllm_torch.imatrix on a file with a byte-level vocab."""
    from zllm_torch import imatrix as ti
    from zllm_torch.testing import make_llama_gguf

    model = make_llama_gguf(str(tmp_path / "m.gguf"), **dict(SHAPE, n_embd=256, n_ff=512, vocab_size=512),
                            gtype=GGMLType.Q8_0, seed=3, with_tokenizer=True)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("The quick brown fox jumps over the lazy dog. " * 4)
    out = str(tmp_path / "m.imatrix.gguf")
    ti.main([model, str(corpus), out, "--ctx", "64", "--device", "cpu"])
    back = ti.read_imatrix(out)
    assert len(back) == 5 * SHAPE["n_layers"] + 1
    assert back["blk.1.ffn_down.weight"].shape == (512,)
    assert all(np.all(np.isfinite(v)) and np.all(v >= 0) for v in back.values())
