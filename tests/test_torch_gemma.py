"""The Gemma text families (gemma, gemma2, gemma3) in the port against zllm
on the CPU.

Files:
  * gemma2 and gemma3 come from zllm's `convert_hf_llama` on a seeded numpy
    state dict in `tests/test_arch_parity.py`'s ARCH_CFGS geometry (4 and 7
    layers, 4 / 2 heads of 16, window 32: Gemma-2's layers 0 and 2 and
    Gemma-3's 0-4 and 6 windowed, so local and full layers both run; the
    sandwich norms stored as w + 1, softcaps and query_pre_attn_scalar as
    the converter writes them); a head_dim-64 form of each (`*_d64`);
  * gemma (Gemma-1: no window, MQA) and the Q4_K files (n_embd 256, 4 / 2
    heads of 64, window 32) come from the port's factory.

Checks:
  * the config and every loaded weight equal zllm's, and `params_from_jax`
    carries every Gemma leaf (the post-norms, Gemma-3's q/k norms, the tied
    head);
  * F32 weights: the prefill's 3 chunk logits and 16 teacher-forced decode
    steps, all past the 32-token window, within nmse 1e-5 of zllm's forward
    over the contiguous cache; Q4_K weights, zllm's Pallas kernels in
    interpret mode against the port's plain versions, nmse <= 1e-3;
  * greedy `Generator.generate` gives zllm's tokens and text;
  * `geglu` equals zllm's (f32 and bf16); the embedding's sqrt(n_embd)
    rounds in the embedding's dtype, as zllm's;
  * dispatch: a decode step over the contiguous cache hands K2 each
    layer's window and its own kind of rope (Gemma-3: a windowed and a full
    layer at one position rotate apart), and runs Gemma's FFN unfused."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_arch_parity import ARCH_CFGS
from test_torch_oracle import gemma_hf_state, gemma_tokenizer_kv, jax_params_numpy, nmse, to_np

from zllm.gguf.constants import GGMLType

WINDOW = 32
PROMPT = [2] + list(range(40, 79))  # 40 tokens: chunks of 16, 16 and 8, past the window
CHUNK = 16
N_DECODE = 16
VARIANTS = {"gemma2": ARCH_CFGS["gemma2"], "gemma3": ARCH_CFGS["gemma3"],
            "gemma2_d64": dict(ARCH_CFGS["gemma2"], head_dim=64, query_pre_attn_scalar=64),
            "gemma3_d64": dict(ARCH_CFGS["gemma3"], head_dim=64, num_hidden_layers=6)}
# the factory's files: Gemma-1 (MQA, no window) in F32, and Q4_K Gemma-2/3
FACTORY = {
    "gemma": dict(arch="gemma", n_layers=2, n_embd=64, n_heads=4, n_kv_heads=1, head_dim=32,
                  n_ff=96, vocab_size=300, norm_eps=1e-6, gtype=GGMLType.F32),
    "gemma2_q4k": dict(arch="gemma2", n_layers=4, n_embd=256, n_heads=4, n_kv_heads=2,
                       head_dim=64, n_ff=512, vocab_size=512, norm_eps=1e-6,
                       sliding_window=WINDOW, query_pre_attn_scalar=64, attn_softcap=50.0,
                       final_softcap=30.0, gtype=GGMLType.Q4_K),
    "gemma3_q4k": dict(arch="gemma3", n_layers=6, n_embd=256, n_heads=4, n_kv_heads=2,
                       head_dim=64, n_ff=512, vocab_size=512, norm_eps=1e-6,
                       sliding_window=WINDOW, query_pre_attn_scalar=64, rope_base=1e6,
                       rope_base_swa=10000.0, rope_scale=8.0, gtype=GGMLType.Q4_K),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from zllm.convert import convert_hf_llama
    from zllm_torch.testing import make_llama_gguf

    folder = tmp_path_factory.mktemp("gemma")
    out = {}
    for i, (name, cfg) in enumerate(VARIANTS.items()):
        cfg = dict(cfg, vocab_size=300)  # room for the byte vocab
        out[name] = convert_hf_llama(gemma_hf_state(cfg, i), cfg, str(folder / f"{name}.gguf"),
                                     arch=name.split("_")[0], gtype=GGMLType.F32,
                                     tokenizer_kv=gemma_tokenizer_kv(300))
    for name, kw in FACTORY.items():
        out[name] = make_llama_gguf(str(folder / f"{name}.gguf"), **kw, with_tokenizer=True)
    return out


def _zllm_logits(path, kernels: bool):
    """zllm's prefill chunk logits and 16 teacher-forced decode steps (f32
    cache), its greedy tokens driving both sides."""
    import jax.numpy as jnp

    from zllm.models.loader import Model
    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.runtime.generate import Generator

    m = Model.load(path, dtype=jnp.float32)
    if kernels:
        qmatmul.install(interpret=True)
    try:
        gen = Generator(m, max_len=128, prefill_chunk=CHUNK, kv_dtype=jnp.float32)
        logits = [to_np(gen.prefill(PROMPT))]
        toks = [int(np.argmax(logits[0]))]
        for i in range(N_DECODE):
            tok = jnp.full((1, 1), toks[-1], jnp.int32)
            pos = jnp.full((1, 1), len(PROMPT) + i, jnp.int32)
            lg, gen.kv = gen._step(tok, pos, gen.kv, logits_for="last")
            logits.append(to_np(lg[0, -1]))
            toks.append(int(np.argmax(logits[-1])))
    finally:
        linmod.set_fused_matmul(None)
        linmod.set_fused_decode(None, None)
    return logits, toks


def _port_logits(path, toks):
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    m = Model.load(path, device="cpu", dtype=torch.float32)
    gen = Generator(m, max_len=128, prefill_chunk=CHUNK, kv_dtype=torch.float32)
    logits = [to_np(gen.prefill(PROMPT))]
    for i in range(N_DECODE):
        logits.append(to_np(gen._decode_one(toks[i], len(PROMPT) + i)))
    return logits


CFG_FIELDS = ("arch", "n_layers", "n_embd", "n_heads", "n_kv_heads", "head_dim", "n_ff",
              "vocab_size", "ctx_len", "norm_eps", "attn_logit_softcap", "final_logit_softcap",
              "logit_scale", "attn_scale", "sliding_window", "swa_pattern", "act")
NORMS = {"gemma": set(), "gemma2": {"attn_post_norm", "ffn_post_norm"},
         "gemma3": {"attn_post_norm", "ffn_post_norm", "attn_q_norm", "attn_k_norm"}}


@pytest.mark.parametrize("name", ["gemma", "gemma2", "gemma3", "gemma2_q4k", "gemma3_q4k"])
def test_config_and_weights_equal_zllm(files, name):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm_torch.models.loader import Model, params_from_jax
    from zllm_torch.quant.repack import QWeight

    zm = ZModel.load(files[name], dtype=jnp.float32)
    tm = Model.load(files[name], device="cpu", dtype=torch.float32)
    for field in CFG_FIELDS:
        assert getattr(tm.cfg, field) == getattr(zm.cfg, field), field
    assert tuple(tm.cfg.rope) == tuple(zm.cfg.rope) and tm.cfg.rope.style == "neox"
    assert (tm.cfg.rope_swa is None) == (zm.cfg.rope_swa is None)
    if tm.cfg.rope_swa is not None:
        assert tuple(tm.cfg.rope_swa) == tuple(zm.cfg.rope_swa)
    assert not tm.cfg.neox_permuted and tm.cfg.tie_embedding and tm.cfg.act == "gelu"
    for il in range(tm.cfg.n_layers):
        assert tm.cfg.is_swa_layer(il) == zm.cfg.is_swa_layer(il), il
    carried = params_from_jax(jax_params_numpy(zm.params), device="cpu", dtype=torch.float32)
    assert set(tm.params) == set(carried) == {"tok_emb", "out_norm", "output", "layers"}
    for key in ("tok_emb", "out_norm", "output"):
        assert torch.equal(tm.params[key], carried[key]), key
    arch = tm.cfg.arch
    for il, (layer, zlayer) in enumerate(zip(tm.params["layers"], carried["layers"])):
        assert set(layer) == set(zlayer) == {"wqkv", "wo", "ffn_gateup", "ffn_down",
                                             "attn_norm", "ffn_norm"} | NORMS[arch]
        for key, a in layer.items():
            b = zlayer[key]
            assert type(a) is type(b), (il, key)
            if isinstance(a, QWeight):
                for plane, val in a.planes().items():
                    assert torch.equal(val, b.planes()[plane]), (il, key, plane)
            else:
                assert a.dtype == b.dtype and torch.equal(a, b), (il, key)
    if arch == "gemma3":
        assert tm.params["layers"][0]["attn_q_norm"].shape == (tm.cfg.head_dim,)


@pytest.mark.parametrize("name", [*VARIANTS, "gemma"])
def test_f32_logits_match_zllm_forward(files, name):
    zlog, ztoks = _zllm_logits(files[name], kernels=False)
    tlog = _port_logits(files[name], ztoks)
    assert len(tlog) == len(zlog) == N_DECODE + 1
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (300,)
        assert nmse(a, b) <= 1e-5, f"step {step}: nmse {nmse(a, b)}"


@pytest.mark.parametrize("name", ["gemma2_q4k", "gemma3_q4k"])
def test_q4k_logits_match_zllm_kernels(files, name):
    zlog, ztoks = _zllm_logits(files[name], kernels=True)
    tlog = _port_logits(files[name], ztoks)
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert nmse(a, b) <= 1e-3, f"step {step}: nmse {nmse(a, b)}"


@pytest.mark.parametrize("name", ["gemma", "gemma2", "gemma3"])
def test_greedy_generate_matches_zllm(files, name):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.runtime.generate import Generator as ZGenerator
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    zm = ZModel.load(files[name], dtype=jnp.float32)
    tm = Model.load(files[name], device="cpu", dtype=torch.float32)
    text = "Grüße aus 東京, it's a long way past the window of thirty-two tokens!"
    prompt = tm.tokenizer.encode(text, add_special=True)
    assert prompt == zm.tokenizer.encode(text, add_special=True) and len(prompt) > WINDOW
    zres = ZGenerator(zm, max_len=128, prefill_chunk=CHUNK, kv_dtype=jnp.float32).generate(
        prompt, max_new=16)
    tres = Generator(tm, max_len=128, prefill_chunk=CHUNK, kv_dtype=torch.float32).generate(
        prompt, max_new=16)
    assert tres.tokens == list(zres.tokens) and len(tres.tokens) == 16
    assert tres.text == zres.text


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_matches_zllm(dtype):
    import jax.numpy as jnp

    from zllm.ops.layers import geglu as zgeglu
    from zllm_torch.ops.layers import geglu

    rng = np.random.default_rng(3)
    g, u = (rng.standard_normal((7, 96)).astype(np.float32) * 3 for _ in range(2))
    want = to_np(zgeglu(jnp.asarray(g, dtype), jnp.asarray(u, dtype)))
    got = geglu(torch.from_numpy(g).to(getattr(torch, dtype)),
                torch.from_numpy(u).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert nmse(to_np(got), want) <= 1e-12
    else:  # one bf16 rounding of the gelu and one of the product apart at most
        assert np.abs(to_np(got) - want).max() <= 2 ** -6 * np.abs(want).max()


def test_embedding_scale_rounds_in_the_embedding_dtype():
    """sqrt(2560) = 50.596 is 50.5 in bf16: zllm multiplies the bf16 rows
    by 50.5, and so does the port, not by the f32 scale rounded once."""
    import jax.numpy as jnp

    from zllm.models.llama import embed as zembed
    from zllm_torch.models.llama import embed

    rng = np.random.default_rng(4)
    table = rng.standard_normal((64, 2560)).astype(np.float32)
    toks = np.array([[3, 17, 63]], np.int32)
    zcfg = SimpleNamespace(arch="gemma3", n_embd=2560, emb_scale=1.0)
    want = zembed({"tok_emb": jnp.asarray(table, jnp.bfloat16)}, zcfg, jnp.asarray(toks))
    cfg = SimpleNamespace(arch="gemma3", n_embd=2560)
    tb = torch.from_numpy(table).to(torch.bfloat16)
    got = embed({"tok_emb": tb}, cfg, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(to_np(got), to_np(want))
    once = (tb[torch.from_numpy(toks).long()].float() * math.sqrt(2560)).to(torch.bfloat16)
    assert not torch.equal(got, once)  # the rounding point shows
    assert torch.equal(embed({"tok_emb": tb}, SimpleNamespace(arch="llama", n_embd=2560),
                             torch.from_numpy(toks)), tb[torch.from_numpy(toks).long()])


def test_k2_ropes_give_each_layer_its_own_kind():
    """A Gemma-3 windowed layer (rope base 1e4) and a full one (1e6, linear
    x8) at the same position: `_k2_ropes` builds one table a kind, they
    differ, and each equals `rope_table` of its layer's rope."""
    from zllm_torch.models import llama
    from zllm_torch.models.config import ModelConfig
    from zllm_torch.ops.layers import RopeParams, rope_table

    full = RopeParams(dim=64, base=1e6, style="neox", scaling="linear", scale_factor=8.0)
    cfg = ModelConfig(arch="gemma3", n_layers=6, n_embd=256, n_heads=4, n_kv_heads=2,
                      head_dim=64, n_ff=512, vocab_size=512, rope=full,
                      rope_swa=full._replace(base=1e4, scaling="none", scale_factor=1.0),
                      sliding_window=32, swa_pattern=6)
    assert cfg.layer_window(0) == 32 and cfg.layer_window(5) == 0
    local, glob = cfg.layer_rope(0), cfg.layer_rope(5)
    assert local != glob and glob == full
    pos = torch.tensor([[37, 38]], dtype=torch.int32)
    tables = llama._k2_ropes(pos, cfg, False, [cfg.layer_rope(il) for il in range(6)])
    assert set(tables) == {local, glob}
    for p in (local, glob):
        want = rope_table(pos[:, 0], p, 64)
        assert torch.equal(tables[p].cos, want.cos) and torch.equal(tables[p].sin, want.sin)
    assert not torch.allclose(tables[local].cos, tables[glob].cos)
    per_col = llama._k2_ropes(pos, cfg, True, [local, glob])
    assert torch.equal(per_col[glob][1].cos, rope_table(pos[:, 1], glob, 64).cos)


def test_windowed_and_full_layers_insert_apart(files, monkeypatch):
    """One Gemma-3 decode step over the contiguous cache: K2 (its plain
    version here) gets each layer's window and its own kind's rope table,
    so a windowed and a full layer fed the same projection row at the same
    position write differently rotated K rows; the FFN runs unfused (no
    fused glu matvec)."""
    from zllm_torch.models import llama
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.kvcache import KVCache

    m = Model.load(files["gemma3_q4k"], device="cpu", dtype=torch.float32)
    cfg = m.cfg
    calls, glu = [], []
    real = llama.attn_decode_qkv

    def spy(qkv3, kc, vc, positions, rope, qw=None, kw=None, **kw_):
        calls.append((rope, kw_["window"], qw is not None))
        return real(qkv3, kc, vc, positions, rope, qw, kw, **kw_)

    monkeypatch.setattr(llama, "attn_decode_qkv", spy)
    monkeypatch.setattr(llama, "fused_glu_linear", lambda *a: glu.append(1))
    kv = KVCache.create(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim, torch.float32, "cpu")
    llama.forward(m.params, cfg, torch.tensor([[5]], dtype=torch.int32),
                  torch.tensor([[40]], dtype=torch.int32), kv, logits_for="last")
    assert [c[1] for c in calls] == [WINDOW] * 5 + [0] and all(c[2] for c in calls)
    assert calls[0][0] is calls[4][0] and calls[0][0] is not calls[5][0]
    assert not torch.equal(calls[0][0].cos, calls[5][0].cos) and not glu
    # the same raw row through a windowed and a full layer's table
    qkv3 = torch.randn(1, cfg.n_heads + 2 * cfg.n_kv_heads, cfg.head_dim)
    pos = torch.tensor([40], dtype=torch.int32)
    rows = []
    for rt in (calls[0][0], calls[5][0]):
        kc = torch.zeros(1, cfg.n_kv_heads, 64, cfg.head_dim)
        vc = torch.zeros_like(kc)
        real(qkv3, kc, vc, pos, rt, scale=0.125)
        rows.append(kc[0, :, 40])
    assert not torch.allclose(rows[0], rows[1])
