"""The layer-norm families (gptneox, stablelm, starcoder2) in the port against
zllm on the CPU.

Files:
  * F32 files from zllm's converters on seeded numpy state dicts in
    `tests/test_arch_parity.py`'s ARCH_CFGS geometry (2 layers, 64 wide, 4
    heads of 16; gptneox by `convert_hf_gptneox`: parallel residual, rope
    over 4 of 16 dims, exact gelu; stablelm by `convert_hf_llama`: q/k/v
    biases, rope over 4 of 16 dims, gated SiLU; starcoder2 by
    `convert_hf_llama`: biases everywhere, full rope, tanh gelu; 4 / 2 heads
    but gptneox's 4 / 4), a byte-level SPM vocab of 300;
  * Q4_K files from the port's factory (n_embd 256, 4 / 2 heads of 64, rope
    over 16 of 64 dims but starcoder2's 64; gptneox 4 / 4 heads, its q|k|v
    one fused attn_qkv weight and bias, as llama.cpp writes GPT-NeoX).

Checks, for each family:
  * the config and every loaded weight equal zllm's, and `params_from_jax`
    carries every new leaf (the LayerNorms' biases, bo, the MLP's biases);
    zllm leaves a fused attn_qkv.bias unmapped, the port loads it;
  * F32: the prefill's chunk logits and 16 teacher-forced decode steps over
    the contiguous cache within nmse 1e-5 of zllm's forward; Q4_K: zllm's
    Pallas kernels in interpret mode against the port's plain versions,
    nmse <= 1e-3 (zllm's gptneox given the q|k|v bias its loader drops);
  * greedy `Generator.generate` gives zllm's tokens and text;
  * `layer_norm` equals zllm's in f32 and bf16, with and without a bias,
    and so do both gelus; the parallel residual sums x + attention + FFN
    in zllm's order;
  * dispatch: a decode step hands K2 a rope table of rot_dims R and calls
    no fused_norm_linear or fused_glu_linear;
  * a 2-slot paged engine and a q8 engine each equal zllm's engine on the
    StarCoder2 file;
  * the `starcoder` pretokenizer equals zllm's on a text with digits,
    Unicode digits among them;
  * a stablelm file with StableLM-2-12B's per-head q/k LayerNorms is
    refused;
  * a gated file whose ffn_gate and ffn_up differ in format (so the
    loader keeps them apart) runs act(gate, up), as zllm's."""

import time

import numpy as np
import pytest
import torch
from test_arch_parity import ARCH_CFGS
from test_torch_oracle import gemma_tokenizer_kv, jax_params_numpy, nmse, to_np

from zllm.gguf.constants import GGMLType

ARCHES = ("gptneox", "stablelm", "starcoder2")
VOCAB = 300  # room for the byte vocab
PROMPT = [1] + list(range(40, 79))  # 40 tokens: chunks of 16, 16 and 8
CHUNK = 16
N_DECODE = 16
FACTORY = {f"{arch}_q4k": dict(arch=arch, n_layers=2, n_embd=256, n_heads=4,
                               n_kv_heads=4 if arch == "gptneox" else 2, head_dim=64,
                               rope_dim=None if arch == "starcoder2" else 16, n_ff=512,
                               vocab_size=512, gtype=GGMLType.Q4_K)
           for arch in ARCHES}


def hf_state(arch: str, cfg: dict, seed: int) -> dict:
    """A seeded HF-style state dict (numpy f32) of GPTNeoXForCausalLM,
    StableLmForCausalLM or Starcoder2ForCausalLM for `cfg`."""
    rng = np.random.default_rng(seed)
    e, v, f = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]
    hq = cfg["num_attention_heads"]
    hkv = cfg.get("num_key_value_heads", hq)
    d = e // hq

    def w(*shape, s=0.08):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def ln():  # a LayerNorm's weight near 1 and its bias
        return 1.0 + w(e, s=0.1), w(e, s=0.1)

    if arch == "gptneox":
        p0 = "gpt_neox."
        sd = {p0 + "embed_in.weight": w(v, e, s=0.3), "embed_out.weight": w(v, e)}
        sd[p0 + "final_layer_norm.weight"], sd[p0 + "final_layer_norm.bias"] = ln()
        for il in range(cfg["num_hidden_layers"]):
            p = f"{p0}layers.{il}."
            sd[p + "input_layernorm.weight"], sd[p + "input_layernorm.bias"] = ln()
            sd[p + "post_attention_layernorm.weight"], sd[p + "post_attention_layernorm.bias"] = ln()
            sd.update({p + "attention.query_key_value.weight": w(3 * e, e),
                       p + "attention.query_key_value.bias": w(3 * e, s=0.3),
                       p + "attention.dense.weight": w(e, e),
                       p + "attention.dense.bias": w(e, s=0.1),
                       p + "mlp.dense_h_to_4h.weight": w(f, e),
                       p + "mlp.dense_h_to_4h.bias": w(f, s=0.1),
                       p + "mlp.dense_4h_to_h.weight": w(e, f),
                       p + "mlp.dense_4h_to_h.bias": w(e, s=0.1)})
        return sd
    sd = {"model.embed_tokens.weight": w(v, e, s=0.3), "lm_head.weight": w(v, e)}
    sd["model.norm.weight"], sd["model.norm.bias"] = ln()
    for il in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{il}."
        sd[p + "input_layernorm.weight"], sd[p + "input_layernorm.bias"] = ln()
        sd[p + "post_attention_layernorm.weight"], sd[p + "post_attention_layernorm.bias"] = ln()
        sd.update({p + "self_attn.q_proj.weight": w(hq * d, e),
                   p + "self_attn.k_proj.weight": w(hkv * d, e),
                   p + "self_attn.v_proj.weight": w(hkv * d, e),
                   p + "self_attn.q_proj.bias": w(hq * d, s=0.3),
                   p + "self_attn.k_proj.bias": w(hkv * d, s=0.3),
                   p + "self_attn.v_proj.bias": w(hkv * d, s=0.3),
                   p + "self_attn.o_proj.weight": w(e, hq * d)})
        if arch == "starcoder2":
            sd.update({p + "self_attn.o_proj.bias": w(e, s=0.1),
                       p + "mlp.c_fc.weight": w(f, e), p + "mlp.c_fc.bias": w(f, s=0.1),
                       p + "mlp.c_proj.weight": w(e, f), p + "mlp.c_proj.bias": w(e, s=0.1)})
        else:
            sd.update({p + "mlp.gate_proj.weight": w(f, e), p + "mlp.up_proj.weight": w(f, e),
                       p + "mlp.down_proj.weight": w(e, f)})
    return sd


def convert(arch: str, path: str, seed: int = 0) -> str:
    """An F32 file of ARCH_CFGS[arch] (vocab VOCAB) by zllm's converter."""
    from zllm.convert import convert_hf_llama
    from zllm.convert.hf import convert_hf_gptneox

    cfg = dict(ARCH_CFGS[arch], vocab_size=VOCAB)
    kw = dict(gtype=GGMLType.F32, tokenizer_kv=gemma_tokenizer_kv(VOCAB))
    if arch == "gptneox":
        return convert_hf_gptneox(hf_state(arch, cfg, seed), cfg, path, **kw)
    return convert_hf_llama(hf_state(arch, cfg, seed), cfg, path, arch=arch, **kw)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from zllm_torch.testing import make_llama_gguf

    folder = tmp_path_factory.mktemp("layernorm")
    out = {arch: convert(arch, str(folder / f"{arch}.gguf"), i) for i, arch in enumerate(ARCHES)}
    for name, kw in FACTORY.items():
        out[name] = make_llama_gguf(str(folder / f"{name}.gguf"), **kw, with_tokenizer=True)
    return out


def _zllm_model(path):
    """zllm's model of `path`; a fused attn_qkv.bias, which zllm's loader
    leaves unmapped, added as the bqkv its forward reads."""
    import jax.numpy as jnp

    from zllm.gguf.reader import read_gguf
    from zllm.models.loader import Model

    m = Model.load(path, dtype=jnp.float32)
    with read_gguf(path) as f:
        for il, layer in enumerate(m.params["layers"]):
            name = f"blk.{il}.attn_qkv.bias"
            if name in f.tensors:
                assert "bqkv" not in layer
                layer["bqkv"] = jnp.asarray(f.tensor_f32(name))
    return m


def _zllm_logits(path, kernels: bool):
    """zllm's prefill logits and N_DECODE teacher-forced decode steps (f32
    cache), its greedy tokens driving both sides."""
    import jax.numpy as jnp

    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.runtime.generate import Generator

    m = _zllm_model(path)
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
              "vocab_size", "ctx_len", "norm_eps", "logit_scale", "attn_scale", "act",
              "norm_kind", "parallel_residual")
LAYER_KEYS = {"gptneox": {"wqkv", "bqkv", "wo", "bo", "ffn_up", "ffn_up_b", "ffn_down",
                          "ffn_down_b"},
              "stablelm": {"wqkv", "bqkv", "wo", "ffn_gateup", "ffn_down"},
              "starcoder2": {"wqkv", "bqkv", "wo", "bo", "ffn_up", "ffn_up_b", "ffn_down",
                             "ffn_down_b"}}
NORM_KEYS = {"attn_norm", "attn_norm_b", "ffn_norm", "ffn_norm_b"}


@pytest.mark.parametrize("name", [*ARCHES, *FACTORY])
def test_config_and_weights_equal_zllm(files, name):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm_torch.models.loader import Model, params_from_jax
    from zllm_torch.quant.repack import QWeight

    zm = ZModel.load(files[name], dtype=jnp.float32)
    tm = Model.load(files[name], device="cpu", dtype=torch.float32)
    arch = tm.cfg.arch
    for field in CFG_FIELDS:
        assert getattr(tm.cfg, field) == getattr(zm.cfg, field), field
    assert tuple(tm.cfg.rope) == tuple(zm.cfg.rope) and tm.cfg.rope.style == "neox"
    assert tm.cfg.rope.dim == (tm.cfg.head_dim if arch == "starcoder2" else tm.cfg.head_dim // 4)
    assert tm.cfg.norm_kind == "layer" and not tm.cfg.neox_permuted
    assert tm.cfg.parallel_residual == ("separate" if arch == "gptneox" else "none")
    carried = params_from_jax(jax_params_numpy(zm.params), device="cpu", dtype=torch.float32)
    assert set(tm.params) == set(carried) == {"tok_emb", "out_norm", "out_norm_b", "output",
                                              "layers"}
    def same(a, b, where):
        assert type(a) is type(b), where
        if isinstance(a, QWeight):
            for plane, val in a.planes().items():
                assert torch.equal(val, b.planes()[plane]), (where, plane)
        else:
            assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b), where

    for key in ("tok_emb", "out_norm", "out_norm_b", "output"):
        same(tm.params[key], carried[key], key)
    fused_bias = name == "gptneox_q4k"  # llama.cpp's attn_qkv.bias: zllm drops it
    for il, (layer, zlayer) in enumerate(zip(tm.params["layers"], carried["layers"])):
        assert set(layer) == LAYER_KEYS[arch] | NORM_KEYS
        assert set(zlayer) == set(layer) - ({"bqkv"} if fused_bias else set())
        for key, b in zlayer.items():
            same(layer[key], b, (il, key))
    if fused_bias:
        from zllm_torch.gguf import read_gguf

        with read_gguf(files[name]) as f:
            for il, layer in enumerate(tm.params["layers"]):
                want = torch.from_numpy(f.tensor_f32(f"blk.{il}.attn_qkv.bias"))
                assert torch.equal(layer["bqkv"], want)


@pytest.mark.parametrize("arch", ARCHES)
def test_f32_logits_match_zllm_forward(files, arch):
    zlog, ztoks = _zllm_logits(files[arch], kernels=False)
    tlog = _port_logits(files[arch], ztoks)
    assert len(tlog) == len(zlog) == N_DECODE + 1
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (VOCAB,)
        assert nmse(a, b) <= 1e-5, f"step {step}: nmse {nmse(a, b)}"


@pytest.mark.parametrize("name", list(FACTORY))
def test_q4k_logits_match_zllm_kernels(files, name):
    zlog, ztoks = _zllm_logits(files[name], kernels=True)
    tlog = _port_logits(files[name], ztoks)
    assert len(tlog) == N_DECODE + 1
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert nmse(a, b) <= 1e-3, f"step {step}: nmse {nmse(a, b)}"


@pytest.mark.parametrize("arch", ARCHES)
def test_greedy_generate_matches_zllm(files, arch):
    import jax.numpy as jnp

    from zllm.runtime.generate import Generator as ZGenerator
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    zm = _zllm_model(files[arch])
    tm = Model.load(files[arch], device="cpu", dtype=torch.float32)
    text = "Grüße aus 東京, 2024: it's a layer-norm model!"
    prompt = tm.tokenizer.encode(text, add_special=True)
    assert prompt == zm.tokenizer.encode(text, add_special=True)
    zres = ZGenerator(zm, max_len=128, prefill_chunk=CHUNK, kv_dtype=jnp.float32).generate(
        prompt, max_new=16)
    tres = Generator(tm, max_len=128, prefill_chunk=CHUNK, kv_dtype=torch.float32).generate(
        prompt, max_new=16)
    assert tres.tokens == list(zres.tokens) and len(tres.tokens) == 16
    assert tres.text == zres.text


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_zllm(dtype, bias):
    """Rows of mean 3 and spread 2 (the f32 mean's rounding shows in x -
    mu): the port's f64 moments against zllm's f32 ones."""
    import jax.numpy as jnp

    from zllm.ops.layers import layer_norm as zlayer_norm
    from zllm_torch.ops.layers import layer_norm

    rng = np.random.default_rng(5)
    x = (3.0 + 2.0 * rng.standard_normal((7, 96))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    b = (0.1 * rng.standard_normal(96)).astype(np.float32) if bias else None
    want = to_np(zlayer_norm(jnp.asarray(x, dtype), jnp.asarray(w),
                             None if b is None else jnp.asarray(b), 1e-5))
    got = layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w),
                     None if b is None else torch.from_numpy(b), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    assert np.abs(to_np(got) - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_zllm(dtype, exact):
    """Within 1e-6 of the largest value (zllm's 1 + erf(x / sqrt 2) loses
    digits to cancellation at negative x); in bf16 an element may also sit
    one bf16 rounding (2^-8 of it) apart, where that f32 difference carries
    it across a rounding boundary."""
    import jax
    import jax.numpy as jnp

    from zllm_torch.ops.layers import gelu

    rng = np.random.default_rng(6)
    x = (rng.standard_normal((7, 96)) * 3).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    want = to_np(jax.nn.gelu(xj.astype(jnp.float32), approximate=not exact).astype(xj.dtype))
    got = gelu(torch.from_numpy(x).to(getattr(torch, dtype)), exact=exact)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 * np.abs(want).max() + (2.0 ** -8 * np.abs(want) if dtype == "bfloat16" else 0)
    assert (np.abs(to_np(got) - want) <= tol).all()


def test_parallel_residual_sums_in_zllms_order(files, monkeypatch):
    """One gptneox block at T 20, no cache: its output is (x + attention) +
    FFN, bit for bit, with the FFN on ffn_norm of the block's input, and
    within f32 rounding of zllm's layer_forward on the same weights."""
    import jax.numpy as jnp

    from zllm.models.llama import layer_forward as zlayer_forward
    from zllm_torch.models import llama
    from zllm_torch.models.loader import Model

    zm = _zllm_model(files["gptneox"])
    m = Model.load(files["gptneox"], device="cpu", dtype=torch.float32)
    layer, cfg = m.params["layers"][0], m.cfg
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((1, 20, cfg.n_embd)) * 2).astype(np.float32)
    pos = np.arange(20, dtype=np.int32)[None]
    seen = {}
    real_ffn, real_wo = llama._ffn_core, llama._wo

    def ffn_spy(layer_, h, *a, **kw):
        seen["h2"], seen["ff"] = h, real_ffn(layer_, h, *a, **kw)
        return seen["ff"]

    def wo_spy(layer_, att):
        seen["o"] = real_wo(layer_, att)
        return seen["o"]

    monkeypatch.setattr(llama, "_ffn_core", ffn_spy)
    monkeypatch.setattr(llama, "_wo", wo_spy)
    xt = torch.from_numpy(x)
    got = llama.layer_forward(layer, cfg, xt, torch.from_numpy(pos), None, 0)
    assert torch.equal(seen["h2"], llama.block_norm(xt, layer, "ffn_norm", cfg))
    assert torch.equal(got, (xt + seen["o"]) + seen["ff"])
    other = xt + (seen["o"] + seen["ff"])
    assert not torch.equal(got, other)  # the order shows in the bits
    want, _ = zlayer_forward(zm.params["layers"][0], zm.cfg, jnp.asarray(x), jnp.asarray(pos),
                             None, 0)
    assert nmse(to_np(got), to_np(want)) <= 1e-12


@pytest.mark.parametrize("name", list(FACTORY))
def test_decode_step_dispatch(files, name, monkeypatch):
    """A decode step over the contiguous cache: K2 (its plain version here)
    gets a rope table of rot_dims R (16 of 64; StarCoder2 all 64), no fused
    norm or glu matvec runs (K1's prologue is an RMS norm), and its logits
    equal the forward's without the spies."""
    from zllm_torch.models import llama
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.kvcache import KVCache

    m = Model.load(files[name], device="cpu", dtype=torch.float32)
    cfg = m.cfg
    calls, fused = [], []
    real = llama.attn_decode_qkv

    def spy(qkv3, kc, vc, positions, rope, qw=None, kw=None, **kw_):
        calls.append(rope.rot_dims)
        return real(qkv3, kc, vc, positions, rope, qw, kw, **kw_)

    monkeypatch.setattr(llama, "attn_decode_qkv", spy)
    monkeypatch.setattr(llama, "fused_norm_linear", lambda *a: fused.append("norm"))
    monkeypatch.setattr(llama, "fused_glu_linear", lambda *a: fused.append("glu"))
    kv = KVCache.create(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim, torch.float32, "cpu")
    logits = llama.forward(m.params, cfg, torch.tensor([[5]], dtype=torch.int32),
                           torch.tensor([[40]], dtype=torch.int32), kv, logits_for="last")
    r = 64 if cfg.arch == "starcoder2" else 16
    assert calls == [r] * cfg.n_layers and cfg.rope.dim == r and not fused
    assert logits.shape == (1, 1, 512) and bool(torch.isfinite(logits).all())


def _engine_run(engine, make_request):
    """Two waves: three prompts (one across the first 128-token page), then
    a re-send sharing 130 tokens of the long one."""
    r = np.random.default_rng(3)

    def toks(n):
        return [int(x) for x in r.integers(3, VOCAB, size=n)]

    long = toks(140)
    waves = [[dict(prompt_tokens=long, max_new=8), dict(prompt_tokens=toks(37), max_new=8),
              dict(prompt_tokens=toks(9), max_new=8)],
             [dict(prompt_tokens=long[:130] + [7], max_new=6)]]
    counters = ("tokens_generated_total", "tokens_prefilled_total", "tokens_prefix_reused_total",
                "decode_steps_total", "prefill_steps_total", "engine_errors_total")
    before = dict(engine.metrics)
    got = []
    for wave in waves:
        reqs = engine.run_in_loop(lambda wave=wave: [engine.submit(make_request(**kw))
                                                     for kw in wave])
        deadline = time.time() + 120
        while not all(q.done for q in reqs):
            assert time.time() < deadline, "engine timed out"
            time.sleep(0.005)
        got += [(list(q.out_tokens), q.finish_reason, q.n_prompt_reused, q.error) for q in reqs]
    return got, {k: engine.metrics[k] - before[k] for k in counters}


@pytest.mark.parametrize("layout", ["paged", "q8"])
def test_starcoder2_engine_matches_zllm(files, layout):
    import jax.numpy as jnp

    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request

    zm = _zllm_model(files["starcoder2"])
    tm = Model.load(files["starcoder2"], device="cpu", dtype=torch.float32)
    zkw, tkw = ((dict(kv_dtype=jnp.float32), dict(kv_dtype=torch.float32)) if layout == "paged"
                else (dict(kv_dtype="q8"), dict(kv_dtype="q8")))
    out = {}
    for side, engine, make_request in (
            ("zllm", ZEngine(zm, n_slots=2, max_len=256, prefill_chunk=16, **zkw),
             lambda **kw: ZRequest(temp=0.0, **kw)),
            ("port", Engine(tm, n_slots=2, max_len=256, prefill_chunk=16, **tkw),
             lambda **kw: Request(temp=0.0, **kw))):
        if side == "port":
            assert engine.paged == (layout == "paged")
        engine.start()
        try:
            out[side] = _engine_run(engine, make_request)
        finally:
            engine.stop()
    (tgot, tcount), (zgot, zcount) = out["port"], out["zllm"]
    assert all(err == "" for *_, err in tgot), tgot
    assert tgot == zgot and tcount == zcount
    assert tcount["decode_steps_total"] > 0 and tcount["prefill_steps_total"] > 0
    assert tgot[3][2] >= 128  # the re-send reuses the long prompt's prefix


def test_starcoder_pretokenizer_matches_zllm():
    """Digits split one a fragment (ASCII, Arabic-Indic, superscript,
    vulgar fraction, Roman numeral, fullwidth), then GPT-2's pattern."""
    from zllm.tokenizer.bpe import BpeTokenizer as ZBpe
    from zllm.tokenizer.vocab import Vocab as ZVocab
    from zllm_torch.tokenizer.bpe import PRETOKENIZERS, char_class, pretokenize

    text = ("def f(x1, y22):\n    return 3.14159 * x1 ** 2  # 2024-10-19\r\n"
            "٣٤٥ x² ½ Ⅻ １２ v2.0 it's 12345678 ok")
    ref = ZBpe(ZVocab(model="gpt2", pre="starcoder", tokens=[], scores=[], types=[]))
    got = pretokenize(text, PRETOKENIZERS["starcoder"])
    assert got == ref.pretokenize(text)
    digits = [t for t in got if any(char_class(c) == "N" for c in t)]
    assert "".join(got) == text and all(len(t) == 1 for t in digits)
    assert len(digits) == sum(char_class(c) == "N" for c in text)
    assert {"٣", "²", "½", "Ⅻ", "１"} <= set(digits)


def test_stablelm_12b_qk_layernorm_is_refused(files, tmp_path):
    """A stablelm file with [n_head, head_dim] attn_q_norm / attn_k_norm
    weights (StableLM-2-12B's per-head LayerNorms, which zllm would run as
    per-head RMS norms) raises a typed NotImplementedError naming item 8."""
    from zllm_torch.gguf import read_gguf
    from zllm_torch.gguf.writer import GGUFWriter
    from zllm_torch.models.loader import Model

    out = str(tmp_path / "stablelm_qk.gguf")
    with read_gguf(files["stablelm"]) as f:
        cfg = ARCH_CFGS["stablelm"]
        hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        d = cfg["hidden_size"] // hq
        w = GGUFWriter(out, alignment=f.alignment)
        for key, val in f.metadata.items():
            w.add(key, val)
        for name, meta in f.tensors.items():
            w.add_tensor(name, np.asarray(f.tensor_bytes(name)), logical_shape=meta.shape,
                         gtype=meta.gtype)
        for il in range(cfg["num_hidden_layers"]):
            w.add_tensor(f"blk.{il}.attn_q_norm.weight", np.ones((hq, d), np.float32))
            w.add_tensor(f"blk.{il}.attn_k_norm.weight", np.ones((hkv, d), np.float32))
        w.write()
    with pytest.raises(NotImplementedError, match="StableLM-2-12B.*item 8"):
        Model.load(out, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("arch", ["llama", "stablelm"])
def test_unfused_gate_up_matches_zllm(files, arch, tmp_path):
    """A gated file whose ffn_up is Q6_K beside a Q4_K ffn_gate (as a
    per-tensor type override writes it) keeps gate and up apart, and runs
    act(gate, up) -> down: its prefill and decode logits within nmse 1e-3 of
    zllm's interpret-mode kernels, on an RMS (llama) and a layer-norm
    (stablelm) block."""
    from zllm_torch.gguf import read_gguf
    from zllm_torch.gguf.writer import GGUFWriter
    from zllm_torch.models.loader import Model
    from zllm_torch.quant import blocks as qb
    from zllm_torch.quant.repack import QWeight
    from zllm_torch.testing import make_llama_gguf

    src = files["stablelm_q4k"]
    if arch == "llama":
        src = make_llama_gguf(str(tmp_path / "llama_q4k.gguf"),
                              **dict(FACTORY["stablelm_q4k"], arch="llama", rope_dim=None))
    out = str(tmp_path / f"{arch}_up_q6k.gguf")
    with read_gguf(src) as f:
        w = GGUFWriter(out, alignment=f.alignment)
        for key, val in f.metadata.items():
            w.add(key, val)
        for name, meta in f.tensors.items():
            if name.endswith(".ffn_up.weight"):
                assert meta.gtype == GGMLType.Q4_K
                w.add_tensor(name, qb.quantize(f.tensor_f32(name), GGMLType.Q6_K, device="cpu"),
                             logical_shape=meta.shape, gtype=GGMLType.Q6_K)
            else:
                w.add_tensor(name, np.asarray(f.tensor_bytes(name)), logical_shape=meta.shape,
                             gtype=meta.gtype)
        w.write()
    m = Model.load(out, device="cpu", dtype=torch.float32)
    for layer in m.params["layers"]:
        assert "ffn_gateup" not in layer
        assert isinstance(layer["ffn_gate"], QWeight) and layer["ffn_gate"].fmt == GGMLType.Q4_K
        assert layer["ffn_up"].fmt == GGMLType.Q6_K
    zlog, ztoks = _zllm_logits(out, kernels=True)
    tlog = _port_logits(out, ztoks)
    assert len(tlog) == N_DECODE + 1
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert nmse(a, b) <= 1e-3, f"step {step}: nmse {nmse(a, b)}"
