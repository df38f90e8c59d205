"""gpt-oss in the port against zllm on the CPU, and the dequantizing route
that zllm takes for a matmul weight its kernels do not take.

Files:
  * F32 from zllm's `convert_hf_llama(..., arch="gpt-oss")` on a seeded
    numpy state dict in `tests/test_arch_parity.py`'s ARCH_CFGS["gpt-oss"]
    geometry (2 layers, 64 wide, 4 / 2 heads of 16, 4 experts of 48, top 2,
    a window of 8 on layer 0), with yarn rope (x32 over 64) and a byte-level
    SPM vocab of 300;
  * quantized from the port's factory, 320 wide (4 / 2 heads of 64: wo's N
    is 320), MXFP4 experts of 96 (their ffn_down's K % 64 == 32: a last
    32-block) and Q8_0 elsewhere, so that zllm's kernels take no weight of
    it; the same window and yarn, the factory's BPE vocab with `pre`
    "gpt-4o".

Checks:
  * the config (softmax_weight gating by the arch's default, swiglu_oai,
    window pattern 2, yarn) and every loaded leaf equal zllm's, also as
    `params_from_jax` carries them (attn_sinks, the router's and the
    experts' biases, bqkv, bo);
  * `swiglu_oai` and `moe_ffn` (the router bias, softmax_weight, the
    expert biases) equal zllm's;
  * a 40-token prefill in chunks of 16 (past the window) and 16 decode
    steps over the contiguous cache within nmse 1e-5 of zllm's forward, for
    both files (zllm computes every matmul of the quantized file outside its
    kernels too, as the port does); greedy `Generator.generate` gives
    zllm's tokens and text;
  * the ring engine equals zllm's engine, and concurrent requests equal
    sequential ones;
  * K2's plain sinks form equals zllm's `attention_ref` with sinks (a sink
    above every score among them), and the verify and q8 routes take the
    sinks; a paged engine or forward on a model with sinks raises;
  * the `gpt-4o` pretokenizer equals zllm's, and its classes equal
    `regex`'s;
  * the harmony chat prompt equals zllm's;
  * the repaired fault: a llama Q8_0 file 320 wide (zllm keeps its weights
    quantized at fold 64) loads and runs within nmse 1e-5 of zllm, and no
    weight of it reaches a kernel wrapper; an expert stack zllm's kernels
    would not take dequantizes only the experts a step picks."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_arch_parity import ARCH_CFGS
from test_torch_oracle import gemma_tokenizer_kv, jax_params_numpy, nmse, run_waves, to_np

from zllm.gguf.constants import GGMLType

VOCAB = 300  # the F32 file's byte-level vocab
PROMPT = [1] + list(range(40, 79))  # 40 tokens: chunks of 16, 16 and 8, past the window of 8
CHUNK = 16
N_DECODE = 16
NMSE = 1e-5
YARN = {"rope_type": "yarn", "factor": 32.0, "original_max_position_embeddings": 64}
QUANT = dict(arch="gpt-oss", n_layers=2, n_embd=320, n_heads=4, n_kv_heads=2, head_dim=64,
             n_ff=96, n_experts=4, n_experts_used=2, vocab_size=4096, sliding_window=8,
             rope_base=150000.0, rope_yarn=(32.0, 64), gtype=GGMLType.Q8_0,
             expert_gtype=GGMLType.MXFP4, tokenizer="bpe", pre="gpt-4o")


def hf_state(cfg: dict, seed: int) -> dict:
    """A seeded HF-style GptOssForCausalLM state dict (numpy f32): q/k/v/o
    with biases, sinks, the router with its bias, the fused gate|up experts
    (gate and up interleaved along their last axis) and down with biases."""
    rng = np.random.default_rng(seed)
    e, v, f = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]
    hq, hkv, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    n_exp = cfg["num_local_experts"]

    def w(*shape, s=0.08):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(v, e, s=0.3), "lm_head.weight": w(v, e),
          "model.norm.weight": 1.0 + w(e, s=0.1)}
    for il in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{il}."
        sd.update({
            p + "input_layernorm.weight": 1.0 + w(e, s=0.1),
            p + "post_attention_layernorm.weight": 1.0 + w(e, s=0.1),
            p + "self_attn.q_proj.weight": w(hq * d, e), p + "self_attn.q_proj.bias": w(hq * d),
            p + "self_attn.k_proj.weight": w(hkv * d, e), p + "self_attn.k_proj.bias": w(hkv * d),
            p + "self_attn.v_proj.weight": w(hkv * d, e), p + "self_attn.v_proj.bias": w(hkv * d),
            p + "self_attn.o_proj.weight": w(e, hq * d), p + "self_attn.o_proj.bias": w(e),
            p + "self_attn.sinks": w(hq, s=1.0),
            p + "mlp.router.weight": w(n_exp, e, s=0.5), p + "mlp.router.bias": w(n_exp, s=0.5),
            p + "mlp.experts.gate_up_proj": w(n_exp, e, 2 * f, s=0.3),
            p + "mlp.experts.gate_up_proj_bias": w(n_exp, 2 * f, s=0.3),
            p + "mlp.experts.down_proj": w(n_exp, f, e),
            p + "mlp.experts.down_proj_bias": w(n_exp, e)})
    return sd


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from zllm.convert import convert_hf_llama
    from zllm_torch.testing import make_llama_gguf

    folder = tmp_path_factory.mktemp("gpt_oss")
    cfg = dict(ARCH_CFGS["gpt-oss"], vocab_size=VOCAB, rope_scaling=YARN)
    f32 = convert_hf_llama(hf_state(cfg, 0), cfg, str(folder / "f32.gguf"), arch="gpt-oss",
                           gtype=GGMLType.F32, tokenizer_kv=gemma_tokenizer_kv(VOCAB))
    quant = make_llama_gguf(str(folder / "quant.gguf"), **QUANT, with_tokenizer=True, seed=3)
    llama320 = make_llama_gguf(str(folder / "llama320.gguf"), n_layers=1, n_embd=320,
                               n_heads=4, n_kv_heads=2, n_ff=640, vocab_size=512,
                               gtype=GGMLType.Q8_0, with_tokenizer=True)
    return {"f32": f32, "quant": quant, "llama320": llama320}


def _zllm_model(path):
    import jax.numpy as jnp

    from zllm.models.loader import Model

    return Model.load(path, dtype=jnp.float32)


def _port_model(path):
    from zllm_torch.models.loader import Model

    return Model.load(path, device="cpu", dtype=torch.float32)


# ---- config and weights --------------------------------------------------------

CFG_FIELDS = ("arch", "n_layers", "n_embd", "n_heads", "n_kv_heads", "head_dim", "n_ff",
              "vocab_size", "ctx_len", "norm_eps", "logit_scale", "attn_scale", "act",
              "sliding_window", "swa_pattern", "norm_kind", "parallel_residual")
LAYER_KEYS = {"attn_norm", "ffn_norm", "wqkv", "bqkv", "wo", "bo", "attn_sinks",
              "ffn_gate_inp", "ffn_gate_inp_b", "ffn_gateup_exps", "ffn_down_exps",
              "ffn_gate_exps_b", "ffn_up_exps_b", "ffn_down_exps_b"}


@pytest.mark.parametrize("name", ["f32", "quant"])
def test_config_and_weights_equal_zllm(files, name):
    from zllm_torch.models.loader import params_from_jax
    from zllm_torch.quant.repack import QWeight, QWeightE

    zm, tm = _zllm_model(files[name]), _port_model(files[name])
    for field in CFG_FIELDS:
        assert getattr(tm.cfg, field) == getattr(zm.cfg, field), field
    assert tuple(tm.cfg.rope) == tuple(zm.cfg.rope) and tm.cfg.rope.scaling == "yarn"
    assert dataclasses.asdict(tm.cfg.moe) == dataclasses.asdict(zm.cfg.moe)
    assert tm.cfg.moe.gate_func == "softmax_weight" and tm.cfg.act == "swiglu_oai"
    assert [tm.cfg.layer_window(il) for il in range(2)] == [8, 0]
    carried = params_from_jax(jax_params_numpy(zm.params), device="cpu", dtype=torch.float32)

    def same(a, b, where):
        if isinstance(a, QWeight):
            assert type(a) is type(b), where
            assert all(torch.equal(v, b.planes()[p]) for p, v in a.planes().items()), where
        elif isinstance(a, QWeightE):
            assert a.fmt == b.fmt and a.shape == b.shape, where
            assert all(torch.equal(v, b.planes[p]) for p, v in a.planes.items()), where
        else:
            assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b), where

    for key in ("tok_emb", "out_norm", "output"):
        same(tm.params[key], carried[key], key)
    for il, (layer, zlayer) in enumerate(zip(tm.params["layers"], carried["layers"])):
        assert set(layer) == LAYER_KEYS
        assert set(zlayer) == LAYER_KEYS - {"ffn_gateup_exps"} | {"ffn_gate_exps", "ffn_up_exps"}
        for key in LAYER_KEYS - {"ffn_gateup_exps"}:
            same(layer[key], zlayer[key], (il, key))
        fused, half = layer["ffn_gateup_exps"], layer["ffn_gateup_exps"].shape[-1] // 2
        for key, cut in (("ffn_gate_exps", slice(0, half)), ("ffn_up_exps", slice(half, None))):
            if isinstance(fused, QWeightE):
                assert all(torch.equal(p[:, cut], zlayer[key].planes[n])
                           for n, p in fused.planes.items()), key
            else:
                assert torch.equal(fused[..., cut], zlayer[key]), key
        assert layer["attn_sinks"].shape == (tm.cfg.n_heads,)
    if name == "quant":  # every matmul weight is one zllm's kernels do not take
        from zllm_torch.ops import qmatmul as qmm

        layer = tm.params["layers"][0]
        assert isinstance(layer["ffn_down_exps"], QWeightE) and layer["ffn_down_exps"].shape[1] == 96
        assert not any(qmm.supports(w) for w in (layer["wqkv"], layer["wo"], tm.params["output"],
                                                 layer["ffn_gateup_exps"].expert(0),
                                                 layer["ffn_down_exps"].expert(0)))


def test_llama_cpp_ffn_norm_name_loads(files, tmp_path):
    """llama.cpp names gpt-oss's FFN pre-norm post_attention_norm: the port
    runs such a file as the one with ffn_norm."""
    from zllm_torch.gguf import read_gguf
    from zllm_torch.gguf.writer import GGUFWriter
    from zllm_torch.models.llama import forward

    path = str(tmp_path / "renamed.gguf")
    with read_gguf(files["f32"]) as f:
        w = GGUFWriter(path)
        for key, val in f.metadata.items():
            w.add(key, val)
        for name in f.tensors:
            new = name.replace("ffn_norm.weight", "post_attention_norm.weight")
            w.add_tensor(new, f.tensor_f32(name))
        w.write()
    a, b = _port_model(files["f32"]), _port_model(path)
    toks = torch.tensor([PROMPT[:12]], dtype=torch.int32)
    pos = torch.arange(12, dtype=torch.int32)[None]
    assert torch.equal(forward(a.params, a.cfg, toks, pos), forward(b.params, b.cfg, toks, pos))


def test_sinks_on_olmo2_are_refused(tmp_path):
    """OLMo-2's decode step is K8, which takes no sinks: a file with them is
    refused rather than run without them."""
    from zllm_torch.gguf import read_gguf
    from zllm_torch.gguf.writer import GGUFWriter
    from zllm_torch.models.loader import Model
    from zllm_torch.testing import make_llama_gguf

    src = make_llama_gguf(str(tmp_path / "olmo2.gguf"), arch="olmo2", n_layers=1, n_embd=64,
                          n_heads=4, n_kv_heads=4, n_ff=128, vocab_size=260, gtype=GGMLType.F32)
    path = str(tmp_path / "sinks.gguf")
    with read_gguf(src) as f:
        w = GGUFWriter(path)
        for key, val in f.metadata.items():
            w.add(key, val)
        for name in f.tensors:
            w.add_tensor(name, f.tensor_f32(name))
        w.add_tensor("blk.0.attn_sinks.weight", np.zeros(4, np.float32))
        w.write()
    with pytest.raises(NotImplementedError, match="attn_sinks on olmo2"):
        Model.load(path, device="cpu", dtype=torch.float32)


# ---- swiglu_oai and moe_ffn ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_oai_matches_zllm(dtype):
    import jax.numpy as jnp

    from zllm.models.llama import swiglu_oai as zswiglu
    from zllm_torch.ops.layers import swiglu_oai

    rng = np.random.default_rng(4)
    g, u = (rng.standard_normal((64, 96)).astype(np.float32) * 6 for _ in range(2))
    g[0, :4], u[0, :4] = [9.0, 7.5, -20.0, 7.0], [-9.0, 8.0, 7.0, -7.0]  # past both clamps
    want = zswiglu(jnp.asarray(g, dtype), jnp.asarray(u, dtype))
    td = getattr(torch, dtype)
    got = swiglu_oai(torch.from_numpy(g).to(td), torch.from_numpy(u).to(td))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32  # zllm's stays f32 too
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t", [1, 16], ids=["sparse_t1", "dense_t16"])
@pytest.mark.parametrize("name", ["f32", "quant"])
def test_moe_ffn_matches_zllm(files, name, t):
    """zllm's moe_ffn and the port's on layer 0 of each file: the router's
    bias, top-k over the raw logits, the softmax of the picks, the experts'
    biases; the port's recorded routing is zllm's top-k."""
    import jax
    import jax.numpy as jnp

    from zllm.models.llama import moe_ffn as zmoe
    from zllm_torch.models.llama import moe_ffn

    zm, tm = _zllm_model(files[name]), _port_model(files[name])
    h = np.random.default_rng(t).standard_normal((1, t, tm.cfg.n_embd)).astype(np.float32)
    want = to_np(zmoe(zm.params["layers"][0], zm.cfg, jnp.asarray(h)))
    moe_ffn.routing = []
    try:
        got = to_np(moe_ffn(tm.params["layers"][0], tm.cfg, torch.from_numpy(h)))
        (_, used, picks, _), = moe_ffn.routing
    finally:
        moe_ffn.routing = None
    zl = zm.params["layers"][0]
    logits = h[0] @ np.asarray(zl["ffn_gate_inp"]) + np.asarray(zl["ffn_gate_inp_b"])
    zpicks = np.asarray(jax.lax.top_k(jnp.asarray(logits), 2)[1])
    assert np.array_equal(np.sort(picks.reshape(t, 2), -1), np.sort(zpicks, -1))
    assert used == sorted(set(zpicks.reshape(-1).tolist()))
    assert got.shape == want.shape and np.isfinite(got).all()
    assert nmse(got, want) <= 1e-10


# ---- the forward over the contiguous cache ------------------------------------

def _zllm_logits(path):
    """zllm's prefill logits and N_DECODE teacher-forced decode steps (f32
    cache), its greedy tokens driving both sides; its kernels installed in
    interpret mode (no weight of these files reaches one)."""
    import jax.numpy as jnp

    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.runtime.generate import Generator

    m = _zllm_model(path)
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


@pytest.mark.parametrize("name", ["f32", "quant"])
def test_logits_match_zllm_forward(files, name, monkeypatch):
    """The prefill and 16 decode steps within NMSE of zllm's; every decode
    step's attention is K2's sinks form (its plain version here), a layer
    a step, and the chunks' K6 takes the sinks."""
    from zllm_torch.models import llama
    from zllm_torch.runtime.generate import Generator

    zlog, ztoks = _zllm_logits(files[name])
    tm = _port_model(files[name])
    k2, k6 = [], []
    real2, real6 = llama.attn_decode_qkv, llama.flash_attention

    def spy2(*a, **kw):
        k2.append(kw.get("sinks") is not None)
        return real2(*a, **kw)

    def spy6(*a, **kw):
        k6.append(kw.get("sinks") is not None)
        return real6(*a, **kw)

    monkeypatch.setattr(llama, "attn_decode_qkv", spy2)
    monkeypatch.setattr(llama, "flash_attention", spy6)
    gen = Generator(tm, max_len=128, prefill_chunk=CHUNK, kv_dtype=torch.float32)
    logits = [to_np(gen.prefill(PROMPT))]
    n_chunks = len(k6) // tm.cfg.n_layers
    for i in range(N_DECODE):
        logits.append(to_np(gen._decode_one(ztoks[i], len(PROMPT) + i)))
    assert n_chunks == 3 and all(k6) and len(k6) == 3 * tm.cfg.n_layers
    # a chunk runs K2 once more on column 0, a decode step once a layer
    assert all(k2) and len(k2) == (n_chunks + N_DECODE) * tm.cfg.n_layers
    for step, (a, b) in enumerate(zip(logits, zlog)):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert nmse(a, b) <= NMSE, f"step {step}: nmse {nmse(a, b)}"


@pytest.mark.parametrize("name", ["f32", "quant"])
def test_greedy_generate_matches_zllm(files, name):
    import jax.numpy as jnp

    from zllm.runtime.generate import Generator as ZGenerator
    from zllm_torch.runtime.generate import Generator

    zm, tm = _zllm_model(files[name]), _port_model(files[name])
    text = "Grüße aus 東京, 2024: it's a gpt-oss model WE'LL see!"
    prompt = tm.tokenizer.encode(text, add_special=True)
    assert prompt == zm.tokenizer.encode(text, add_special=True) and len(prompt) > 8
    zres = ZGenerator(zm, max_len=128, prefill_chunk=CHUNK, kv_dtype=jnp.float32).generate(
        prompt, max_new=16)
    tres = Generator(tm, max_len=128, prefill_chunk=CHUNK, kv_dtype=torch.float32).generate(
        prompt, max_new=16)
    assert tres.tokens == list(zres.tokens) and len(tres.tokens) == 16
    assert tres.text == zres.text


# ---- serving ---------------------------------------------------------------------

COUNTERS = ("tokens_generated_total", "tokens_prefilled_total", "decode_steps_total",
            "prefill_steps_total", "engine_errors_total")


def _waves(vocab: int):
    r = np.random.default_rng(3)

    def toks(n):
        return [int(x) for x in r.integers(3, vocab, size=n)]

    return [[dict(prompt_tokens=toks(150), max_new=8), dict(prompt_tokens=toks(37), max_new=8),
             dict(prompt_tokens=toks(9), max_new=8)]]


def test_ring_engine_matches_zllm(files):
    """The auto layout of a windowed model is the ring (KVCacheSWA) on both
    sides: tokens and step counters equal zllm's engine's, and three
    requests served together equal each served alone."""
    import jax.numpy as jnp

    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.runtime.kvcache import KVCacheSWA
    from zllm_torch.server.engine import Engine, Request

    zm, tm = _zllm_model(files["f32"]), _port_model(files["f32"])
    waves = _waves(VOCAB)
    zgot, zcount = run_waves(ZEngine(zm, n_slots=4, max_len=256, prefill_chunk=CHUNK,
                                     kv_dtype=jnp.float32),
                             lambda **kw: ZRequest(temp=0.0, **kw), waves, COUNTERS)

    def port(waves_):
        eng = Engine(tm, n_slots=4, max_len=256, prefill_chunk=CHUNK, kv_dtype=torch.float32)
        assert not eng.paged and isinstance(eng.kv, KVCacheSWA) and eng.kv.ring == 128
        return run_waves(eng, lambda **kw: Request(temp=0.0, **kw), waves_, COUNTERS)

    tgot, tcount = port(waves)
    assert all(err == "" for *_, err in tgot), tgot
    assert tgot == zgot
    assert tcount == zcount and tcount["decode_steps_total"] > 0
    alone, _ = port([[req] for req in waves[0]])
    assert [t for t, *_ in alone] == [t for t, *_ in tgot]


def test_paged_layout_with_sinks_is_refused(files):
    from zllm_torch.models.llama import forward
    from zllm_torch.runtime.paged import PagedKVCache
    from zllm_torch.server.engine import Engine

    tm = _port_model(files["f32"])
    with pytest.raises(NotImplementedError, match="queue 2: the sinks forms of K9 and K10"):
        Engine(tm, n_slots=2, max_len=128, prefill_chunk=CHUNK, kv_layout="paged")
    cfg = tm.cfg
    kv = PagedKVCache.create(cfg.n_layers, 1, 128, cfg.n_kv_heads, cfg.head_dim, torch.float32,
                             page_size=64, device="cpu")
    kv = kv.with_table(torch.arange(3, dtype=torch.int32)[None])
    with pytest.raises(NotImplementedError, match="queue 2"):
        forward(tm.params, cfg, torch.tensor([[5, 6]], dtype=torch.int32),
                torch.tensor([[0, 1]], dtype=torch.int32), kv)


# ---- K2's sinks form, and the other routes' sinks ---------------------------------

@pytest.mark.parametrize("case", ["mixed", "sink_above_all", "window"])
def test_k2_plain_sinks_match_zllm_attention_ref(case):
    """attn_decode_qkv_plain with sinks over an f32 cache against zllm's
    attention_ref with sinks on the cache after the insert: G = 8 at d 64
    (gpt-oss's group), windows 0 and 128, a sink far above every score."""
    import jax.numpy as jnp

    from zllm.ops.layers import attention_ref as zref
    from zllm.runtime.kvcache import causal_mask
    from zllm_torch.ops.attention import attn_decode_qkv_plain
    from zllm_torch.ops.layers import RopeParams, rope_apply_table, rope_table

    rng = np.random.default_rng(9)
    b, hq, hkv, d, s = 3, 16, 2, 64, 512
    window = 128 if case == "window" else 0
    pos = torch.tensor([300, 0, 511], dtype=torch.int32)
    qkv3 = torch.from_numpy(rng.standard_normal((b, hq + 2 * hkv, d)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
              for _ in range(2))
    sinks = torch.from_numpy(rng.standard_normal(hq).astype(np.float32))
    if case == "sink_above_all":
        sinks[::2] += 40.0
    rt = rope_table(pos, RopeParams(dim=d, base=150000.0, style="neox", scaling="yarn",
                                    scale_factor=32.0, orig_ctx=4096), d)
    got = attn_decode_qkv_plain(qkv3, kc, vc, pos, rt, scale=d ** -0.5, window=window,
                                sinks=sinks)
    q = rope_apply_table(qkv3[:, :hq], rt)[:, None]
    mask = causal_mask(jnp.asarray(pos.numpy()[:, None]), s, window)
    want = zref(jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy()), mask,
                d ** -0.5, sinks=jnp.asarray(sinks.numpy()))
    assert nmse(to_np(got), to_np(want)) <= 1e-12
    no_sinks = attn_decode_qkv_plain(qkv3, kc.clone(), vc.clone(), pos, rt, scale=d ** -0.5,
                                     window=window)
    assert nmse(to_np(no_sinks), to_np(got)) > 1e-6  # the sinks move the output


def test_verify_and_q8_routes_take_the_sinks(files, monkeypatch):
    """forward(verify=True) runs K2 with sinks once a column and layer; the
    q8 cache hands K7 the sinks; both give the f32 decode steps' logits
    (q8: within its rounding)."""
    from zllm_torch.models import llama
    from zllm_torch.runtime.kvcache import KVCache, KVCacheQ8

    tm = _port_model(files["f32"])
    cfg = tm.cfg
    seen = {"k2": [], "k7": []}
    real2, real7 = llama.attn_decode_qkv, llama.flash_attention_blockwise
    monkeypatch.setattr(llama, "attn_decode_qkv", lambda *a, **kw: (
        seen["k2"].append(kw["sinks"] is not None), real2(*a, **kw))[1])
    monkeypatch.setattr(llama, "flash_attention_blockwise", lambda *a, **kw: (
        seen["k7"].append(kw["sinks"] is not None), real7(*a, **kw))[1])
    toks = torch.tensor([PROMPT[:20]], dtype=torch.int32)
    pos = torch.arange(20, dtype=torch.int32)[None]
    outs = {}
    for kind in ("f32", "verify", "q8"):
        kv = (KVCacheQ8.create(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim, device="cpu")
              if kind == "q8" else
              KVCache.create(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim, torch.float32,
                             "cpu"))
        llama.forward(tm.params, cfg, toks[:, :16], pos[:, :16], kv)
        if kind == "verify":
            outs[kind] = llama.forward(tm.params, cfg, toks[:, 16:], pos[:, 16:], kv, verify=True)
        else:
            outs[kind] = torch.cat([llama.forward(tm.params, cfg, toks[:, j:j + 1],
                                                  pos[:, j:j + 1], kv) for j in range(16, 20)], 1)
    assert seen["k2"] and all(seen["k2"]) and seen["k7"] and all(seen["k7"])
    assert len(seen["k2"]) == 2 * (1 + 4) * cfg.n_layers  # f32 and verify: column 0, 4 columns
    assert nmse(to_np(outs["verify"]), to_np(outs["f32"])) <= 1e-12
    assert nmse(to_np(outs["q8"]), to_np(outs["f32"])) <= 1e-3


# ---- the gpt-4o pretokenizer and the chat prompt ----------------------------------

GPT4O_CORPUS = [
    "Hello world", "HELLO World hello", "camelCaseWord XMLHttpRequest iPhone McDonald's",
    "It's we'RE THEY'LL you've I'M he'D it'S x'Ve 'll 'LL ''s '", "DON'T don't Don'T",
    "1 12 123 1234 12345 123456 1234567", "a1b22c333d4444e55555", "v2.0.1-rc3 3.14159",
    "Ça coûte 15 € — naïve café, déjà vu, Straße, ǅemal ǈ", "é café ÉT́",
    "́́x ⃝ ok", "中文文本，模型在芯片上运行。日本語のテキスト、한국어 텍스트",
    "Ελληνικά ΑΒΓ русский ТЕКСТ العربية עברית", "ʰello ˆx ꜰᴏᴏ",
    "path/to/file //x/ a/b\n/c", "a/\r\n/\nb", "line\r\nnext\r\n\r\nthird", "a\n\n\nb",
    "  \n  x", "x \n", "tab\tsep\t\tx\t", "   leading", "trailing   ", "!!! ??? ... (a)[b]",
    "🚀🔥 ok 😀! 👍🏽x", "a b  x", "٣٤ Ⅻ ½ ² x²y",
    "def f(x):\n    return x ** 2  # sq\n", '{"k": [1, 2, 3], "ok": true}',
]
# U+0295 is Lo in Python 3.12's Unicode 15.0 and Ll in `regex`'s newer
# tables: the parity texts keep to characters both class the same way
RECLASSED = {"\u0295"}
GPT4O_ALPHABET = st.one_of(
    st.sampled_from(list(" \t\r\n\x0b\x1c\xa0'sStTrReEvVmMlLdD1234567/.,!-aBzZ")
                    + ["́", "⃝", "ः", "ſ", "ǅ", "ʰ", "中",
                       "ー", "가", "\U0001F600", "　", " ", "é",
                       "É", "ß"]),
    st.characters(exclude_categories=("Cs", "Cn")).filter(lambda c: c not in RECLASSED))


def _zllm_pretokenize(text: str) -> list[str]:
    from zllm.tokenizer.bpe import BpeTokenizer as ZBpe
    from zllm.tokenizer.vocab import Vocab as ZVocab

    return ZBpe(ZVocab(model="gpt2", pre="gpt-4o", tokens=[], scores=[], types=[])).pretokenize(
        text)


def test_gpt4o_pretokenizer_matches_zllm_on_the_corpus():
    from zllm_torch.tokenizer.bpe import pretokenize

    for text in GPT4O_CORPUS:
        assert pretokenize(text, "gpt-4o") == _zllm_pretokenize(text), repr(text)


@settings(derandomize=True, max_examples=400, deadline=None, database=None)
@given(text=st.text(alphabet=GPT4O_ALPHABET, max_size=40))
def test_gpt4o_pretokenizer_matches_zllm_on_any_text(text):
    """Python 3.12's unicodedata is Unicode 15.0; `regex` may carry newer
    tables.  The alphabet draws assigned code points of 15.0 only, whose
    classes `test_gpt4o_classes_match_regex` holds equal on this image."""
    from zllm_torch.tokenizer.bpe import pretokenize

    assert pretokenize(text, "gpt-4o") == _zllm_pretokenize(text)


@pytest.mark.parametrize("cls,pattern", [("Lu", r"\p{Lu}"), ("Ll", r"\p{Ll}"),
                                         ("Lt", r"\p{Lt}"), ("Lm", r"\p{Lm}"),
                                         ("Lo", r"\p{Lo}"), ("M", r"\p{M}")])
def test_gpt4o_classes_match_regex(cls, pattern):
    import unicodedata

    import regex

    from zllm_torch.tokenizer.bpe import case_class

    assert unicodedata.unidata_version == "15.0.0"
    chars = [chr(c) for c in range(0x110000) if unicodedata.category(chr(c)) not in ("Cn", "Cs")]
    theirs = set(regex.findall(pattern, "".join(chars)))
    ours = {c for c in chars if case_class(c) == cls}
    assert ours ^ theirs <= RECLASSED, sorted(ours ^ theirs)[:20]
    assert len(ours) > (20 if cls == "Lt" else 200)


def test_gpt4o_vocab_ids_and_chat_prompt_match_zllm(files):
    """The factory's gpt-4o vocab encodes and decodes as zllm's does, and the
    harmony chat prompt of the loaded model is zllm's, as text and ids."""
    from zllm.server import chat as zchat
    from zllm_torch.server import chat

    zm, tm = _zllm_model(files["quant"]), _port_model(files["quant"])
    assert tm.tokenizer.vocab.pre == "gpt-4o"
    for text in GPT4O_CORPUS:
        ids = tm.tokenizer.encode(text)
        assert ids == zm.tokenizer.encode(text), repr(text)
        assert tm.tokenizer.decode(ids) == zm.tokenizer.decode(ids) == text
    msgs = [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": "Grüße! What's 12345 + 678?"},
            {"role": "assistant", "content": "13023."}, {"role": "user", "content": "Why?"}]
    assert chat.detect_format(tm) == zchat.detect_format(zm) == "gpt-oss"
    prompt = chat.apply_chat_template(tm, msgs)
    assert prompt == zchat.apply_chat_template(zm, msgs)
    assert prompt.startswith("<|start|>system<|message|>") and prompt.endswith("<|start|>assistant")
    assert tm.tokenizer.encode(prompt, parse_special=True) == zm.tokenizer.encode(
        prompt, parse_special=True)


# ---- the repaired fault: zllm's dequantizing route ------------------------------

def test_k_320_llama_loads_and_matches_zllm(files, monkeypatch):
    """A llama Q8_0 file 320 wide: zllm keeps its weights quantized at fold
    64 and multiplies them dequantized outside its kernels; the port loads
    it (it raised before), runs a prefill and decode steps within NMSE of
    zllm, and hands no weight of it to a kernel wrapper."""
    from zllm.quant.repack import QTensor
    from zllm_torch.ops import linear as lin
    from zllm_torch.ops import qmatmul as qmm
    from zllm_torch.quant.repack import Q80Weight
    from zllm_torch.runtime.generate import Generator

    zm = _zllm_model(files["llama320"])
    assert isinstance(zm.params["layers"][0]["wqkv"], QTensor)
    assert zm.params["layers"][0]["wqkv"].fold == 64
    zlog, ztoks = _zllm_logits(files["llama320"])
    tm = _port_model(files["llama320"])
    assert isinstance(tm.params["layers"][0]["wqkv"], Q80Weight)

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper got a weight zllm's kernels do not take")

    for name in ("matvec", "gemm", "q4k_matvec", "int8_matvec", "q4k_gemm", "dequant_gemm",
                 "q4k_matvec_hbm", "w4a8dd_matvec"):
        monkeypatch.setattr(qmm, name, refuse)
    before = lin.dequant_linear.calls
    gen = Generator(tm, max_len=128, prefill_chunk=CHUNK, kv_dtype=torch.float32)
    logits = [to_np(gen.prefill(PROMPT))]
    for i in range(N_DECODE):
        logits.append(to_np(gen._decode_one(ztoks[i], len(PROMPT) + i)))
    # wqkv, wo, gate|up, down and the head: 3 chunks, then a step each (the
    # Generator's chunks ask the head for the last row only)
    assert lin.dequant_linear.calls - before == 5 * (3 + N_DECODE)
    for step, (a, b) in enumerate(zip(logits, zlog)):
        assert nmse(a, b) <= NMSE, f"step {step}: nmse {nmse(a, b)}"


@pytest.mark.parametrize("fmt", ["Q8_0", "MXFP4", "Q4_0", "IQ4_NL"])
def test_32_block_weights_at_any_k_dequantize_as_zllm(fmt):
    """A 32-block weight at K = 96 (K % 64 == 32: the qs plane's last
    32-block) and K = 320 repacks to zllm's values, also as
    `params_from_jax` carries zllm's fold-32 and fold-64 planes."""
    import jax.numpy as jnp

    from zllm.quant import blocks as zqb
    from zllm.quant.repack import repack as zrepack
    from zllm_torch.models.loader import params_from_jax
    from zllm_torch.ops import qmatmul as qmm
    from zllm_torch.quant.repack import repack

    gtype = GGMLType[fmt]
    for k in (96, 320):
        raw = zqb.quantize(np.random.default_rng(k).standard_normal((128, k)).astype(np.float32)
                           * 0.05, gtype)
        zq, mine = zrepack(raw, (128, k), gtype), repack(raw, (128, k), gtype, "cpu")
        assert not qmm.supports(mine)
        assert np.array_equal(to_np(mine.dequant()), np.asarray(zq.dequant(jnp.float32)))
        carried = params_from_jax(jax_params_numpy({"layers": [], "w": zq}), device="cpu",
                                  dtype=torch.float32)["w"]
        assert all(torch.equal(p, mine.planes()[n]) for n, p in carried.planes().items())


def test_expert_stacks_dequantize_only_the_picked_experts(files, monkeypatch):
    """A decode step of the quantized file: each layer dequantizes its
    picked experts' gate|up and down stacks, and nothing else of them."""
    from zllm_torch.models import llama
    from zllm_torch.runtime.kvcache import KVCache

    tm = _port_model(files["quant"])
    cfg = tm.cfg
    seen = []
    real = llama.dequant_linear
    monkeypatch.setattr(llama, "dequant_linear", lambda x, w: (seen.append(w.shape), real(x, w))[1])
    kv = KVCache.create(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim, torch.float32, "cpu")
    llama.moe_ffn.routing = []
    try:
        llama.forward(tm.params, cfg, torch.tensor([[7]], dtype=torch.int32),
                      torch.tensor([[0]], dtype=torch.int32), kv, logits_for="last")
        used = [u for _, u, *_ in llama.moe_ffn.routing]
    finally:
        llama.moe_ffn.routing = None
    assert [len(u) for u in used] == [2] * cfg.n_layers
    assert seen == [(320, 192), (96, 320)] * (2 * cfg.n_layers)
