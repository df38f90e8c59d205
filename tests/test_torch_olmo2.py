"""The OLMo-2 slice: 2-layer OLMo-2 files (n_embd 256, 4/4 and 4/2 heads,
byte-level vocab) written by the port's factory, run by zllm and by the
port on the CPU.

  * the config and every loaded weight equal zllm's;
  * with F32 weights (dense f32 matmuls on both sides) the prefill-chunk
    logits and 16 decode-step logits agree with zllm's forward (its
    Generator's steps) at nmse <= 1e-5 (measured up to 2.6e-12: f32 sum
    order only), and greedy generate gives the same tokens and text;
  * with Q4_K weights, zllm runs its Pallas matmul kernels in interpret
    mode (K1 for the decode matvecs, K3 for the prefill GEMMs) and the port
    K1/K3's plain versions: both round matmul inputs to bf16 (prefill) or
    int8 codes (decode), and an f32 sum-order difference of an ulp can move
    one such rounding, which OLMo-2's q/k norms and post-norms carry on
    (measured up to 2.4e-4 over 16 teacher-forced steps); held to
    nmse <= 1e-3;
  * a decode step with the contiguous cache calls K8 (`attn_decode_update`)
    once a layer and K2 (`attn_decode_qkv`) never;
  * the port's Engine gives zllm's Engine's tokens, finish reasons, reused
    prompt tokens and step counters, exactly, in the paged, contiguous f32
    and q8 layouts."""

import time

import numpy as np
import pytest
import torch
from test_torch_oracle import jax_params_numpy, nmse, to_np

from zllm.gguf.constants import GGMLType

SHAPE = dict(n_layers=2, n_embd=256, n_ff=512, vocab_size=512)
HEADS = {"mha": (4, 4), "gqa": (4, 2)}
PROMPT = [1] + list(range(40, 59))  # 20 tokens: two 16-token prefill chunks
N_DECODE = 16


def _olmo2(path, heads, gtype):
    from zllm_torch.testing import make_llama_gguf

    hq, hkv = HEADS[heads]
    return make_llama_gguf(str(path), arch="olmo2", **SHAPE, n_heads=hq, n_kv_heads=hkv,
                           gtype=gtype, norm_eps=1e-6, rope_base=500000.0, with_tokenizer=True)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    folder = tmp_path_factory.mktemp("olmo2")
    return {(heads, gtype.name): _olmo2(folder / f"{heads}_{gtype.name}.gguf", heads, gtype)
            for heads in HEADS for gtype in (GGMLType.Q4_K, GGMLType.F32)}


def _zllm_logits(path, kernels: bool):
    """zllm's prefill logits and 16 teacher-forced decode-step logits (f32
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
        gen = Generator(m, max_len=256, prefill_chunk=16, kv_dtype=jnp.float32)
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
    gen = Generator(m, max_len=256, prefill_chunk=16, kv_dtype=torch.float32)
    logits = [to_np(gen.prefill(PROMPT))]
    for i in range(N_DECODE):
        logits.append(to_np(gen._decode_one(toks[i], len(PROMPT) + i)))
    return logits


@pytest.mark.parametrize("heads", list(HEADS))
def test_config_and_weights_equal_zllm(files, heads):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm_torch.models.loader import Model, params_from_jax
    from zllm_torch.quant.repack import QWeight

    path = files[(heads, "Q4_K")]
    zm = ZModel.load(path, dtype=jnp.float32)
    tm = Model.load(path, device="cpu", dtype=torch.float32)
    for field in ("arch", "n_layers", "n_embd", "n_heads", "n_kv_heads", "head_dim", "n_ff",
                  "vocab_size", "ctx_len", "norm_eps", "attn_logit_softcap",
                  "final_logit_softcap", "logit_scale", "attn_scale"):
        assert getattr(tm.cfg, field) == getattr(zm.cfg, field), field
    assert tuple(tm.cfg.rope) == tuple(zm.cfg.rope) and tm.cfg.rope.style == "neox"
    assert tm.cfg.arch == "olmo2" and not tm.cfg.neox_permuted
    carried = params_from_jax(jax_params_numpy(zm.params), device="cpu", dtype=torch.float32)

    def same(a, b, where):
        assert type(a) is type(b), where
        if isinstance(a, QWeight):
            assert a.shape == b.shape, where
            for name, plane in a.planes().items():
                assert torch.equal(plane, b.planes()[name]), (where, name)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), where

    assert set(tm.params) == set(carried)
    for key in ("tok_emb", "out_norm", "output"):
        same(tm.params[key], carried[key], key)
    for il, (layer, zlayer) in enumerate(zip(tm.params["layers"], carried["layers"])):
        assert set(layer) == set(zlayer) == {"wqkv", "wo", "ffn_gateup", "ffn_down",
                                             "attn_q_norm", "attn_k_norm", "attn_post_norm",
                                             "ffn_post_norm"}
        for key in layer:
            same(layer[key], zlayer[key], (il, key))
    assert tm.params["layers"][0]["attn_q_norm"].shape == (tm.cfg.q_dim,)
    assert tm.params["layers"][0]["attn_k_norm"].shape == (tm.cfg.kv_dim,)


@pytest.mark.parametrize("heads", list(HEADS))
def test_f32_logits_match_zllm_forward(files, heads):
    path = files[(heads, "F32")]
    zlog, ztoks = _zllm_logits(path, kernels=False)
    tlog = _port_logits(path, ztoks)
    assert len(tlog) == len(zlog) == N_DECODE + 1
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (SHAPE["vocab_size"],)
        assert nmse(a, b) <= 1e-5, f"step {step}: nmse {nmse(a, b)}"


@pytest.mark.parametrize("heads", list(HEADS))
def test_q4k_logits_match_zllm_kernels(files, heads):
    path = files[(heads, "Q4_K")]
    zlog, ztoks = _zllm_logits(path, kernels=True)
    tlog = _port_logits(path, ztoks)
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert nmse(a, b) <= 1e-3, f"step {step}: nmse {nmse(a, b)}"


@pytest.mark.parametrize("heads", list(HEADS))
def test_greedy_generate_matches_zllm(files, heads):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.runtime.generate import Generator as ZGenerator
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    path = files[(heads, "F32")]
    zres = ZGenerator(ZModel.load(path, dtype=jnp.float32), max_len=256, prefill_chunk=16,
                      kv_dtype=jnp.float32).generate(PROMPT, max_new=12)
    tres = Generator(Model.load(path, device="cpu", dtype=torch.float32), max_len=256,
                     prefill_chunk=16, kv_dtype=torch.float32).generate(PROMPT, max_new=12)
    assert tres.tokens == list(zres.tokens) and len(tres.tokens) == 12
    assert tres.text == zres.text


def test_decode_steps_take_k8_never_k2(files, monkeypatch):
    from zllm_torch.models import llama
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    calls = {"attn_decode_update": 0, "attn_decode_qkv": 0, "flash_attention": 0}
    for name in calls:
        real = getattr(llama, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(llama, name, spy)
    m = Model.load(files[("gqa", "Q4_K")], device="cpu", dtype=torch.bfloat16)
    gen = Generator(m, max_len=64, prefill_chunk=16)
    gen.prefill(PROMPT)
    # a chunk (T > 1) attends column 0 once more through K8, as the
    # engine's mixed steps must (models/llama.py::_attend)
    assert calls == {"attn_decode_update": 2 * m.cfg.n_layers, "attn_decode_qkv": 0,
                     "flash_attention": 2 * m.cfg.n_layers}
    gen.decode_steps(5, 3)
    assert calls == {"attn_decode_update": 5 * m.cfg.n_layers, "attn_decode_qkv": 0,
                     "flash_attention": 2 * m.cfg.n_layers}


class _Meta:
    """The part of a GGUF file ModelConfig.from_gguf reads."""

    def __init__(self, arch, **extra):
        self.architecture = arch
        self.metadata = {f"{arch}.block_count": 2, f"{arch}.embedding_length": 256,
                         f"{arch}.attention.head_count": 4, f"{arch}.vocab_size": 512,
                         **{f"{arch}.{k}": v for k, v in extra.items()}}

    def kv(self, key, default=None):
        return self.metadata.get(key, default)


@pytest.mark.parametrize("arch,extra", [
    ("olmo2", {}),
    ("qwen3moe", {"expert_count": 8, "expert_used_count": 2, "feed_forward_length": 512}),
    ("hunyuan-dense", {}), ("chameleon", {}),
    ("olmo2", {"attention.sliding_window": 4096}), ("olmo2", {"expert_count": 8}),
    ("olmo2", {"rope.scaling.type": "longrope", "rope.scaling.factor": 4.0}),
], ids=["olmo2", "qwen3moe", "hunyuan", "chameleon", "olmo2_swa", "olmo2_moe", "olmo2_longrope"])
def test_config_refuses_what_the_port_does_not_run(arch, extra):
    """OLMo-2 loads, and so does a qwen3moe file (with zllm's MoeConfig);
    the other q/k-norm families and OLMo-2 files with a sliding window,
    experts (ROADMAP queue 1 item 8) or longrope are refused, not run as
    another model."""
    import dataclasses

    from zllm.models.config import ModelConfig as ZConfig
    from zllm_torch.models.config import ModelConfig

    if arch == "olmo2" and not extra:
        cfg = ModelConfig.from_gguf(_Meta(arch))
        assert cfg.arch == "olmo2" and cfg.rope.style == "neox"
        return
    if arch == "qwen3moe":
        cfg = ModelConfig.from_gguf(_Meta(arch, **extra))
        assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(
            ZConfig.from_gguf(_Meta(arch, **extra)).moe)
        return
    with pytest.raises(NotImplementedError, match="item 8" if "expert_count" in extra else ""):
        ModelConfig.from_gguf(_Meta(arch, **extra))


def test_llama_file_with_olmo2_norms_is_refused(tmp_path):
    """A layer must hold exactly its architecture's norms."""
    from zllm_torch.gguf import read_gguf
    from zllm_torch.gguf.writer import GGUFWriter
    from zllm_torch.models.loader import Model

    src = _olmo2(tmp_path / "o.gguf", "gqa", GGMLType.F32)
    out = str(tmp_path / "as_llama.gguf")
    with read_gguf(src) as f:
        w = GGUFWriter(out, alignment=f.alignment)
        for key, val in f.metadata.items():
            w.add(key.replace("olmo2", "llama"), "llama" if key == "general.architecture" else val)
        for name, meta in f.tensors.items():
            w.add_tensor(name, f.tensor_f32(name))
        w.write()
    with pytest.raises(NotImplementedError, match="norms"):
        Model.load(out, device="cpu", dtype=torch.float32)


COUNTERS = ("tokens_generated_total", "tokens_prefilled_total", "tokens_prefix_reused_total",
            "decode_steps_total", "prefill_steps_total", "context_shifts_total",
            "pages_cow_unshared_total", "engine_errors_total")


def _engine_script(engine, make_request):
    r = np.random.default_rng(3)

    def toks(n):
        return [int(x) for x in r.integers(3, 500, size=n)]

    long = toks(140)  # crosses the first 128-token page
    waves = [[dict(prompt_tokens=toks(37), max_new=8), dict(prompt_tokens=long, max_new=8)],
             [dict(prompt_tokens=long[:130] + [7], max_new=6), dict(prompt_tokens=toks(5),
                                                                    max_new=6)]]
    before = dict(engine.metrics)
    got = []
    for wave in waves:
        # submitted from the engine thread between two steps, so both
        # engines admit a wave at the same step
        reqs = engine.run_in_loop(lambda wave=wave: [engine.submit(make_request(**kw))
                                                     for kw in wave])
        deadline = time.time() + 120
        while not all(q.done for q in reqs):
            assert time.time() < deadline, "engine timed out"
            time.sleep(0.005)
        got += [(list(q.out_tokens), q.finish_reason, q.n_prompt_reused, q.error) for q in reqs]
    return got, {k: engine.metrics[k] - before[k] for k in COUNTERS}


@pytest.mark.parametrize("layout", ["paged", "contiguous", "q8"])
def test_engine_matches_zllm(files, layout):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request

    path = files[("gqa", "F32")]
    zkw, tkw = {"paged": (dict(kv_dtype=jnp.float32), dict(kv_dtype=torch.float32)),
                "contiguous": (dict(kv_layout="contiguous", kv_dtype=jnp.float32),
                               dict(kv_layout="contiguous", kv_dtype=torch.float32)),
                "q8": (dict(kv_dtype="q8"), dict(kv_dtype="q8"))}[layout]
    out = {}
    for side, make_engine, make_request in (
            ("zllm", lambda: ZEngine(ZModel.load(path, dtype=jnp.float32), n_slots=2, max_len=256,
                                     prefill_chunk=16, **zkw), lambda **kw: ZRequest(temp=0.0, **kw)),
            ("port", lambda: Engine(Model.load(path, device="cpu", dtype=torch.float32), n_slots=2,
                                    max_len=256, prefill_chunk=16, **tkw),
             lambda **kw: Request(temp=0.0, **kw))):
        eng = make_engine()
        if side == "port":
            assert eng.paged == (layout == "paged")
        eng.start()
        try:
            out[side] = _engine_script(eng, make_request)
        finally:
            eng.stop()
    (tgot, tcount), (zgot, zcount) = out["port"], out["zllm"]
    assert all(err == "" for *_, err in tgot), tgot
    assert tgot == zgot and tcount == zcount
    assert tcount["decode_steps_total"] > 0 and tcount["prefill_steps_total"] > 0
    assert tgot[2][2] >= 128  # the re-send reuses the long prompt's prefix
