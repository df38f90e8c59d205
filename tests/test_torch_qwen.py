"""The Qwen2 / Qwen3 / Llama-3 slice: 2-layer files (n_embd 256, n_ff 512,
a byte-level BPE vocab of 4096 with 3000 merges) written by the port's
factory, run by zllm and by the port on the CPU:

  * qwen2: 6 query heads / 1 kv head of 128 (G 6, q_dim 768), q/k/v biases,
    tied head; qwen3: 4 / 2 heads of 128 (q_dim 512 != n_embd), per-head
    q/k norms, tied head; both neox rope, base 1e6, pre "qwen2";
    llama3: 4 / 2 heads of 64, rope_freqs.weight with llama3 rope-scaling
    metadata, base 500000, pre "llama-bpe", untied head;
  * the config and every loaded weight equal zllm's;
  * F32 weights: the prefill-chunk logits and 16 teacher-forced decode-step
    logits within nmse 1e-5 of zllm's forward (measured up to 1.2e-12), and
    greedy generate gives zllm's tokens and text;
  * Q4_K and Q4_K_M weights: zllm's Pallas kernels in interpret mode
    against the port's plain versions, nmse <= 1e-3 (measured worst case
    1.06e-4, llama3 Q4_K; qwen3 4.4e-5, qwen2 2.0e-8: an ulp of f32 sum
    order moving an int8 or bf16 rounding of a matmul input, which the
    q/k norms carry on);
  * decode dispatch: a qwen3 step over the contiguous cache hands K2 the
    per-head norms (`qw`/`kw`) once a layer and runs no q/k `rms_norm`; a
    qwen2 step adds the biases on the fused norm->wqkv path (Q4_K) and on
    the unfused wq/wk/wv path (Q4_K_M).  The wrappers' `.launches` count
    launches on the card alone (chip_smoke.py asserts them there), so these
    CPU tests spy on the wrapper calls;
  * the Q4_K_M preset of `python -m zllm_torch.quantize` writes the bytes
    of zllm's tools/quantize.py on qwen2 / qwen3 files (biases and norms
    F32, no output head in a tied file)."""

import numpy as np
import pytest
import torch
from test_torch_oracle import jax_params_numpy, nmse, to_np

from zllm.gguf.constants import GGMLType

SHAPE = dict(n_layers=2, n_embd=256, n_ff=512, vocab_size=4096)
MODELS = {
    "qwen2": dict(arch="qwen2", n_heads=6, n_kv_heads=1, head_dim=128, tied=True,
                  norm_eps=1e-6, rope_base=1e6),
    "qwen3": dict(arch="qwen3", n_heads=4, n_kv_heads=2, head_dim=128, tied=True,
                  norm_eps=1e-6, rope_base=1e6),
    "llama3": dict(arch="llama", n_heads=4, n_kv_heads=2, rope_freqs=True, pre="llama-bpe",
                   rope_base=500000.0),
}
PROMPT = [1] + list(range(40, 59))  # 20 tokens: two 16-token prefill chunks
N_DECODE = 16


def make_file(path, name, gtype):
    from zllm_torch.testing import make_llama_gguf

    kw = dict(dict(pre="qwen2"), **MODELS[name])
    return make_llama_gguf(str(path), **SHAPE, **kw, gtype=gtype, with_tokenizer=True,
                           tokenizer="bpe")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from zllm_torch.quantize import quantize_file

    folder = tmp_path_factory.mktemp("qwen")
    out = {(name, gtype.name): make_file(folder / f"{name}_{gtype.name}.gguf", name, gtype)
           for name in MODELS for gtype in (GGMLType.Q4_K, GGMLType.F32)}
    for name in ("qwen2", "qwen3"):
        src = make_file(folder / f"{name}_F16.gguf", name, GGMLType.F16)
        out[(name, "Q4_K_M")] = str(folder / f"{name}_Q4_K_M.gguf")
        quantize_file(src, out[(name, "Q4_K_M")], "Q4_K_M", quiet=True)
        out[(name, "F16")] = src
    return out


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


@pytest.mark.parametrize("name", list(MODELS))
def test_config_and_weights_equal_zllm(files, name):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm_torch.models.loader import Model, params_from_jax
    from zllm_torch.quant.repack import QWeight

    path = files[(name, "Q4_K")]
    zm = ZModel.load(path, dtype=jnp.float32)
    tm = Model.load(path, device="cpu", dtype=torch.float32)
    for field in ("arch", "n_layers", "n_embd", "n_heads", "n_kv_heads", "head_dim", "n_ff",
                  "vocab_size", "ctx_len", "norm_eps", "attn_logit_softcap",
                  "final_logit_softcap", "logit_scale", "attn_scale", "qkv_bias"):
        assert getattr(tm.cfg, field) == getattr(zm.cfg, field), field
    assert tuple(tm.cfg.rope) == tuple(zm.cfg.rope) and tm.cfg.rope.style == "neox"
    assert tm.cfg.neox_permuted == (name == "llama3")
    assert tm.cfg.rope.scaling == ("llama3" if name == "llama3" else "none")
    assert tm.tokenizer.vocab.model == "gpt2" and tm.tokenizer.vocab.add_bos == (name == "llama3")
    carried = params_from_jax(jax_params_numpy(zm.params), device="cpu", dtype=torch.float32)

    def same(a, b, where):
        assert type(a) is type(b), where
        if isinstance(a, QWeight):
            assert a.shape == b.shape, where
            for plane, val in a.planes().items():
                assert torch.equal(val, b.planes()[plane]), (where, plane)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), where

    assert set(tm.params) == set(carried)
    assert ("rope_freqs" in tm.params) == (name == "llama3")
    for key in set(tm.params) - {"layers"}:
        same(tm.params[key], carried[key], key)
    extra = {"qwen2": {"bqkv"}, "qwen3": {"attn_q_norm", "attn_k_norm"}, "llama3": set()}[name]
    for il, (layer, zlayer) in enumerate(zip(tm.params["layers"], carried["layers"])):
        assert set(layer) == set(zlayer) == {"wqkv", "wo", "ffn_gateup", "ffn_down",
                                             "attn_norm", "ffn_norm"} | extra
        for key in layer:
            same(layer[key], zlayer[key], (il, key))
    layer = tm.params["layers"][0]
    if name == "qwen2":
        assert layer["bqkv"].dtype == torch.float32
        assert layer["bqkv"].shape == (tm.cfg.q_dim + 2 * tm.cfg.kv_dim,)
    if name == "qwen3":
        assert layer["attn_q_norm"].shape == layer["attn_k_norm"].shape == (tm.cfg.head_dim,)


@pytest.mark.parametrize("name", ["qwen2", "qwen3"])
def test_q4km_weights_equal_zllm(files, name):
    """The Q4_K_M file: wq / wk Q4_K and wv Q6_K stay apart, and so do
    their biases."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm_torch.models.loader import Model, params_from_jax

    path = files[(name, "Q4_K_M")]
    tm = Model.load(path, device="cpu", dtype=torch.float32)
    carried = params_from_jax(jax_params_numpy(ZModel.load(path, dtype=jnp.float32).params),
                              device="cpu", dtype=torch.float32)
    for layer, zlayer in zip(tm.params["layers"], carried["layers"]):
        assert set(layer) == set(zlayer) and "wqkv" not in layer and "wq" in layer
        assert ("bq" in layer) == (name == "qwen2") and "bqkv" not in layer
        for key in ("bq", "bk", "bv", "attn_q_norm", "attn_k_norm"):
            if key in layer:
                assert torch.equal(layer[key], zlayer[key]), key


@pytest.mark.parametrize("name", list(MODELS))
def test_f32_logits_match_zllm_forward(files, name):
    path = files[(name, "F32")]
    zlog, ztoks = _zllm_logits(path, kernels=False)
    tlog = _port_logits(path, ztoks)
    assert len(tlog) == len(zlog) == N_DECODE + 1
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (SHAPE["vocab_size"],)
        assert nmse(a, b) <= 1e-5, f"step {step}: nmse {nmse(a, b)}"


@pytest.mark.parametrize("name,ftype", [("qwen2", "Q4_K"), ("qwen3", "Q4_K"), ("llama3", "Q4_K"),
                                        ("qwen2", "Q4_K_M"), ("qwen3", "Q4_K_M")])
def test_quantized_logits_match_zllm_kernels(files, name, ftype):
    path = files[(name, ftype)]
    zlog, ztoks = _zllm_logits(path, kernels=True)
    tlog = _port_logits(path, ztoks)
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert nmse(a, b) <= 1e-3, f"step {step}: nmse {nmse(a, b)}"


@pytest.mark.parametrize("name", list(MODELS))
def test_greedy_generate_matches_zllm(files, name):
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.runtime.generate import Generator as ZGenerator
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    path = files[(name, "F32")]
    zm = ZModel.load(path, dtype=jnp.float32)
    tm = Model.load(path, device="cpu", dtype=torch.float32)
    prompt = tm.tokenizer.encode("Grüße aus 東京, it's 2024! 😀", add_special=True)
    assert prompt == zm.tokenizer.encode("Grüße aus 東京, it's 2024! 😀", add_special=True)
    zres = ZGenerator(zm, max_len=256, prefill_chunk=16, kv_dtype=jnp.float32).generate(
        prompt, max_new=12)
    tres = Generator(tm, max_len=256, prefill_chunk=16, kv_dtype=torch.float32).generate(
        prompt, max_new=12)
    assert tres.tokens == list(zres.tokens) and len(tres.tokens) == 12
    assert tres.text == zres.text


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)


def test_qwen3_decode_step_takes_k2_with_the_head_norms(files, monkeypatch):
    from zllm_torch.models import llama
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    m = Model.load(files[("qwen3", "Q4_K")], device="cpu", dtype=torch.bfloat16)
    norms = {id(layer[k]) for layer in m.params["layers"] for k in ("attn_q_norm", "attn_k_norm")}
    k2, rms = [], []
    _spy(monkeypatch, llama, "attn_decode_qkv", k2)
    _spy(monkeypatch, llama, "rms_norm", rms)

    def head_norms():  # rms_norm calls on q or k with a per-head norm
        return sum(id(args[1]) in norms for args, _ in rms)

    def with_norms():  # K2 calls handed that layer's qw / kw
        return [id(args[5]) in norms and id(args[6]) in norms for args, _ in k2]

    gen = Generator(m, max_len=64, prefill_chunk=16)
    gen.prefill(PROMPT)
    n_l = m.cfg.n_layers
    # each chunk: q and k normed per head before rope, and K2 on column 0
    assert head_norms() == 2 * 2 * n_l and with_norms() == [True] * 2 * n_l
    k2.clear(), rms.clear()
    gen.decode_steps(5, 3)
    assert with_norms() == [True] * 3 * n_l and head_norms() == 0


@pytest.mark.parametrize("ftype", ["Q4_K", "Q4_K_M"])
def test_qwen2_decode_step_adds_the_biases(files, monkeypatch, ftype):
    """Q4_K: the fused norm->wqkv matvec, then bqkv; Q4_K_M: wq, wk, wv
    apart (wv is Q6_K), each with its bias."""
    from zllm_torch.models import llama
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    m = Model.load(files[("qwen2", ftype)], device="cpu", dtype=torch.float32)
    fused = ftype == "Q4_K"
    assert ("wqkv" in m.params["layers"][0]) == fused
    calls = []
    _spy(monkeypatch, llama, "fused_norm_linear", calls)

    def step():
        gen = Generator(m, max_len=64, prefill_chunk=16, kv_dtype=torch.float32)
        gen.prefill(PROMPT)
        calls.clear()
        return gen._decode_one(7, len(PROMPT))

    with_bias = step()
    wqkv = {id(layer.get("wqkv")) for layer in m.params["layers"]}
    assert sum(id(args[3]) in wqkv for args, _ in calls) == (m.cfg.n_layers if fused else 0)
    for layer in m.params["layers"]:
        for key in ("bqkv", "bq", "bk", "bv"):
            if key in layer:
                layer[key] = torch.zeros_like(layer[key])
    assert nmse(to_np(step()), to_np(with_bias)) > 1e-3


@pytest.mark.parametrize("name", ["qwen2", "qwen3"])
def test_quantize_q4km_matches_zllm(files, tmp_path, name):
    from tools.quantize import quantize_file as zquantize
    from zllm_torch.gguf import read_gguf
    from zllm_torch.quantize import quantize_file

    src = files[(name, "F16")]
    mine, theirs = str(tmp_path / "port.gguf"), str(tmp_path / "zllm.gguf")
    plan = quantize_file(src, mine, "Q4_K_M", quiet=True)
    zquantize(src, theirs, "Q4_K_M", quiet=True)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert "output.weight" not in plan and plan["blk.0.attn_v.weight"][1] == "Q6_K"
    vectors = [n for n in plan if n.endswith((".bias", "_norm.weight"))]
    assert vectors and all(plan[n][1] == "F32" for n in vectors)
    with read_gguf(mine) as f:
        assert f.tensors["blk.0.attn_q.weight"].gtype == GGMLType.Q4_K


@pytest.mark.parametrize("arch,extra", [
    ("qwen2", {"attention.sliding_window": 32768}), ("qwen3", {"expert_count": 8}),
    ("qwen2moe", {"expert_count": 60, "expert_used_count": 4, "expert_shared_count": 1,
                  "expert_feed_forward_length": 1408}),
    ("qwen3", {"embedding_scale": 2.0}),
], ids=["qwen2_swa", "qwen3_moe", "qwen2moe", "qwen3_emb_scale"])
def test_config_refuses_what_the_port_does_not_run(arch, extra):
    """A qwen2moe file loads with zllm's MoeConfig; experts on qwen3 (ROADMAP
    queue 1 item 8), a window and an embedding scale are refused."""
    import dataclasses

    from zllm.models.config import ModelConfig as ZConfig
    from zllm_torch.models.config import ModelConfig

    class Meta:
        architecture = arch
        metadata = {f"{arch}.block_count": 2, f"{arch}.embedding_length": 256,
                    f"{arch}.attention.head_count": 4, f"{arch}.vocab_size": 512,
                    **{f"{arch}.{k}": v for k, v in extra.items()}}

        def kv(self, key, default=None):
            return self.metadata.get(key, default)

    if arch == "qwen2moe":
        cfg = ModelConfig.from_gguf(Meta())
        assert cfg.qkv_bias and dataclasses.asdict(cfg.moe) == dataclasses.asdict(
            ZConfig.from_gguf(Meta()).moe)
        return
    with pytest.raises(NotImplementedError, match="item 8" if "expert_count" in extra else ""):
        ModelConfig.from_gguf(Meta())


def test_qwen3_norms_of_the_wrong_length_are_refused(tmp_path):
    """Per-head (Qwen3) and whole-projection (OLMo-2) q/k norms are told
    apart by their length: a qwen3 file with OLMo-2's is refused."""
    from zllm_torch.gguf import read_gguf
    from zllm_torch.gguf.writer import GGUFWriter
    from zllm_torch.models.loader import Model

    src = make_file(tmp_path / "q.gguf", "qwen3", GGMLType.F32)
    out = str(tmp_path / "long_norms.gguf")
    with read_gguf(src) as f:
        w = GGUFWriter(out, alignment=f.alignment)
        for key, val in f.metadata.items():
            w.add(key, val)
        for name in f.tensors:
            x = f.tensor_f32(name)
            w.add_tensor(name, np.tile(x, 4) if name.endswith("attn_q_norm.weight") else x)
        w.write()
    with pytest.raises(NotImplementedError, match="q/k norms of length"):
        Model.load(out, device="cpu", dtype=torch.float32)
