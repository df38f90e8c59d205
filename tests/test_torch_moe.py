"""The mixture-of-experts slice on the CPU, zllm the oracle:

  * `MoeConfig` resolved from llama (Mixtral-style), qwen2moe and qwen3moe
    metadata equals zllm's field for field, and every routing option the
    port's `moe_ffn` does not apply, and experts on another architecture,
    is a NotImplementedError naming ROADMAP queue 1 item 8;
  * the expert stack (`QWeightE`): `dequant()` and `dequant_gather()` equal
    zllm's `QTensorE` bit for bit for Q4_K, Q5_K, Q6_K, Q8_0 and Q4_0, and
    a QTensorE carried across by `params_from_jax` holds the port's own
    planes;
  * `moe_ffn` against zllm's at T = 1 (zllm's sparse regime) and T = 16
    (T * k >= E: its dense masked regime), Q4_K (K3's plain version), Q6_K
    (K5's) and F16 (dense, torch.matmul) stacks, with and without qwen2moe's
    shared expert;
  * 2-layer llama-MoE (zllm's factory), qwen2moe (shared expert) and
    qwen3moe (q/k norms) Q4_K files (zllm's converter) against zllm: the
    prefill logits, then greedy Generator tokens;
  * a 4-slot engine on a qwen3moe file: concurrent texts equal sequential;
  * a qwen2moe F16 file to Q4_K_M by `zllm_torch.quantize`, byte-equal to
    tools/quantize.py's;
  * the importance-matrix taps of an MoE layer are zllm's (the FFN input
    under ffn_gate.weight, no expert's).

Tolerances.  zllm runs its experts as XLA einsums in the model dtype (f32
here), the port through K3/K5, whose plain versions round x and the
dequantized weight to bf16 (the card's operand type; in a bf16 model the
two take the same operands): nmse <= 1e-4 on one FFN's output, <= 1e-3
on a 2-layer model's logits rows, where the attention's q/k norms and the
next layer carry the rounding on (measured up to 1.03e-4, qwen3moe).  Routing ties: where a token's
picks differ from zllm's, the test passes only if zllm's k-th to (k+1)-th
probability gap there is below TIE_GAP (the two sides' router inputs
differ by that rounding); the data is never re-seeded to avoid a tie."""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_oracle import gemma_tokenizer_kv, jax_params_numpy, nmse, to_np

from zllm.gguf.constants import GGMLType

NMSE = 1e-4
NMSE_MODEL = 1e-3
TIE_GAP = 1e-3
E, K_USED, N_EMBD, N_FF = 8, 2, 256, 256


# ---- MoeConfig ---------------------------------------------------------------

class _Meta:
    """The part of a GGUF file ModelConfig.from_gguf reads."""

    def __init__(self, arch, **extra):
        self.architecture = arch
        self.metadata = {f"{arch}.block_count": 2, f"{arch}.embedding_length": 256,
                         f"{arch}.attention.head_count": 4, f"{arch}.vocab_size": 512,
                         f"{arch}.feed_forward_length": 512,
                         **{f"{arch}.{k}": v for k, v in extra.items()}}

    def kv(self, key, default=None):
        return self.metadata.get(key, default)


MOE_KEYS = dict(expert_count=8, expert_used_count=2)
CONFIG_CASES = {
    "llama": ("llama", MOE_KEYS),
    "llama_ff": ("llama", dict(MOE_KEYS, expert_feed_forward_length=128)),
    "qwen2moe": ("qwen2moe", dict(MOE_KEYS, expert_shared_count=1,
                                  expert_shared_feed_forward_length=512)),
    "qwen3moe": ("qwen3moe", dict(expert_count=128, expert_used_count=8,
                                  expert_feed_forward_length=768)),
    "qwen2moe_norm": ("qwen2moe", dict(MOE_KEYS, expert_weights_norm=True)),
    "qwen3moe_no_norm": ("qwen3moe", dict(MOE_KEYS, norm_topk_prob=False)),
    "llama_sigmoid_scale": ("llama", dict(MOE_KEYS, expert_gating_func=2,
                                          expert_weights_scale=2.5)),
    "llama_softmax_weight": ("llama", dict(MOE_KEYS, expert_gating_func=3)),
    "gpt_oss": ("gpt-oss", dict(expert_count=32, expert_used_count=4,
                                expert_feed_forward_length=2880)),
    "dense_llama": ("llama", {}),
}


@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_moe_config_equals_zllm(case):
    from zllm.models.config import ModelConfig as ZConfig
    from zllm_torch.models.config import ModelConfig

    arch, extra = CONFIG_CASES[case]
    mine = ModelConfig.from_gguf(_Meta(arch, **extra))
    theirs = ZConfig.from_gguf(_Meta(arch, **extra))
    if theirs.moe is None:
        assert mine.moe is None
        return
    assert dataclasses.asdict(mine.moe) == dataclasses.asdict(theirs.moe)
    assert mine.qkv_bias == theirs.qkv_bias and mine.rope.style == theirs.rope.style


REFUSALS = {
    "expert_groups": ("qwen3moe", dict(MOE_KEYS, expert_group_count=2,
                                       expert_group_used_count=1)),
    "router_softcap": ("llama", dict(MOE_KEYS, router_logit_softcapping=30.0)),
    "leading_dense": ("qwen2moe", dict(MOE_KEYS, leading_dense_block_count=1)),
    "experts_per_group": ("qwen3moe", dict(MOE_KEYS, experts_per_group=2)),
    "olmo2_experts": ("olmo2", MOE_KEYS),
    "qwen3_experts": ("qwen3", MOE_KEYS),
    "qwen2_experts": ("qwen2", MOE_KEYS),
    "gemma_experts": ("gemma", MOE_KEYS),
    "gemma2_experts": ("gemma2", MOE_KEYS),
    "gemma3_experts": ("gemma3", MOE_KEYS),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_moe_config_refuses_what_moe_ffn_does_not_apply(case):
    from zllm_torch.models.config import ModelConfig

    arch, extra = REFUSALS[case]
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        ModelConfig.from_gguf(_Meta(arch, **extra))


def test_longrope_keeps_its_own_refusal():
    from zllm_torch.models.config import ModelConfig

    meta = _Meta("llama", **{"rope.scaling.type": "longrope", "rope.scaling.factor": 4.0})
    with pytest.raises(NotImplementedError, match="longrope"):
        ModelConfig.from_gguf(meta)


# ---- expert stacks -------------------------------------------------------------

STACK_FMTS = [GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q8_0, GGMLType.Q4_0]


def _stack_raw(fmt, e: int, n: int, k: int, seed: int) -> np.ndarray:
    from zllm.quant import blocks as zqb

    rng = np.random.default_rng(seed)
    return zqb.quantize(rng.standard_normal((e, n, k)).astype(np.float32) * 0.05, fmt)


@pytest.mark.parametrize("fmt", STACK_FMTS, ids=lambda f: f.name)
def test_expert_stack_equals_qtensore(fmt):
    """dequant() and dequant_gather() bit for bit; the QTensorE carried by
    params_from_jax holds the port's own planes."""
    import jax.numpy as jnp

    from zllm.quant.repack import repack_experts as zrepack
    from zllm_torch.models.loader import params_from_jax
    from zllm_torch.quant.repack import repack_experts

    e, n, k = 4, 128, 512
    raw = _stack_raw(fmt, e, n, k, int(fmt))
    zq = zrepack(raw, (e, n, k), fmt)
    mine = repack_experts(raw, (e, n, k), fmt, "cpu")
    assert mine.shape == tuple(zq.shape) == (e, k, n)
    assert np.array_equal(to_np(mine.dequant()), np.asarray(zq.dequant(jnp.float32)))
    idx = np.array([[3, 1], [1, 0]], np.int32)
    assert np.array_equal(to_np(mine.dequant_gather(torch.from_numpy(idx))),
                          np.asarray(zq.dequant_gather(jnp.asarray(idx), jnp.float32)))
    carried = params_from_jax(jax_params_numpy({"layers": [{"ffn_up_exps": zq}]}),
                              device="cpu", dtype=torch.float32)["layers"][0]["ffn_up_exps"]
    assert carried.fmt == mine.fmt and carried.shape == mine.shape
    assert all(torch.equal(carried.planes[name], p) for name, p in mine.planes.items())
    assert all(mine.expert(i).planes()[name].is_contiguous() for i in range(e)
               for name in mine.planes)


# ---- moe_ffn -------------------------------------------------------------------

def _ffn_layers(stack: str, shared: bool, seed: int):
    """zllm's and the port's layer dicts of one MoE FFN from the same data:
    a dense f32 router [E, N_EMBD] (GGUF rows), expert stacks in `stack`'s
    format (F16: dense [E, K, N] stacks, as both loaders keep them), and
    with `shared` qwen2moe's shared expert (Q4_K) and its gate."""
    import jax.numpy as jnp

    from zllm.quant import blocks as zqb
    from zllm.quant.repack import repack as zrepack2
    from zllm.quant.repack import repack_experts as zrepack
    from zllm_torch.quant.repack import repack, repack_experts

    rng = np.random.default_rng(seed)
    router = rng.standard_normal((E, N_EMBD)).astype(np.float32) * 0.5
    zl = {"ffn_gate_inp": jnp.asarray(router.T)}
    tl = {"ffn_gate_inp": torch.from_numpy(np.ascontiguousarray(router.T))}
    for name, (n, k) in (("ffn_gate_exps", (N_FF, N_EMBD)), ("ffn_up_exps", (N_FF, N_EMBD)),
                         ("ffn_down_exps", (N_EMBD, N_FF))):
        x = rng.standard_normal((E, n, k)).astype(np.float32) * 0.05
        if stack == "F16":
            dense = np.ascontiguousarray(np.swapaxes(x.astype(np.float16).astype(np.float32), 1, 2))
            zl[name], tl[name] = jnp.asarray(dense), torch.from_numpy(dense)
        else:
            fmt = GGMLType[stack]
            raw = zqb.quantize(x, fmt)
            zl[name], tl[name] = zrepack(raw, (E, n, k), fmt), repack_experts(raw, (E, n, k), fmt,
                                                                               "cpu")
    if shared:
        for name, (n, k) in (("ffn_gate_shexp", (N_FF, N_EMBD)), ("ffn_up_shexp", (N_FF, N_EMBD)),
                             ("ffn_down_shexp", (N_EMBD, N_FF))):
            raw = zqb.quantize(rng.standard_normal((n, k)).astype(np.float32) * 0.05,
                               GGMLType.Q4_K)
            zl[name] = zrepack2(raw, (n, k), GGMLType.Q4_K)
            tl[name] = repack(raw, (n, k), GGMLType.Q4_K, "cpu")
        gate = rng.standard_normal((N_EMBD, 1)).astype(np.float32) * 0.2
        zl["ffn_gate_inp_shexp"] = jnp.asarray(gate)
        tl["ffn_gate_inp_shexp"] = torch.from_numpy(gate)
    return zl, tl


def _routing_ties_ok(probs: np.ndarray, mine: np.ndarray, theirs: np.ndarray, k: int) -> bool:
    """Every token whose picks differ has a k-th to (k+1)-th gap < TIE_GAP
    in zllm's probabilities."""
    for t in np.nonzero((np.sort(mine, -1) != np.sort(theirs, -1)).any(-1))[0]:
        p = np.sort(probs[t])[::-1]
        if p[k - 1] - p[k] >= TIE_GAP:
            return False
    return True


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("stack", ["Q4_K", "Q6_K", "F16"])
@pytest.mark.parametrize("t", [1, 16], ids=["sparse_t1", "dense_t16"])
def test_moe_ffn_matches_zllm(t, stack, shared):
    import jax
    import jax.numpy as jnp

    from zllm.models.config import MoeConfig as ZMoe
    from zllm.models.llama import moe_ffn as zmoe
    from zllm_torch.models.config import MoeConfig
    from zllm_torch.models.llama import moe_ffn

    zl, tl = _ffn_layers(stack, shared, 7 + t)
    kw = dict(n_experts=E, n_experts_used=K_USED, n_ff_exp=N_FF, norm_topk_prob=not shared)
    h = np.random.default_rng(t).standard_normal((1, t, N_EMBD)).astype(np.float32)
    want = to_np(zmoe(zl, SimpleNamespace(moe=ZMoe(**kw), act="silu"), jnp.asarray(h)))
    moe_ffn.routing = []
    try:
        got = to_np(moe_ffn(tl, SimpleNamespace(moe=MoeConfig(**kw), act="silu"),
                            torch.from_numpy(h)))
        (_, used, *_), = moe_ffn.routing
    finally:
        moe_ffn.routing = None
    probs = np.asarray(jax.nn.softmax(jnp.asarray(h[0]) @ zl["ffn_gate_inp"], axis=-1))
    picks = np.argsort(-probs, axis=-1, kind="stable")[:, :K_USED]
    mine = torch.topk(torch.softmax(torch.from_numpy(h[0]) @ tl["ffn_gate_inp"], -1),
                      K_USED).indices.numpy()
    assert used == sorted(set(mine.reshape(-1).tolist()))
    if not np.array_equal(np.sort(mine, -1), np.sort(picks, -1)):
        assert _routing_ties_ok(probs, mine, picks, K_USED)
        return  # a tie: the outputs of the differing tokens differ
    assert got.shape == want.shape and np.isfinite(got).all()
    # F16 stacks run torch.matmul on the same f32 operands: f32 sum order
    # only (the shared expert is Q4_K: K1's or K3's plain version)
    assert nmse(got, want) <= (1e-10 if stack == "F16" and not shared else NMSE)


# ---- 2-layer models ----------------------------------------------------------------

PROMPT = [1] + list(range(40, 59))  # 20 tokens: two prefill chunks of 16
N_DECODE = 8
NL, NH, NKV, HD, V = 2, 4, 2, 64, 512


def _hf_moe_state(rng, qk_norm: bool, bias: bool, shared: bool) -> dict:
    """A seeded HF-style Qwen MoE state dict (numpy f32): E experts of N_FF,
    qwen2moe's shared expert of N_FF and its gate with `shared`."""
    def w(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, N_EMBD, s=0.5),
          "model.norm.weight": w(N_EMBD, s=0.1) + 1.0, "lm_head.weight": w(V, N_EMBD)}
    for il in range(NL):
        p = f"model.layers.{il}."
        sd.update({p + "input_layernorm.weight": w(N_EMBD, s=0.1) + 1.0,
                   p + "post_attention_layernorm.weight": w(N_EMBD, s=0.1) + 1.0,
                   p + "self_attn.q_proj.weight": w(NH * HD, N_EMBD),
                   p + "self_attn.k_proj.weight": w(NKV * HD, N_EMBD),
                   p + "self_attn.v_proj.weight": w(NKV * HD, N_EMBD),
                   p + "self_attn.o_proj.weight": w(N_EMBD, NH * HD),
                   p + "mlp.gate.weight": w(E, N_EMBD, s=0.5)})
        if qk_norm:
            sd[p + "self_attn.q_norm.weight"] = w(HD, s=0.1) + 1.0
            sd[p + "self_attn.k_norm.weight"] = w(HD, s=0.1) + 1.0
        if bias:
            for x, n in (("q", NH), ("k", NKV), ("v", NKV)):
                sd[p + f"self_attn.{x}_proj.bias"] = w(n * HD, s=0.2)
        for e in range(E):
            q = f"{p}mlp.experts.{e}."
            sd.update({q + "gate_proj.weight": w(N_FF, N_EMBD),
                       q + "up_proj.weight": w(N_FF, N_EMBD),
                       q + "down_proj.weight": w(N_EMBD, N_FF)})
        if shared:
            q = p + "mlp.shared_expert."
            sd.update({q + "gate_proj.weight": w(N_FF, N_EMBD),
                       q + "up_proj.weight": w(N_FF, N_EMBD),
                       q + "down_proj.weight": w(N_EMBD, N_FF),
                       p + "mlp.shared_expert_gate.weight": w(1, N_EMBD, s=0.2)})
    return sd


def _hf_moe_config(**kw) -> dict:
    return dict(vocab_size=V, hidden_size=N_EMBD, intermediate_size=512, num_hidden_layers=NL,
                num_attention_heads=NH, num_key_value_heads=NKV, head_dim=HD,
                max_position_embeddings=512, rms_norm_eps=1e-6, rope_theta=10000.0,
                tie_word_embeddings=False, num_experts=E, num_experts_per_tok=K_USED,
                moe_intermediate_size=N_FF, **kw)


def _model_file(folder, name: str) -> str:
    """The 2-layer Q4_K files: llama-MoE from zllm's factory, qwen2moe and
    qwen3moe from zllm's converter."""
    path = str(folder / f"{name}.gguf")
    if name == "llama":
        from zllm.testing import make_llama_gguf

        return make_llama_gguf(path, n_layers=NL, n_embd=N_EMBD, n_heads=NH, n_kv_heads=NKV,
                               n_ff=N_FF, vocab_size=V, n_experts=E, n_experts_used=K_USED,
                               with_tokenizer=True)
    from zllm.convert import convert_hf_llama

    rng = np.random.default_rng(11 if name == "qwen2moe" else 12)
    if name == "qwen2moe":
        sd, cfg = _hf_moe_state(rng, False, True, True), _hf_moe_config(
            shared_expert_intermediate_size=N_FF, norm_topk_prob=False)
    else:
        sd, cfg = _hf_moe_state(rng, True, False, False), _hf_moe_config(norm_topk_prob=True)
    return convert_hf_llama(sd, cfg, path, arch=name, gtype=GGMLType.Q4_K,
                            tokenizer_kv=gemma_tokenizer_kv(V))


MODELS = ("llama", "qwen2moe", "qwen3moe")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    folder = tmp_path_factory.mktemp("moe")
    return {name: _model_file(folder, name) for name in MODELS}


def _zllm_run(path):
    """zllm's prefill logits and N_DECODE greedy decode-step logits (f32
    cache, its Pallas kernels in interpret mode for the dense matmuls) and
    its tokens."""
    import jax.numpy as jnp

    from zllm.models.loader import Model
    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.runtime.generate import Generator

    m = Model.load(path, dtype=jnp.float32)
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
    return m, logits, toks


@pytest.mark.parametrize("name", MODELS)
def test_moe_model_matches_zllm(files, name):
    """The config and the carried weights equal zllm's; the prefill logits
    and the decode steps (teacher-forced by zllm's tokens) within NMSE_MODEL; the
    port's own greedy Generator gives zllm's tokens, or parts from them
    only where zllm's top-two logit gap is below TIE_GAP."""
    from zllm_torch.models.loader import Model, params_from_jax
    from zllm_torch.quant.repack import QWeightE
    from zllm_torch.runtime.generate import Generator

    zm, zlogits, ztoks = _zllm_run(files[name])
    tm = Model.load(files[name], device="cpu", dtype=torch.float32)
    assert dataclasses.asdict(tm.cfg.moe) == dataclasses.asdict(zm.cfg.moe)
    carried = params_from_jax(jax_params_numpy(zm.params), device="cpu", dtype=torch.float32)
    for mine, theirs in zip(tm.params["layers"], carried["layers"]):
        assert isinstance(mine["ffn_down_exps"], QWeightE)
        fused = mine["ffn_gateup_exps"]
        half = fused.shape[2] // 2
        for key, cut in (("ffn_gate_exps", slice(0, half)), ("ffn_up_exps", slice(half, None))):
            assert all(torch.equal(p[:, cut], theirs[key].planes[n])
                       for n, p in fused.planes.items()), key
        assert all(torch.equal(p, theirs["ffn_down_exps"].planes[n])
                   for n, p in mine["ffn_down_exps"].planes.items())
    gen = Generator(tm, max_len=256, prefill_chunk=16, kv_dtype=torch.float32)
    logits = [to_np(gen.prefill(PROMPT))]
    for i in range(N_DECODE):
        logits.append(to_np(gen._decode_one(ztoks[i], len(PROMPT) + i)))
    errs = [nmse(a, b) for a, b in zip(logits, zlogits)]
    assert max(errs) <= NMSE_MODEL, errs
    toks = Generator(tm, max_len=256, prefill_chunk=16,
                     kv_dtype=torch.float32).generate(PROMPT, max_new=N_DECODE + 1).tokens
    for i, (a, b) in enumerate(zip(toks, ztoks)):
        if a != b:
            top = np.sort(zlogits[i])[::-1]
            assert top[0] - top[1] < TIE_GAP, (i, toks, ztoks)
            break


def test_moe_engine_concurrent_equals_sequential(files):
    """A 4-slot paged engine on the qwen3moe file: three greedy requests
    served together give the tokens they give one at a time."""
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request

    model = Model.load(files["qwen3moe"], device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(5)
    prompts = [[1] + [int(x) for x in rng.integers(3, V, n - 1)] for n in (40, 23, 9)]

    def serve(groups):
        eng = Engine(model, n_slots=4, max_len=128, prefill_chunk=16, kv_dtype=torch.float32)
        eng.start()
        out = {}
        try:
            for group in groups:
                reqs = eng.run_in_loop(lambda g=group: [
                    eng.submit(Request(prompt_tokens=p, max_new=6, temp=0.0)) for p in g])
                deadline = time.time() + 120
                while not all(r.done for r in reqs):
                    assert time.time() < deadline, "engine timed out"
                    time.sleep(0.005)
                out.update({tuple(r.prompt_tokens): list(r.out_tokens) for r in reqs})
        finally:
            eng.stop()
        return out

    together, alone = serve([prompts]), serve([[p] for p in prompts])
    assert together == alone and all(len(v) == 6 for v in together.values())


def test_moe_quantize_bytes_equal_zllm(tmp_path):
    """qwen2moe F16 (the factory's, with a shared expert; expert FFN 128,
    so the down stacks fall back to F16) to Q4_K_M: the bytes of
    tools/quantize.py; the file loads with K3-bound Q4_K gate|up stacks
    and dense down stacks."""
    from tools.quantize import quantize_file as zquantize
    from zllm_torch.models.loader import Model
    from zllm_torch.quant.repack import QWeightE
    from zllm_torch.quantize import quantize_file
    from zllm_torch.testing import make_llama_gguf

    src = make_llama_gguf(str(tmp_path / "f16.gguf"), arch="qwen2moe", n_layers=2, n_embd=256,
                          n_heads=4, n_kv_heads=2, n_ff=128, vocab_size=512, n_experts=4,
                          n_experts_used=2, n_ff_shexp=256, gtype=GGMLType.F16,
                          with_tokenizer=True)
    mine, theirs = str(tmp_path / "port.gguf"), str(tmp_path / "zllm.gguf")
    plan = quantize_file(src, mine, "Q4_K_M", quiet=True)
    zquantize(src, theirs, "Q4_K_M", quiet=True)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert plan["blk.0.ffn_gate_exps.weight"][1] == "Q4_K"
    assert plan["blk.0.ffn_down_exps.weight"][1] == "F16"
    layer = Model.load(mine, device="cpu", dtype=torch.float32).params["layers"][0]
    assert isinstance(layer["ffn_gateup_exps"], QWeightE)
    assert layer["ffn_down_exps"].shape == (4, 128, 256)


def test_moe_taps_equal_zllm(files):
    """forward(..., taps=) on an MoE file records zllm's names: the FFN's
    input under ffn_gate.weight and no ffn_down.weight (zllm taps no
    expert's input), so `zllm_torch.imatrix` collects what tools/imatrix.py
    collects."""
    import jax.numpy as jnp

    from zllm.models.llama import forward as zforward
    from zllm.models.loader import Model as ZModel
    from zllm_torch.models.llama import forward
    from zllm_torch.models.loader import Model

    path = files["llama"]
    toks = np.array([PROMPT], np.int32)
    pos = np.arange(len(PROMPT), dtype=np.int32)[None]
    zm = ZModel.load(path, dtype=jnp.float32)
    ztaps: dict = {}
    zforward(zm.params, zm.cfg, jnp.asarray(toks), jnp.asarray(pos), None, taps=ztaps)
    tm = Model.load(path, device="cpu", dtype=torch.float32)
    taps: dict = {}
    forward(tm.params, tm.cfg, torch.from_numpy(toks), torch.from_numpy(pos), None, taps=taps)
    assert set(taps) == set(ztaps) and "blk.0.ffn_down.weight" not in taps
    for name in ("blk.0.ffn_gate.weight", "blk.1.ffn_gate.weight"):
        assert nmse(to_np(taps[name]), to_np(ztaps[name])) <= NMSE
