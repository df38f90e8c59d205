"""The slice end to end: zllm_torch's Generator against zllm's on one Q4_K
llama GGUF, prefill in two chunks then greedy decode.

zllm runs f32 with its Pallas kernels installed in interpret mode
(qmatmul.install(interpret=True)): K1 for every decode matvec and K3 for
every prefill matmul.  On the CPU its attention takes the unfused path
(rope, cache update, attention_ref), so the port's K2/K6 rounding points
are what the tolerances cover.

With f32 caches on both sides those rounding points are exact, and the
logits agree within nmse < 2e-4 (measured up to 6e-5: both sides round
matmul inputs to bf16 and decode activations to int8 codes, so an f32
sum-order difference of an ulp can move one rounding, which then shows as
a jump).  The port's default bf16 cache is held against the same f32-cache
zllm run: the cache rounds K/V to bf16, and K2 and K6 also cast the roped
q and the probabilities to bf16 where the unfused reference keeps f32;
measured up to 3e-4 at this size, held to nmse < 1e-3.  Greedy tokens are
identical in both."""

import numpy as np
import pytest
import torch
from test_torch_oracle import SMALL_LLAMA, nmse, to_np

PROMPT = [1] + list(range(40, 59))  # 20 tokens: two 16-token prefill chunks
N_DECODE = 8


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    path = str(tmp_path_factory.mktemp("s") / "slice.gguf")
    make_llama_gguf(path, **SMALL_LLAMA, with_tokenizer=True)
    return path


def _zllm_run(path, kv_dtype):
    import jax.numpy as jnp

    from zllm.models.loader import Model
    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.runtime.generate import Generator

    m = Model.load(path, dtype=jnp.float32)
    qmatmul.install(interpret=True)
    try:
        gen = Generator(m, max_len=256, prefill_chunk=16, kv_dtype=kv_dtype)
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


def _port_run(path, kv_dtype):
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    m = Model.load(path, device="cpu", dtype=torch.float32)
    gen = Generator(m, max_len=256, prefill_chunk=16, kv_dtype=kv_dtype)
    logits = [to_np(gen.prefill(PROMPT))]
    toks = [int(np.argmax(logits[0]))]
    for i in range(N_DECODE):
        logits.append(to_np(gen._decode_one(toks[-1], len(PROMPT) + i)))
        toks.append(int(np.argmax(logits[-1])))
    # the public loop gives the same tokens
    gen.reset()
    res = gen.generate(PROMPT, max_new=N_DECODE + 1)
    assert res.tokens == toks
    return logits, toks


@pytest.fixture(scope="module")
def zllm_f32(gguf):
    import jax.numpy as jnp

    return _zllm_run(gguf, jnp.float32)


@pytest.mark.parametrize("kv_dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 1e-3)],
                         ids=["f32cache", "bf16cache"])
def test_slice_matches_zllm(gguf, zllm_f32, kv_dtype, tol):
    zlog, ztoks = zllm_f32
    tlog, ttoks = _port_run(gguf, kv_dtype)
    assert len(tlog) == len(zlog) == N_DECODE + 1
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (SMALL_LLAMA["vocab_size"],)
        assert nmse(a, b) < tol, f"step {step}: nmse {nmse(a, b)}"
    assert ttoks == ztoks


def test_generate_counts_no_kernel_launch_on_cpu(gguf):
    from zllm_torch.models.loader import Model
    from zllm_torch.ops import attention, qmatmul
    from zllm_torch.runtime.generate import Generator

    kernels = (qmatmul.q4k_matvec, qmatmul.q4k_gemm, attention.attn_decode_qkv,
               attention.flash_attention)
    before = [k.launches for k in kernels]
    m = Model.load(gguf, device="cpu", dtype=torch.bfloat16)
    gen = Generator(m, max_len=64, prefill_chunk=16)
    res = gen.generate(PROMPT, max_new=3)
    assert len(res.tokens) == 3 and res.text == m.tokenizer.decode(res.tokens)
    gen.reset()  # prefill + decode_steps is the same greedy loop
    gen.prefill(PROMPT)
    assert gen.decode_steps(res.tokens[0], 2) == res.tokens
    assert [k.launches for k in kernels] == before


def test_prefill_chunk_over_max_len_is_a_typed_error(gguf):
    """The port refuses the shape up front; zllm's Generator accepts it and
    then crashes inside jit (a known quirk of the reference, kept as is)."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.runtime.generate import Generator as ZGenerator
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    m = Model.load(gguf, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="prefill_chunk=256 exceeds max_len=64"):
        Generator(m, max_len=64)
    zgen = ZGenerator(ZModel.load(gguf, dtype=jnp.float32), max_len=64)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        zgen.prefill(PROMPT)


@pytest.mark.parametrize("start", [0, 21, 60])
def test_kvcache_update_matches_zllm(start):
    """The in-place insert at positions[:, 0] writes what zllm's functional
    update writes, including the clamp of a run past the end (start 60 with
    16 rows in 64 slots lands at 48: the trash-row convention)."""
    import jax.numpy as jnp

    from zllm.runtime.kvcache import KVCache as ZKVCache
    from zllm_torch.runtime.kvcache import KVCache

    rng = np.random.default_rng(start)
    k_new, v_new = (rng.standard_normal((1, 16, 2, 8)).astype(np.float32) for _ in range(2))
    zkv = ZKVCache.create(1, 1, 64, 2, 8, jnp.float32)
    positions = np.arange(start, start + 16, dtype=np.int32)[None]
    zkv = zkv.update(0, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(positions))
    kv = KVCache.create(1, 1, 64, 2, 8, torch.float32, "cpu")
    kv.update(0, torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(positions))
    np.testing.assert_array_equal(to_np(kv.k[0]), to_np(zkv.k[0]))
    np.testing.assert_array_equal(to_np(kv.v[0]), to_np(zkv.v[0]))


def test_multi_token_step_with_cache_needs_its_start(gguf):
    """A multi-token step takes each row's start from its positions on the
    device (no host start): row 0's run lands at slots 0-3, row 1's at
    10-13, and no other slot is written."""
    from zllm_torch.models.llama import forward
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.kvcache import KVCache

    m = Model.load(gguf, device="cpu", dtype=torch.float32)
    cfg = m.cfg
    kv = KVCache.create(cfg.n_layers, 2, 64, cfg.n_kv_heads, cfg.head_dim, torch.float32, "cpu")
    tok = torch.tensor([PROMPT[:4], PROMPT[4:8]], dtype=torch.int32)
    pos = torch.tensor([[0], [10]], dtype=torch.int32) + torch.arange(4, dtype=torch.int32)
    assert forward(m.params, cfg, tok, pos, kv).shape == (2, 4, cfg.vocab_size)
    written = kv.k[0].abs().sum(dim=(1, 3)) > 0  # [B, S]
    assert written[0].nonzero().flatten().tolist() == [0, 1, 2, 3]
    assert written[1].nonzero().flatten().tolist() == [10, 11, 12, 13]


def test_cuda_load_without_gpu_raises(gguf, monkeypatch):
    """Asking for the GPU where none is visible is an error, never a
    silent move to the CPU."""
    from zllm_torch.models.loader import Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        Model.load(gguf)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        Model.load(gguf, device="cuda")
