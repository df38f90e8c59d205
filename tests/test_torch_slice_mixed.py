"""The slice on the files users download: a Q4_K_M llama GGUF (zllm's
tools/quantize.py from an F16 synthetic model: attn_v, layer 0's ffn_down
and the head Q6_K, the rest Q4_K) and a Q8_0 one (zllm's factory), through
zllm_torch's Generator against zllm's, prefill in two chunks then greedy
decode.

zllm runs f32 with its Pallas kernels installed in interpret mode
(qmatmul.install(interpret=True)): K1/K3 for its npack Q4_K weights, K4 for
every other decode matvec and K5 for every other prefill matmul.

With f32 caches on both sides the logits agree within nmse < 2e-4, the
bound of tests/test_torch_slice.py (measured up to 7.4e-5 here), and the
greedy tokens are identical.  The port's default bf16 cache is held
against the same zllm run with zllm's tokens fed to both (teacher forcing)
within nmse < 1e-3, as in that test (measured up to 2.4e-4): on these
random weights two logits can lie closer than the bf16 cache's rounding,
and then a free-running greedy loop may pick the other one (the Q4_K_M
file does at its second decode step, where the top two f32 logits lie
1.5e-3 apart)."""

import numpy as np
import pytest
import torch
from test_torch_oracle import SMALL_LLAMA, nmse, to_np, zllm_quantized_gguf

from zllm.gguf.constants import GGMLType

PROMPT = [1] + list(range(40, 59))  # 20 tokens: two 16-token prefill chunks
N_DECODE = 8


@pytest.fixture(scope="module", params=["Q4_K_M", "Q8_0"])
def gguf(request, tmp_path_factory):
    folder = tmp_path_factory.mktemp(request.param)
    if request.param == "Q4_K_M":
        return zllm_quantized_gguf(folder, "Q4_K_M")
    from zllm.testing import make_llama_gguf

    return make_llama_gguf(str(folder / "q8.gguf"), **dict(SMALL_LLAMA, gtype=GGMLType.Q8_0),
                           with_tokenizer=True)


@pytest.fixture(scope="module")
def zllm_f32(gguf):
    import jax.numpy as jnp

    from zllm.models.loader import Model
    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.runtime.generate import Generator

    m = Model.load(gguf, dtype=jnp.float32)
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


def _port_run(path, kv_dtype, feed=None):
    """Logits of prefill + N_DECODE steps; greedy, or fed `feed`'s tokens."""
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    m = Model.load(path, device="cpu", dtype=torch.float32)
    gen = Generator(m, max_len=256, prefill_chunk=16, kv_dtype=kv_dtype)
    logits = [to_np(gen.prefill(PROMPT))]
    toks = [int(np.argmax(logits[0]))]
    for i in range(N_DECODE):
        logits.append(to_np(gen._decode_one(toks[-1] if feed is None else feed[i],
                                            len(PROMPT) + i)))
        toks.append(int(np.argmax(logits[-1])))
    return logits, toks


def test_slice_matches_zllm_f32cache(gguf, zllm_f32):
    zlog, ztoks = zllm_f32
    tlog, ttoks = _port_run(gguf, torch.float32)
    assert len(tlog) == len(zlog) == N_DECODE + 1
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (SMALL_LLAMA["vocab_size"],)
        assert nmse(a, b) < 2e-4, f"step {step}: nmse {nmse(a, b)}"
    assert ttoks == ztoks


def test_slice_matches_zllm_bf16cache(gguf, zllm_f32):
    zlog, ztoks = zllm_f32
    tlog, _ = _port_run(gguf, torch.bfloat16, feed=ztoks)
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert nmse(a, b) < 1e-3, f"step {step}: nmse {nmse(a, b)}"


def test_format_routing_and_no_launch_on_cpu(gguf, monkeypatch):
    """Each matmul goes to its format's kernel (counted at the plain
    versions the CPU runs): per decode step K1 takes 2 x (wq, wk, wo,
    gate|up) + the Q4_K ffn_down and K4 2 wv + the Q6_K ffn_down + the head
    (Q4_K_M: 9 and 4); a Q8_0 file sends all 9 matvecs (2 x (wqkv, wo,
    gate|up, down) + head) to K4.  A prefill chunk's GEMMs split the same
    way between K3 and K5.  No kernel launches."""
    from zllm_torch.models.loader import Model
    from zllm_torch.ops import attention
    from zllm_torch.ops import qmatmul as tq
    from zllm_torch.runtime.generate import Generator

    calls = {}
    for name in ("q4k_matvec_plain", "int8_matvec_plain", "dequant_gemm_plain"):
        fn = getattr(tq, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            key = _name
            if _name == "dequant_gemm_plain":  # K3 and K5 share their plain version
                key = "K3" if a[1].fmt == GGMLType.Q4_K else "K5"
            calls[key] = calls.get(key, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tq, name, counted)
    kernels = (tq.q4k_matvec, tq.int8_matvec, tq.q4k_gemm, tq.dequant_gemm,
               attention.attn_decode_qkv, attention.flash_attention)
    before = [k.launches for k in kernels]
    m = Model.load(gguf, device="cpu", dtype=torch.bfloat16)
    gen = Generator(m, max_len=64, prefill_chunk=32)
    gen.prefill(PROMPT)
    prefill_calls, calls = dict(calls), {}
    gen.decode_steps(5, 1)
    q4km = "wv" in m.params["layers"][0]
    assert calls == ({"q4k_matvec_plain": 9, "int8_matvec_plain": 4} if q4km
                     else {"int8_matvec_plain": 9})
    assert prefill_calls == ({"K3": 9, "K5": 4} if q4km else {"K5": 9})
    assert [k.launches for k in kernels] == before
