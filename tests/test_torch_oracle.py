"""Shared fixtures for the zllm_torch parity tests (holds no tests).

The JAX package `zllm` is the oracle: the same inputs, made with numpy
from a seed, go through a `zllm` function and its `zllm_torch`
counterpart, and the outputs are compared with a stated tolerance.  Data
crosses between the frameworks as numpy arrays only.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from zllm.gguf.constants import GGMLType

# keep -n 6 xdist workers from oversubscribing the cores
torch.set_num_threads(2)

# the slice test's model: small widths, Q4_K everywhere, byte-level SPM vocab
SMALL_LLAMA = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512,
                   vocab_size=512, gtype=GGMLType.Q4_K)


def nmse(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.mean((a - b) ** 2) / (np.mean(b ** 2) + 1e-30))


def to_np(x) -> np.ndarray:
    """A jax array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def quant_qtensor(fmt: GGMLType, n: int, k: int, seed: int):
    """A zllm QTensor of format `fmt` (repacked from random weights) and its
    raw GGUF rows [N, row_bytes]."""
    from zllm.quant import blocks as qb
    from zllm.quant import repack as rp

    rng = np.random.default_rng(seed)
    raw = qb.quantize(rng.standard_normal((n, k)).astype(np.float32) * 0.5, fmt)
    return rp.repack(raw, (n, k), fmt), raw


def nibble_qtensor(fmt: GGMLType, n: int, k: int, seed: int, npack: bool = True):
    """A zllm QTensor of a nibble format (Q4_K, Q4_0, Q4_1; repack, then
    optionally to_npack, as zllm's loader does for N % 256 == 0) and its raw
    GGUF rows [N, row_bytes]."""
    from zllm.quant import repack as rp

    qt, raw = quant_qtensor(fmt, n, k, seed)
    if npack:
        qt = rp.to_npack(qt)
        assert qt.npack, "to_npack needs N % 256 == 0"
    return qt, raw


def q4k_qtensor(n: int, k: int, seed: int, npack: bool = True):
    """A zllm Q4_K QTensor (see nibble_qtensor) and its raw GGUF rows."""
    return nibble_qtensor(GGMLType.Q4_K, n, k, seed, npack)


def f16_llama_gguf(path: str, seed: int = 0) -> str:
    """SMALL_LLAMA's geometry written in F16 by zllm's factory: the input
    the quantizers take."""
    from zllm.testing import make_llama_gguf

    shape = {k: v for k, v in SMALL_LLAMA.items() if k != "gtype"}
    return make_llama_gguf(path, **shape, gtype=GGMLType.F16, seed=seed, with_tokenizer=True)


def zllm_quantized_gguf(folder, ftype: str) -> str:
    """An F16 SMALL_LLAMA file requantized to `ftype` by zllm's
    tools/quantize.py (Q4_K_M: attn_v, ffn_down of layer 0 and the head
    Q6_K, the rest Q4_K)."""
    from tools.quantize import quantize_file

    src = f16_llama_gguf(str(folder / "f16.gguf"))
    out = str(folder / f"{ftype}.gguf")
    quantize_file(src, out, ftype, quiet=True)
    return out


def qtensor_numpy(qt) -> dict:
    """zllm QTensor -> the plain description params_from_jax takes."""
    return {"fmt": int(qt.fmt), "shape": tuple(qt.shape), "fold": qt.fold,
            "npack": bool(qt.npack),
            "planes": {name: np.asarray(p) for name, p in qt.planes.items()}}


def qtensore_numpy(qt) -> dict:
    """zllm QTensorE (an expert stack) -> its description: shape (E, K, N),
    planes with a leading E axis."""
    return {"fmt": int(qt.fmt), "shape": tuple(qt.shape), "fold": qt.fold, "npack": False,
            "planes": {name: np.asarray(p) for name, p in qt.planes.items()}}


def jax_params_numpy(params: dict) -> dict:
    """zllm's loaded params tree with numpy leaves (QTensors and QTensorEs
    described)."""
    from zllm.quant.repack import QTensor, QTensorE

    def leaf(v):
        if isinstance(v, QTensorE):
            return qtensore_numpy(v)
        return qtensor_numpy(v) if isinstance(v, QTensor) else to_np(v)

    out = {key: leaf(v) for key, v in params.items() if key != "layers"}
    out["layers"] = [{key: leaf(v) for key, v in layer.items()} for layer in params["layers"]]
    return out


def run_waves(engine, make_request, waves, counters, timeout: float = 300.0):
    """Start `engine`, run `waves` (lists of request keywords) in order,
    each submitted from the engine thread between two steps so that two
    engines admit it at the same step, then stop it.  Returns
    ([(out_tokens, finish_reason, error)] of every request, {counter:
    delta})."""
    engine.start()
    try:
        before, got = dict(engine.metrics), []
        for wave in waves:
            reqs = engine.run_in_loop(lambda wave=wave: [engine.submit(make_request(**kw))
                                                         for kw in wave])
            deadline = time.time() + timeout
            while not all(q.done for q in reqs):
                assert time.time() < deadline, "engine timed out"
                time.sleep(0.005)
            got += [(list(q.out_tokens), q.finish_reason, q.error) for q in reqs]
        return got, {k: engine.metrics[k] - before[k] for k in counters}
    finally:
        engine.stop()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, path: str, body: dict | None = None) -> str:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read().decode()


def serve_and_read_metrics(args: list[str], env: dict, prompt: str) -> dict:
    """Start `python -m zllm_torch.server ARGS --device cpu`, send one
    greedy completion, return its /metrics counters."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "zllm_torch.server", *args, "--device", "cpu",
                             "--port", str(port), "--slots", "2", "--ctx", "256"], cwd=repo,
                            env=dict(os.environ, PYTHONPATH=repo, **env),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 90
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()
            try:
                if json.loads(_http(port, "/health"))["status"] == "ok":
                    break
            except OSError:
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.2)
        out = json.loads(_http(port, "/v1/completions",
                               {"prompt": prompt, "max_tokens": 24, "temperature": 0}))
        assert out["usage"]["completion_tokens"] >= 1
        return {ln.split()[0][5:]: float(ln.split()[1])
                for ln in _http(port, "/metrics").splitlines()
                if ln.startswith("zllm_") and "{" not in ln and len(ln.split()) == 2}
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def gemma_hf_state(cfg: dict, seed: int) -> dict:
    """A seeded HF-style Gemma-2/3 state dict (numpy f32) for `cfg`."""
    rng = np.random.default_rng(seed)
    e, v, f = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]
    hq, hkv, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]

    def w(*shape, s=0.08):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(v, e, s=0.3), "model.norm.weight": w(e, s=0.1)}
    for il in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{il}."
        sd.update({p + "input_layernorm.weight": w(e, s=0.1),
                   p + "self_attn.q_proj.weight": w(hq * d, e),
                   p + "self_attn.k_proj.weight": w(hkv * d, e),
                   p + "self_attn.v_proj.weight": w(hkv * d, e),
                   p + "self_attn.o_proj.weight": w(e, hq * d),
                   p + "post_attention_layernorm.weight": w(e, s=0.1),
                   p + "pre_feedforward_layernorm.weight": w(e, s=0.1),
                   p + "post_feedforward_layernorm.weight": w(e, s=0.1),
                   p + "mlp.gate_proj.weight": w(f, e),
                   p + "mlp.up_proj.weight": w(f, e),
                   p + "mlp.down_proj.weight": w(e, f)})
        if "rope_local_base_freq" in cfg:  # gemma3: per-head q/k norms
            sd[p + "self_attn.q_norm.weight"] = w(d, s=0.1)
            sd[p + "self_attn.k_norm.weight"] = w(d, s=0.1)
    return sd


def gemma_tokenizer_kv(vocab: int) -> dict:
    """A byte-level SPM vocab (the factory's) as GGUF keys."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    tokens += [f"<extra{i}>" for i in range(vocab - len(tokens))]
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.pre": "default",
            "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.scores": [0.0] * vocab,
            "tokenizer.ggml.token_type": [2, 3, 3] + [6] * 256 + [1] * (vocab - 259),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.unknown_token_id": 0, "tokenizer.ggml.add_bos_token": True,
            "tokenizer.ggml.add_space_prefix": False}
