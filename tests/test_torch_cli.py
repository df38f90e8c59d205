"""The port's CLI on the CPU, and its independence from JAX and zllm."""

import ast
import os
import subprocess
import sys

import pytest
import torch
from test_torch_oracle import SMALL_LLAMA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_prints_generate_text(tmp_path):
    from conftest import subprocess_env

    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator
    from zllm_torch.testing import make_llama_gguf

    path = str(tmp_path / "cli.gguf")
    make_llama_gguf(path, **SMALL_LLAMA, with_tokenizer=True)
    out = subprocess.run(
        [sys.executable, "-m", "zllm_torch.cli", path, "-p", "hi", "-n", "4", "--greedy",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=subprocess_env(), cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    m = Model.load(path, device="cpu", dtype=torch.bfloat16)
    ids = m.tokenizer.encode("hi", add_special=True, parse_special=True)
    res = Generator(m, max_len=2048).generate(ids, max_new=4, eos_id=m.tokenizer.eos_id)
    assert len(res.tokens) >= 1
    assert out.stdout == res.text + "\n"
    assert "cpu: prefill" in out.stderr


def test_cli_on_a_q4km_file_made_by_the_quantize_cli(tmp_path):
    """The two entry points a user runs on a downloaded F16 file: requantize
    to Q4_K_M, then generate (Q4_K and Q6_K weights, unfused wq/wk/wv)."""
    from conftest import subprocess_env

    from zllm_torch.gguf.constants import GGMLType
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator
    from zllm_torch.testing import make_llama_gguf

    src, path = str(tmp_path / "f16.gguf"), str(tmp_path / "q4km.gguf")
    make_llama_gguf(src, **dict(SMALL_LLAMA, gtype=GGMLType.F16), with_tokenizer=True)
    for args in (["zllm_torch.quantize", src, path, "Q4_K_M"],
                 ["zllm_torch.cli", path, "-p", "hi", "-n", "4", "--greedy", "--device", "cpu"]):
        out = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                             timeout=120, env=subprocess_env(), cwd=REPO)
        assert out.returncode == 0, out.stderr
    m = Model.load(path, device="cpu", dtype=torch.bfloat16)
    assert m.params["layers"][0]["wv"].fmt == GGMLType.Q6_K
    ids = m.tokenizer.encode("hi", add_special=True, parse_special=True)
    res = Generator(m, max_len=2048).generate(ids, max_new=4, eos_id=m.tokenizer.eos_id)
    assert out.stdout == res.text + "\n"


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "zllm_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_neither_jax_nor_zllm(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    banned = {"jax", "jaxlib", "zllm"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [] if node.level else [(node.module or "").split(".")[0]]
        else:
            continue
        assert not banned.intersection(roots), f"{path}:{node.lineno} imports {roots}"
