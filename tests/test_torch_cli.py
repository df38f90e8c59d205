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


def _cli(*args):
    from conftest import subprocess_env

    out = subprocess.run([sys.executable, "-m", "zllm_torch.cli", *args, "--device", "cpu"],
                         capture_output=True, text=True, timeout=120, env=subprocess_env(),
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    return out


def test_cli_prompt_cache_and_prompt_file(tmp_path):
    """-f reads the prompt; --prompt-cache saves the session, and the next
    run with that prompt reuses all of it but the last token and prints the
    same greedy text; a short shared prefix is not reused; another model's
    session is ignored."""
    import re

    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.state import load_session
    from zllm_torch.runtime.generate import Generator
    from zllm_torch.testing import make_llama_gguf

    path = str(tmp_path / "cli.gguf")
    make_llama_gguf(path, **SMALL_LLAMA, with_tokenizer=True)
    prompt = tmp_path / "prompt.txt"
    prompt.write_text("the cat sat on the mat and looked at the dog", encoding="utf-8")
    cache = str(tmp_path / "session.bin")
    args = [path, "-f", str(prompt), "-n", "6", "--greedy", "--prompt-cache", cache]
    first, second = _cli(*args), _cli(*args)
    assert "prompt cache" not in first.stderr
    m = Model.load(path, device="cpu", dtype=torch.bfloat16)
    ids = m.tokenizer.encode(prompt.read_text(), add_special=True, parse_special=True)
    got = re.search(r"\[prompt cache: reused (\d+) tokens\]", second.stderr)
    assert got and int(got.group(1)) == len(ids) - 1 >= 16
    assert second.stdout == first.stdout
    # the saved history: the prompt and the generated tokens but the last
    gen = Generator(m, max_len=2048)
    res = gen.generate(ids, max_new=6, eos_id=m.tokenizer.eos_id)
    assert first.stdout == res.text + "\n"
    _, toks, n = load_session(cache, m, Generator(m, max_len=2048).kv)
    assert toks == ids + res.tokens[:-1] and n == len(toks)
    # a prompt sharing fewer than 16 tokens prefills everything
    short = _cli(path, "-p", "the cat", "-n", "2", "--greedy", "--prompt-cache", cache)
    assert "prompt cache" not in short.stderr
    other = str(tmp_path / "other.gguf")
    make_llama_gguf(other, **dict(SMALL_LLAMA, n_layers=1), with_tokenizer=True)
    ignored = _cli(other, "-p", "the cat", "-n", "2", "--greedy", "--prompt-cache", cache)
    assert "[prompt cache ignored:" in ignored.stderr and "n_layers" in ignored.stderr


def test_cli_reverse_prompt(tmp_path):
    """-r cuts the text at the stop string, as the Generator's stop_strings."""
    from zllm_torch.testing import make_llama_gguf

    path = str(tmp_path / "cli.gguf")
    make_llama_gguf(path, **SMALL_LLAMA, with_tokenizer=True)
    full = _cli(path, "-p", "hello", "-n", "12", "--greedy").stdout[:-1]
    assert len(full) >= 4
    stop = full[2:4]
    cut = _cli(path, "-p", "hello", "-n", "12", "--greedy", "-r", stop).stdout[:-1]
    assert cut == full[:full.find(stop)]


def test_generator_start_and_stop_strings_as_zllm(tmp_path):
    """Generator.generate(start=, stop_strings=) as zllm's: the same tokens
    and text, a stop string cutting the text, and a prefill from `start`
    over a restored session giving the full prefill's tokens."""
    import jax.numpy as jnp

    from zllm.gguf.constants import GGMLType
    from zllm.models.loader import Model as ZModel
    from zllm.runtime.generate import Generator as ZGenerator
    from zllm.testing import make_llama_gguf
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime import state
    from zllm_torch.runtime.generate import Generator

    path = make_llama_gguf(str(tmp_path / "f32.gguf"), **dict(SMALL_LLAMA, gtype=GGMLType.F32),
                           with_tokenizer=True)
    m = Model.load(path, device="cpu", dtype=torch.float32)
    zm = ZModel.load(path, dtype=jnp.float32)
    ids = m.tokenizer.encode("once upon a time there was a cat", add_special=True)

    def port(**kw):
        return Generator(m, max_len=128, prefill_chunk=32, kv_dtype=torch.float32).generate(
            ids, max_new=12, eos_id=m.tokenizer.eos_id, **kw)

    def zllm(**kw):
        return ZGenerator(zm, max_len=128, prefill_chunk=32, kv_dtype=jnp.float32).generate(
            ids, max_new=12, eos_id=zm.tokenizer.eos_id, **kw)

    full = port()
    assert (full.tokens, full.text) == (zllm().tokens, zllm().text)
    stop = full.text[3:5]
    got, want = port(stop_strings=(stop,)), zllm(stop_strings=(stop,))
    assert (got.tokens, got.text) == (want.tokens, want.text)
    assert got.text == full.text[:full.text.find(stop)] and len(got.tokens) < 12
    # start=: the session of the prompt restored, only its last token prefilled
    gen = Generator(m, max_len=128, prefill_chunk=32, kv_dtype=torch.float32)
    gen.prefill(ids)
    sess = str(tmp_path / "s.bin")
    state.save_session(sess, m, gen.kv, ids, len(ids))
    gen2 = Generator(m, max_len=128, prefill_chunk=32, kv_dtype=torch.float32)
    state.load_session(sess, m, gen2.kv)
    res = gen2.generate(ids, max_new=12, eos_id=m.tokenizer.eos_id, start=len(ids) - 1)
    assert res.tokens == full.tokens and res.n_prefill == 1


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
