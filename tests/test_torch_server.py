"""The port's HTTP server (zllm_torch.server) on a tiny model, over real
HTTP: the cases of tests/test_server.py that the port serves (among them
/slots save/erase/restore, /infill, /v1/messages and tool calls), the
routes it does not serve yet (501), the same greedy bodies giving the same
text as zllm's server on the same file, and `python -m zllm_torch.server`.

Both servers load one F32 llama file (n_embd 64, vocab 256) in f32 with the
byte-level tokenizer tests/test_server.py attaches; each keeps its default
bf16 KV cache.  Greedy text is compared exactly: at this size the bf16
cache rounding on either side moves the logits far less than the gaps
between the random model's top logits."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from zllm.gguf.constants import GGMLType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vocab(Vocab, TokenType):
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(253)]
    types = [int(TokenType.UNKNOWN), int(TokenType.CONTROL), int(TokenType.CONTROL)] + [
        int(TokenType.BYTE)] * 253
    return Vocab(model="llama", pre="default", tokens=tokens, scores=[0.0] * 256, types=types,
                 bos_id=1, eos_id=2, unk_id=0, add_bos=True, add_space_prefix=False)


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    path = str(tmp_path_factory.mktemp("srv") / "srv.gguf")
    return make_llama_gguf(path, n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128,
                           vocab_size=256, gtype=GGMLType.F32)


@pytest.fixture(scope="module")
def served(gguf):
    from zllm_torch.models.loader import Model
    from zllm_torch.server import ZllmServer
    from zllm_torch.tokenizer import Tokenizer
    from zllm_torch.tokenizer.vocab import TokenType, Vocab

    m = Model.load(gguf, device="cpu", dtype=torch.float32)
    m.tokenizer = Tokenizer(_vocab(Vocab, TokenType))
    srv = ZllmServer(m, n_slots=2, max_len=256, port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def served_tools(served):
    """The same model with the context a tool preamble needs (~800 byte
    tokens on this vocab), one slot."""
    from zllm_torch.server import ZllmServer

    srv = ZllmServer(served.model, n_slots=1, max_len=1536, port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def zllm_served_tools(zllm_served):
    from zllm.server import ZllmServer

    srv = ZllmServer(zllm_served.model, n_slots=1, max_len=1536, port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def zllm_served(gguf):
    import jax.numpy as jnp

    from zllm.models.loader import Model
    from zllm.server import ZllmServer
    from zllm.tokenizer import Tokenizer
    from zllm.tokenizer.vocab import TokenType, Vocab

    m = Model.load(gguf, dtype=jnp.float32)
    m.tokenizer = Tokenizer(_vocab(Vocab, TokenType))
    srv = ZllmServer(m, n_slots=2, max_len=256, port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


def _post(srv, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=30) as r:
        return r.read().decode()


def _stream(srv, path, body) -> list:
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return [ln[6:] for ln in r.read().decode().splitlines() if ln.startswith("data: ")]


def _streamed_text(events) -> str:
    out = []
    for e in events[:-1]:
        c = json.loads(e)["choices"][0]
        out.append(c.get("text") or (c.get("delta") or {}).get("content") or "")
    return "".join(out)


def test_health_models_props(served):
    assert json.loads(_get(served, "/health"))["status"] == "ok"
    assert json.loads(_get(served, "/v1/models"))["data"][0]["object"] == "model"
    props = json.loads(_get(served, "/props"))
    assert props["n_ctx"] == 256 and props["n_slots"] == 2 and props["arch"] == "llama"


def test_completion(served):
    out = _post(served, "/v1/completions", {"prompt": "ab", "max_tokens": 8, "temperature": 0})
    assert out["object"] == "text_completion"
    assert out["usage"]["completion_tokens"] >= 1
    assert out["choices"][0]["finish_reason"] in ("length", "stop")


def test_chat_completion(served):
    out = _post(served, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4, "temperature": 0})
    assert out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["role"] == "assistant"


def test_concurrent_requests_consistent(served):
    """Concurrent greedy requests match sequential ones (continuous
    batching must not cross-contaminate slots)."""
    def run(prompt):
        return _post(served, "/completion", {"prompt": prompt, "max_tokens": 6,
                                             "temperature": 0})["choices"][0]["text"]

    seq = {p: run(p) for p in ("abcd", "xyz", "hello there")}
    results = {}
    ts = [threading.Thread(target=lambda p=p: results.__setitem__(p, run(p))) for p in seq]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert results == seq


def test_streaming(served):
    events = _stream(served, "/completions", {"prompt": "ab", "max_tokens": 4, "temperature": 0})
    assert events[-1] == "[DONE]"
    assert len(events) >= 3
    plain = _post(served, "/v1/completions", {"prompt": "ab", "max_tokens": 4, "temperature": 0})
    assert _streamed_text(events[:-1]) == plain["choices"][0]["text"]


def test_chat_streaming(served):
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 5, "temperature": 0}
    events = _stream(served, "/v1/chat/completions", body)
    assert events[-1] == "[DONE]"
    final = json.loads(events[-2])["choices"][0]
    assert final["finish_reason"] in ("length", "stop")
    plain = _post(served, "/v1/chat/completions", body)
    assert _streamed_text(events[:-1]) == plain["choices"][0]["message"]["content"]


def test_tokenize_roundtrip(served):
    out = _post(served, "/tokenize", {"content": "hi"})
    assert len(out["tokens"]) >= 2
    assert _post(served, "/detokenize", {"tokens": out["tokens"]})["content"] == "hi"


def test_metrics(served):
    text = _get(served, "/metrics")
    assert "zllm_requests_total" in text and "zllm_time_to_first_token_seconds_count" in text
    assert "zllm_engine_errors_total 0" in text


@pytest.mark.parametrize("field", ["grammar", "json_schema", "response_format"])
def test_grammar_fields(served, field):
    schema = {"enum": ["aa", "bb"]}
    body = {"prompt": "x", "max_tokens": 8, "temperature": 0.9, "seed": 7,
            "grammar": 'root ::= [a]*\n',
            "json_schema": schema,
            "response_format": {"type": "json_schema", "json_schema": {"schema": schema}}}
    body = {k: v for k, v in body.items() if k not in ("grammar", "json_schema",
                                                        "response_format") or k == field}
    text = _post(served, "/v1/completions", body)["choices"][0]["text"]
    if field == "grammar":
        assert set(text) <= {"a"}, text
    else:
        assert text in ('"aa"', '"bb"', '"a', '"b', '"'), text


def test_slots_introspection(served):
    slots = json.loads(_get(served, "/slots"))
    assert len(slots) == 2
    assert {"id", "state", "n_past", "n_cached"} <= set(slots[0])


def test_stop_strings(served):
    base = _post(served, "/v1/completions", {"prompt": "qq", "max_tokens": 10, "temperature": 0})
    text = base["choices"][0]["text"]
    assert len(text) >= 3
    stop = text[2:4]
    body = {"prompt": "qq", "max_tokens": 10, "temperature": 0, "stop": [stop]}
    out = _post(served, "/v1/completions", body)
    trimmed = out["choices"][0]["text"]
    assert stop not in trimmed and text.startswith(trimmed)
    assert out["choices"][0]["finish_reason"] == "stop"
    # the streaming path trims identically (holdback buffering)
    assert _streamed_text(_stream(served, "/v1/completions", body)[:-1]) == trimmed


def test_apply_template_endpoint(served):
    out = _post(served, "/apply-template", {"messages": [{"role": "user", "content": "hi"}]})
    assert "hi" in out["prompt"]


@pytest.mark.parametrize("path,body", [
    ("/v1/embeddings", {"input": ["ab"]}),
    ("/rerank", {"query": "ab", "documents": ["ab"]}),
], ids=["embeddings", "rerank"])
def test_unported_routes_answer_501(served, path, body):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(served, path, body)
    assert ei.value.code == 501
    assert "ROADMAP queue 1 item 4.6" in json.loads(ei.value.read())["error"]["message"]


def test_infill_unsupported_when_no_fim_tokens(served):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(served, "/infill", {"input_prefix": "a", "input_suffix": "b", "max_tokens": 2})
    assert ei.value.code == 501


class _FIM:
    """FIM ids grafted onto byte tokens of each server's vocab for the
    block, as tests/test_server.py::test_infill grafts them."""

    def __init__(self, *servers):
        self.vocabs = [s.model.tokenizer.vocab for s in servers]

    def __enter__(self):
        self.old = [(v.fim_pre_id, v.fim_suf_id, v.fim_mid_id, v.eot_id) for v in self.vocabs]
        for v in self.vocabs:
            v.fim_pre_id, v.fim_suf_id, v.fim_mid_id, v.eot_id = 10, 11, 12, 13

    def __exit__(self, *exc):
        for v, old in zip(self.vocabs, self.old):
            v.fim_pre_id, v.fim_suf_id, v.fim_mid_id, v.eot_id = old


def test_infill(served):
    with _FIM(served):
        out = _post(served, "/infill", {"input_prefix": "ab", "input_suffix": "cd",
                                        "max_tokens": 4, "temperature": 0})
    assert out["tokens_predicted"] >= 1 and out["stop_type"] in ("length", "stop")


TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Get the weather",
    # enum-bounded so even a random-weights model must finish its call
    "parameters": {"type": "object", "properties": {"city": {"enum": ["Oslo", "Bergen"]}},
                   "required": ["city"]}}}]
MESSAGES = {"system": "be terse", "max_tokens": 6, "temperature": 0,
            "messages": [{"role": "user", "content": [{"type": "text", "text": "hello"},
                                                      {"type": "text", "text": " there"}]}]}


def _view(path: str, out: dict) -> dict:
    """What two servers' replies must share: the first choice and usage
    with the tool calls' ids (request ids) dropped; a message without its
    id; /infill whole."""
    if path == "/v1/messages":
        return {k: v for k, v in out.items() if k != "id"}
    if path == "/infill":
        return out
    choice = json.loads(json.dumps(out["choices"][0]))
    for call in (choice.get("message") or {}).get("tool_calls") or []:
        call.pop("id")
    return {"choice": choice, "usage": out["usage"]}


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "abcd", "max_tokens": 8, "temperature": 0}),
    ("/v1/completions", {"prompt": "the cat", "max_tokens": 12, "temperature": 0,
                         "repeat_penalty": 1.3}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                              "max_tokens": 6, "temperature": 0}),
    ("/v1/messages", MESSAGES),
    ("/infill", {"input_prefix": "ab", "input_suffix": "cd", "max_tokens": 6,
                 "temperature": 0}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "weather in Oslo?"}],
                              "tools": TOOLS, "tool_choice": "required", "max_tokens": 160,
                              "temperature": 0}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "weather?"}],
                              "tools": TOOLS, "max_tokens": 12, "temperature": 0}),
], ids=["completion", "penalties", "chat", "messages", "infill",
        "tool_call_forced", "tools_auto"])
def test_same_greedy_text_as_zllm(served, zllm_served, request, path, body):
    if "tools" in body:  # the tool preamble needs the larger context
        served = request.getfixturevalue("served_tools")
        zllm_served = request.getfixturevalue("zllm_served_tools")
    with _FIM(served, zllm_served):
        got, want = _post(served, path, body), _post(zllm_served, path, body)
    assert _view(path, got) == _view(path, want)
    if body.get("tool_choice") == "required":
        msg = got["choices"][0]["message"]
        assert got["choices"][0]["finish_reason"] == "tool_calls"
        assert msg["tool_calls"][0]["function"]["name"] == "get_weather"
        assert json.loads(msg["tool_calls"][0]["function"]["arguments"])["city"] in (
            "Oslo", "Bergen")


def _sse_events(srv, path, body) -> list:
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read().decode().splitlines()


def test_messages_streaming_as_zllm(served, zllm_served):
    """The SSE events message_start ... message_stop, the same text deltas
    and stop reason as zllm's, and the text of the non-streamed reply."""
    def events(srv):
        out = []
        for ln in _sse_events(srv, "/v1/messages", MESSAGES):
            if ln.startswith("data: "):
                ev = json.loads(ln[6:])
                ev.get("message", {}).pop("id", None)
                out.append(ev)
        return out

    got, want = events(served), events(zllm_served)
    assert got == want
    assert [e["type"] for e in got][:2] == ["message_start", "content_block_start"]
    assert [e["type"] for e in got][-3:] == ["content_block_stop", "message_delta",
                                             "message_stop"]
    text = "".join(e["delta"]["text"] for e in got if e["type"] == "content_block_delta")
    assert text == _post(served, "/v1/messages", MESSAGES)["content"][0]["text"]


def test_messages_stop_sequence_as_zllm(served, zllm_served):
    """A stop sequence inside the greedy text: cut there, stop_reason
    stop_sequence, as zllm answers."""
    text = _post(served, "/v1/messages", dict(MESSAGES, max_tokens=8))["content"][0]["text"]
    assert len(text) >= 3
    body = dict(MESSAGES, max_tokens=8, stop_sequences=[text[1:3]])
    got, want = _post(served, "/v1/messages", body), _post(zllm_served, "/v1/messages", body)
    assert _view("/v1/messages", got) == _view("/v1/messages", want)
    assert got["stop_reason"] == "stop_sequence" and got["content"][0]["text"] == text[:1]


def test_count_tokens_equals_prompt_tokens(served, zllm_served):
    body = {"messages": MESSAGES["messages"], "system": "be terse"}
    n = _post(served, "/v1/messages/count_tokens", body)["input_tokens"]
    assert n == _post(zllm_served, "/v1/messages/count_tokens", body)["input_tokens"]
    assert n == _post(served, "/v1/messages", MESSAGES)["usage"]["input_tokens"]


def test_tool_call_streamed_as_zllm(served_tools, zllm_served_tools):
    """A forced tool call streamed: <tool_call> held back, one tool_calls
    delta, finish_reason tool_calls; the same call as zllm's stream and as
    the port's own non-streamed reply."""
    body = {"messages": [{"role": "user", "content": "weather?"}], "tools": TOOLS,
            "tool_choice": {"type": "function", "function": {"name": "get_weather"}},
            "max_tokens": 160, "temperature": 0}

    def streamed(srv):
        deltas, finish = [], None
        for ln in _sse_events(srv, "/v1/chat/completions", body):
            if not ln.startswith("data: ") or ln == "data: [DONE]":
                continue
            c = json.loads(ln[6:])["choices"][0]
            deltas.append(c["delta"])
            finish = c["finish_reason"] or finish
        calls = [call for d in deltas if d and "tool_calls" in d for call in d["tool_calls"]]
        for call in calls:
            call.pop("id")
        content = "".join(d.get("content") or "" for d in deltas if d)
        return calls, content, finish

    calls, content, finish = streamed(served_tools)
    assert (calls, content, finish) == streamed(zllm_served_tools)
    assert finish == "tool_calls" and "<tool_call>" not in content
    plain = _post(served_tools, "/v1/chat/completions", body)["choices"][0]["message"]
    want = [dict(c, index=i) for i, c in enumerate(plain["tool_calls"])]
    for call in want:
        call.pop("id")
    assert calls == want


def test_slot_save_erase_restore_continue(served, tmp_path):
    """A slot saved, erased and restored into the other slot with its
    tokens: the same prompt again reuses the restored pages and continues
    with the tokens of the uninterrupted run."""
    from zllm_torch.server import ZllmServer

    srv = ZllmServer(served.model, n_slots=2, max_len=256, port=0, slot_save_path=str(tmp_path))
    srv.start_background()
    try:
        prompt = "thequickbrownfoxjumpsoverthelazydog" * 4  # 141 ids: a full page and more
        body = {"prompt": prompt, "max_tokens": 10, "temperature": 0}
        first = _post(srv, "/v1/completions", body)
        tok = served.model.tokenizer
        ids = tok.encode(prompt, add_special=True, parse_special=True)
        out_ids = srv.engine.slots[0].cache_tokens[len(ids):]
        info = _post(srv, "/slots/0?action=save", {"filename": "../s0.bin"})
        assert info["n_past"] == len(ids) + 9 and (tmp_path / "s0.bin").exists()
        assert info["filename"] == str(tmp_path / "s0.bin")  # the basename, under the path
        assert _post(srv, "/slots/0?action=erase", {}) == {"id": 0}
        # slot 0 takes unrelated traffic over its pages
        _post(srv, "/v1/completions", {"prompt": "z" * 200, "max_tokens": 20, "temperature": 0})
        got = _post(srv, "/slots/1?action=restore", {"filename": "s0.bin",
                                                     "tokens": ids + out_ids})
        assert got == {"id": 1, "n_past": info["n_past"]}
        reused = srv.engine.metrics["tokens_prefix_reused_total"]
        again = _post(srv, "/v1/completions", body)
        assert srv.engine.metrics["tokens_prefix_reused_total"] - reused == 128  # a full page
        assert again["choices"][0] == first["choices"][0]
        for path, want in (("/slots/7?action=save", "invalid slot id"),
                           ("/slots/x?action=save", "invalid slot id"),
                           ("/slots/0?action=drop", "unknown action")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(srv, path, {})
            assert ei.value.code == 400 and want in ei.value.read().decode()
    finally:
        srv.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_m_server_on_cpu(tmp_path):
    """`python -m zllm_torch.server MODEL --device cpu` serves a file with
    a tokenizer."""
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "m.gguf"), n_layers=1, n_embd=256, n_heads=4,
                           n_kv_heads=2, n_ff=256, vocab_size=260, gtype=GGMLType.Q8_0,
                           with_tokenizer=True)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-m", "zllm_torch.server", path, "--device", "cpu",
                             "--port", str(port), "--slots", "2", "--ctx", "256"],
                            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        srv = type("S", (), {"port": port})
        deadline = time.time() + 90
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()
            try:
                if json.loads(_get(srv, "/health"))["status"] == "ok":
                    break
            except OSError:
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.2)
        out = _post(srv, "/v1/completions", {"prompt": "ab", "max_tokens": 3, "temperature": 0})
        assert out["usage"]["completion_tokens"] >= 1
    finally:
        proc.terminate()
        proc.wait(timeout=30)
