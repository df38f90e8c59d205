"""The port's multi-model router (zllm_torch.server.router) on the CPU:
tests/test_router.py's cases (listing, forwarding by model, LRU eviction,
an unknown model, the Anthropic routes through it, replica round robin),
an evicted model's memory released, `python -m zllm_torch.server
--models-dir`, and the same greedy text as zllm's router on the same files."""

import gc
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
import weakref

import pytest

from zllm.gguf.constants import GGMLType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=256, vocab_size=260,
             gtype=GGMLType.Q8_0, with_tokenizer=True)


def _post(port, path, body, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    from zllm.testing import make_llama_gguf

    d = tmp_path_factory.mktemp("models")
    for name, seed in (("alpha.gguf", 0), ("beta.gguf", 7)):
        make_llama_gguf(str(d / name), **SHAPE, seed=seed)
    (d / "notes.txt").write_text("not a model")
    return d


@pytest.fixture(scope="module")
def router(models_dir):
    from zllm_torch.server.router import RouterServer

    r = RouterServer(str(models_dir), port=0, models_max=1, n_slots=1, max_len=512, device="cpu")
    r.start_background()
    yield r
    r.shutdown()


CHAT = {"max_tokens": 4, "temperature": 0, "messages": [{"role": "user", "content": "hi"}]}


def test_router_lists_models(router):
    out = _get(router.port, "/v1/models")
    assert [m["id"] for m in out["data"]] == ["alpha.gguf", "beta.gguf"]
    assert _get(router.port, "/health")["status"] == "ok"


def test_router_forwards_by_model(router):
    out = _post(router.port, "/v1/chat/completions", dict(CHAT, model="alpha.gguf"))
    assert out["choices"][0]["finish_reason"] in ("length", "stop")
    assert list(router.instances) == ["alpha.gguf"]
    states = {m["id"]: m["state"] for m in _get(router.port, "/models")["data"]}
    assert states == {"alpha.gguf": "loaded", "beta.gguf": "available"}


def test_router_lru_eviction_releases_the_model(router):
    """models_max=1: loading beta evicts alpha, and nothing keeps alpha's
    model alive (on the card: its memory comes back)."""
    alpha = router.load("alpha.gguf")
    ref = weakref.ref(alpha.servers[0].model)
    engine = weakref.ref(alpha.servers[0].engine)
    del alpha
    _post(router.port, "/v1/chat/completions", dict(CHAT, model="beta.gguf"))
    assert list(router.instances) == ["beta.gguf"]
    gc.collect()
    assert ref() is None and engine() is None


def test_router_unknown_model(router):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(router.port, "/v1/chat/completions",
              {"model": "nope.gguf", "max_tokens": 2, "messages": []})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(router.port, "/models/load", {"model": "nope.gguf"})
    assert e.value.code == 404


def test_router_evicts_no_model_with_a_request_in_flight(models_dir):
    """models_max=1 and two clients at once, alternating between the two
    models in opposite order: a load waits until the other model is idle,
    so no model is evicted while a request to it is in flight and every
    request is answered."""
    import threading

    from zllm_torch.server.router import RouterServer

    r = RouterServer(str(models_dir), port=0, models_max=1, n_slots=1, max_len=256, device="cpu")
    busy = []  # in_flight of each model as it is evicted
    unload = r._unload

    def checked_unload(name):
        busy.append(r.instances[name].in_flight if name in r.instances else 0)
        unload(name)

    r._unload = checked_unload
    r.start_background()
    outs, errors = [], []

    def client(order):
        for _ in range(3):
            for name in order:
                try:
                    outs.append(_post(r.port, "/v1/completions", {
                        "model": name, "prompt": "ab", "max_tokens": 4, "temperature": 0}))
                except Exception as e:  # a dropped connection or an error reply
                    errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(order,))
               for order in (("alpha.gguf", "beta.gguf"), ("beta.gguf", "alpha.gguf"))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        evictions = list(busy)
    finally:
        r.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(outs) == 12
    assert all(o["choices"][0]["finish_reason"] in ("length", "stop") for o in outs)
    assert len(evictions) >= 2 and not any(evictions)


def test_router_needs_a_model_name_when_several_could_serve(router):
    router.unload("alpha.gguf")
    router.unload("beta.gguf")
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(router.port, "/v1/completions", {"prompt": "ab", "max_tokens": 2})
    assert e.value.code == 400
    assert _post(router.port, "/models/load", {"model": "beta.gguf"}) == {"success": True}
    out = _post(router.port, "/v1/completions", {"prompt": "ab", "max_tokens": 2,
                                                 "temperature": 0})
    assert out["usage"]["completion_tokens"] == 2  # the one loaded model serves it
    assert _post(router.port, "/models/unload", {"model": "beta.gguf"}) == {"success": True}
    assert router.instances == {}


def test_anthropic_messages(router):
    out = _post(router.port, "/v1/messages",
                {"model": "beta.gguf", "max_tokens": 6, "temperature": 0, "system": "be terse",
                 "messages": [{"role": "user", "content": "hello"}]})
    assert out["type"] == "message" and out["role"] == "assistant"
    assert out["content"][0]["type"] == "text"
    assert out["stop_reason"] in ("end_turn", "max_tokens")
    assert out["usage"]["output_tokens"] == 6


def test_anthropic_count_tokens(router):
    out = _post(router.port, "/v1/messages/count_tokens",
                {"model": "beta.gguf", "messages": [{"role": "user", "content": "hello world"}]})
    assert out["input_tokens"] > 2


def test_anthropic_streaming(router):
    body = json.dumps({"model": "beta.gguf", "max_tokens": 5, "temperature": 0, "stream": True,
                       "messages": [{"role": "user", "content": "go"}]}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{router.port}/v1/messages", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        raw = resp.read().decode()
    events = [ln.split(": ", 1)[1] for ln in raw.splitlines() if ln.startswith("event: ")]
    assert events[0] == "message_start"
    assert "content_block_delta" in events
    assert events[-1] == "message_stop"


def test_replica_round_robin(tmp_path):
    """replicas=2: one model served by two engines over one loaded copy,
    requests alternating between them."""
    from zllm.testing import make_llama_gguf
    from zllm_torch.server.router import RouterServer

    make_llama_gguf(str(tmp_path / "m.gguf"), **SHAPE)
    r = RouterServer(str(tmp_path), port=0, models_max=1, n_slots=1, max_len=128, replicas=2,
                     device="cpu")
    r.start_background()
    try:
        name = r.available()[0]
        inst = r.load(name)
        assert len(inst.servers) == 2 and inst.servers[0].model is inst.servers[1].model
        assert inst.servers[0].engine is not inst.servers[1].engine
        assert len({inst.pick().port for _ in range(4)}) == 2
        before = [s.engine.metrics["requests_total"] for s in inst.servers]
        for _ in range(2):
            out = _post(r.port, "/v1/completions", {"model": name, "prompt": "ab",
                                                    "max_tokens": 2, "temperature": 0})
            assert out["choices"][0]["finish_reason"] == "length"
        assert [s.engine.metrics["requests_total"] - b
                for s, b in zip(inst.servers, before)] == [1, 1]
    finally:
        r.shutdown()


def test_same_greedy_text_as_zllms_router(tmp_path):
    """Both routers over the same two F32 files (f32 activations, as zllm's
    loads them; tests/test_torch_server.py's geometry) answer a greedy chat
    and a completion with the same text."""
    from zllm.server.router import RouterServer as ZRouter
    from zllm.testing import make_llama_gguf
    from zllm_torch.server.router import RouterServer

    for name, seed in (("alpha.gguf", 0), ("beta.gguf", 7)):
        make_llama_gguf(str(tmp_path / name), **dict(SHAPE, n_embd=64, n_ff=128,
                                                     gtype=GGMLType.F32), seed=seed)
    models_dir = tmp_path

    bodies = [("/v1/chat/completions", dict(CHAT, model="alpha.gguf", max_tokens=6)),
              ("/v1/completions", {"model": "beta.gguf", "prompt": "the cat", "max_tokens": 6,
                                   "temperature": 0})]
    outs = {}
    for side, cls, kw in (("port", RouterServer, {"device": "cpu"}), ("zllm", ZRouter, {})):
        r = cls(str(models_dir), port=0, models_max=1, n_slots=1, max_len=256, **kw)
        r.start_background()
        try:
            outs[side] = [_post(r.port, path, body) for path, body in bodies]
        finally:
            r.shutdown()
    for got, want in zip(outs["port"], outs["zllm"]):
        assert got["choices"][0] == want["choices"][0] and got["usage"] == want["usage"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the server's own start-up allowance: the import of torch and the
# router's first listing run beside the suite's other workers
STARTUP_S = 300


def _start_server(models_dir, log):
    """`python -m zllm_torch.server --models-dir` on a free port, its stderr
    written to `log` (a pipe nobody reads fills and stalls the server).
    Returns (process, port, the listed model ids); a start that loses its
    port to another process between the probe and the bind is tried again
    on a new one."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for _ in range(3):
        port = _free_port()
        with open(log, "wb") as err:
            proc = subprocess.Popen([sys.executable, "-m", "zllm_torch.server", "--models-dir",
                                     str(models_dir), "--models-max", "1", "--replicas", "2",
                                     "--device", "cpu", "--port", str(port), "--slots", "1",
                                     "--ctx", "256"], cwd=REPO, env=env,
                                    stdout=subprocess.DEVNULL, stderr=err)
        deadline = time.time() + STARTUP_S
        while proc.poll() is None:
            try:
                return proc, port, [m["id"] for m in _get(port, "/v1/models")["data"]]
            except OSError:
                if time.time() > deadline:
                    proc.terminate()
                    proc.wait(timeout=30)
                    pytest.fail(f"router did not come up in {STARTUP_S} s: "
                                f"{log.read_text()[-2000:]}")
                time.sleep(0.2)
        if "address already in use" not in log.read_text().lower():
            break
    pytest.fail(f"the server exited with {proc.returncode}: {log.read_text()[-2000:]}")


def test_python_m_server_models_dir(models_dir, tmp_path):
    """`python -m zllm_torch.server --models-dir DIR --device cpu` runs the
    router."""
    proc, port, ids = _start_server(models_dir, tmp_path / "server.err")
    try:
        assert ids == ["alpha.gguf", "beta.gguf"]
        out = _post(port, "/v1/completions", {"model": "alpha.gguf", "prompt": "ab",
                                              "max_tokens": 3, "temperature": 0})
        assert out["usage"]["completion_tokens"] >= 1
    finally:
        proc.terminate()
        proc.wait(timeout=30)
