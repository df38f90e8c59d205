"""Multi-model router server (counterpart of `zllm/server/router.py`).

The router discovers GGUFs in a models directory, loads them on demand
(at most `models_max` at once, least recently used evicted first), and
forwards each request to the model its body's "model" names, as a
streamed loopback HTTP proxy.  A model runs `replicas` in-process
`ZllmServer`s over one loaded copy, each with its own engine, KV cache and
slots, picked round robin.  A model with a request in flight is not
evicted: a load that needs its room waits until it is idle.

Models load as zllm's router loads them (f32 activations, `model_kwargs`
passed on), on the card unless `device="cpu"`.  Eviction stops the
instance's engine and HTTP threads and drops every reference to its model
and caches, so the card's memory comes back.
"""

from __future__ import annotations

import gc
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class ModelInstance:
    """One model's replica group: requests go round robin across
    `servers`."""

    def __init__(self, name: str, servers: list):
        self.name = name
        self.servers = servers
        self.last_used = time.time()
        self.in_flight = 0  # requests forwarded and not yet answered
        self._rr = 0

    def pick(self):
        srv = self.servers[self._rr % len(self.servers)]
        self._rr += 1
        return srv

    def shutdown(self):
        """Stop every replica and drop them, so a caller still holding the
        instance does not keep its model alive."""
        for s in self.servers:
            s.shutdown()
        self.servers = []


class RouterServer:
    def __init__(self, models_dir: str, host="127.0.0.1", port: int = 8080,
                 models_max: int = 2, n_slots: int = 2,
                 max_len: int = 2048, model_kwargs: dict | None = None,
                 replicas: int = 1, device="cuda"):
        self.models_dir = models_dir
        self.host = host
        self.port = port
        self.models_max = models_max
        self.n_slots = n_slots
        self.max_len = max_len
        self.model_kwargs = model_kwargs or {}
        self.replicas = max(1, replicas)
        self.device = device
        self.instances: dict[str, ModelInstance] = {}
        self._cond = threading.Condition()  # guards instances and in_flight
        self.httpd: ThreadingHTTPServer | None = None

    # -- model management ---------------------------------------------------
    def available(self) -> list[str]:
        return [f for f in sorted(os.listdir(self.models_dir)) if f.endswith(".gguf")]

    def load(self, name: str) -> ModelInstance:
        with self._cond:
            return self._load(name)

    def acquire(self, name: str) -> tuple[ModelInstance, int]:
        """Load `name` if needed and pick a replica's port; the instance is
        not evicted until `release`."""
        with self._cond:
            inst = self._load(name)
            inst.in_flight += 1
            return inst, inst.pick().port

    def release(self, inst: ModelInstance):
        with self._cond:
            inst.in_flight -= 1
            self._cond.notify_all()

    def _load(self, name: str) -> ModelInstance:
        """Under the lock: the loaded instance, or a new one once there is
        room, evicting the least recently used idle model."""
        path = os.path.join(self.models_dir, os.path.basename(name))
        while True:
            inst = self.instances.get(name)
            if inst is not None:
                inst.last_used = time.time()
                return inst
            if not os.path.exists(path):
                raise FileNotFoundError(name)
            if not self.models_max or len(self.instances) < self.models_max:
                break
            idle = [i for i in self.instances.values() if not i.in_flight]
            if idle:
                self._unload(min(idle, key=lambda i: i.last_used).name)
            else:
                self._cond.wait()

        import torch

        from ..models.loader import Model
        from .http import ZllmServer

        m = Model.load(path, device=self.device, dtype=torch.float32, **self.model_kwargs)
        servers = []
        for _ in range(self.replicas):
            srv = ZllmServer(m, n_slots=self.n_slots, max_len=self.max_len, port=0)
            srv.start_background()
            servers.append(srv)
        inst = ModelInstance(name, servers)
        self.instances[name] = inst
        return inst

    def _unload(self, name: str):
        inst = self.instances.pop(name, None)
        if inst is None:
            return
        inst.shutdown()
        # the servers' handler classes close over them: collect the cycles,
        # then hand the freed blocks back to the device
        gc.collect()
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def unload(self, name: str):
        """Evict `name` once its requests in flight are answered."""
        with self._cond:
            self._cond.wait_for(lambda: not getattr(self.instances.get(name), "in_flight", 0))
            self._unload(name)

    # -- HTTP ---------------------------------------------------------------
    def serve_forever(self):
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"status": "ok"})
                elif self.path in ("/models", "/v1/models"):
                    loaded = set(router.instances)
                    self._json(200, {"object": "list", "data": [
                        {"id": name, "object": "model",
                         "state": "loaded" if name in loaded else "available"}
                        for name in router.available()
                    ]})
                else:
                    self._json(404, {"error": "router: unknown GET endpoint"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b"{}"
                try:
                    body = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    self._json(400, {"error": "bad json"})
                    return
                if self.path == "/models/load":
                    try:
                        router.load(body["model"])
                        self._json(200, {"success": True})
                    except FileNotFoundError:
                        self._json(404, {"error": f"no such model {body.get('model')!r}"})
                    return
                if self.path == "/models/unload":
                    router.unload(body.get("model", ""))
                    self._json(200, {"success": True})
                    return

                name = body.get("model", "")
                if not name or name == "zllm":
                    avail = router.available()
                    if len(router.instances) == 1:
                        name = next(iter(router.instances))
                    elif len(avail) == 1:
                        name = avail[0]
                    else:
                        self._json(400, {"error": "request must name a model"})
                        return
                try:
                    inst, port = router.acquire(name)
                except FileNotFoundError:
                    self._json(404, {"error": f"no such model {name!r}"})
                    return
                try:
                    self._forward(port, raw)
                finally:
                    router.release(inst)

            def _forward(self, port, raw):
                """Send the body verbatim to the replica on `port` and stream
                its reply back."""
                freq = urllib.request.Request(f"http://127.0.0.1:{port}{self.path}", data=raw,
                                              headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(freq, timeout=600) as resp:
                        self.send_response(resp.status)
                        ctype = resp.headers.get("Content-Type", "application/json")
                        self.send_header("Content-Type", ctype)
                        if "event-stream" in ctype:
                            self.send_header("Transfer-Encoding", "chunked")
                            self.end_headers()
                            while True:
                                chunk = resp.read(4096)
                                if not chunk:
                                    break
                                self.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                            self.wfile.write(b"0\r\n\r\n")
                        else:
                            data = resp.read()
                            self.send_header("Content-Length", str(len(data)))
                            self.end_headers()
                            self.wfile.write(data)
                except urllib.error.HTTPError as e:  # pass the model's error through
                    data = e.read()
                    self.send_response(e.code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except urllib.error.URLError as e:  # the replica did not answer
                    self._json(503, {"error": f"model server unavailable: {e.reason}"})

        httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = httpd.server_address[1]
        self.httpd = httpd
        httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True, name="zllm-router")
        t.start()
        while self.httpd is None:
            time.sleep(0.02)
        return t

    def shutdown(self):
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()
        for name in list(self.instances):
            self.unload(name)
