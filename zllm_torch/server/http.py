"""OpenAI-compatible HTTP server over the continuous-batching engine
(counterpart of `zllm/server/http.py::ZllmServer`).

GET /health, /v1/models, /props, /slots, /metrics (Prometheus); POST
/v1/completions (also /completion, /completions), /v1/chat/completions
(both with streaming SSE; `tools` and `tool_choice` for tool calls,
`server/toolcall.py`), /v1/messages and /v1/messages/count_tokens (the
Anthropic Messages API), /infill (fill-in-the-middle), /slots/{id}?action=
save|restore|erase (state files under `slot_save_path`), /tokenize,
/detokenize, /apply-template; stop strings and the grammar / json_schema /
response_format fields.  Embeddings and rerank, which zllm serves and the
port does not yet, answer 501 with the ROADMAP item that brings them.
Stdlib ThreadingHTTPServer: request threads block on per-request queues
fed by the engine thread.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .chat import apply_chat_template
from .engine import Engine, Request

# zllm routes not ported yet (ROADMAP queue 1 item 4.6: they need pooling
# and an encoder family, item 8)
_NOT_PORTED = ("/embeddings", "/v1/embeddings", "/rerank", "/v1/rerank")


def _not_ported_error(what: str) -> dict:
    return {"error": {"message": f"{what} is not in zllm_torch's server yet "
                                 "(ROADMAP queue 1 item 4.6)", "type": "not_implemented"}}


def _sse(obj) -> bytes:
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


class ZllmServer:
    def __init__(self, model, n_slots: int = 4, max_len: int = 2048, host="127.0.0.1",
                 port=8080, slot_save_path: str = "", speculative: bool = False,
                 n_draft: int = 6, kv_layout: str = "auto", draft_model=None,
                 jinja: bool = False, kv_dtype=None, lookahead: bool = False):
        self.model = model
        self.jinja = jinja
        self.engine = Engine(model, n_slots=n_slots, max_len=max_len,
                             speculative=speculative, n_draft=n_draft, kv_layout=kv_layout,
                             draft_model=draft_model, kv_dtype=kv_dtype, lookahead=lookahead)
        self.slot_save_path = slot_save_path
        self.host = host
        self.port = port
        self.httpd: ThreadingHTTPServer | None = None
        self._t0 = time.time()

    # -- request building ---------------------------------------------------
    def _make_request(self, body: dict, prompt_tokens: list[int], grammar=None) -> Request:
        tok = self.model.tokenizer
        stop_tokens = {tok.eos_id} if tok and tok.eos_id >= 0 else set()
        gbnf = None if grammar is not None else body.get("grammar")
        schema = body.get("json_schema") or (
            body.get("response_format", {}).get("json_schema", {}).get("schema")
            if isinstance(body.get("response_format"), dict) else None
        )
        if schema is not None and gbnf is None:
            from ..grammar import json_schema_to_gbnf

            gbnf = json_schema_to_gbnf(schema)
        if gbnf:
            from ..grammar import GrammarSampler, parse_gbnf

            grammar = GrammarSampler(parse_gbnf(gbnf), tok)
        stop = body.get("stop", body.get("stop_strings", []))
        if isinstance(stop, str):
            stop = [stop]
        return Request(
            grammar=grammar,
            prompt_tokens=prompt_tokens,
            max_new=int(body.get("max_tokens", body.get("n_predict", 128))),
            temp=float(body.get("temperature", 0.8)),
            top_k=int(body.get("top_k", 40)),
            top_p=float(body.get("top_p", 0.95)),
            min_p=float(body.get("min_p", 0.05)),
            typical_p=float(body.get("typical_p", body.get("typ_p", 1.0))),
            top_n_sigma=float(body.get("top_n_sigma", 0.0)),
            xtc_probability=float(body.get("xtc_probability", 0.0)),
            xtc_threshold=float(body.get("xtc_threshold", 0.1)),
            dry_multiplier=float(body.get("dry_multiplier", 0.0)),
            dry_base=float(body.get("dry_base", 1.75)),
            dry_allowed_length=int(body.get("dry_allowed_length", 2)),
            dynatemp_range=float(body.get("dynatemp_range", 0.0)),
            dynatemp_exponent=float(body.get("dynatemp_exponent", 1.0)),
            mirostat=int(body.get("mirostat", 0)),
            mirostat_tau=float(body.get("mirostat_tau", 5.0)),
            mirostat_eta=float(body.get("mirostat_eta", 0.1)),
            repeat_penalty=float(body.get("repeat_penalty", 1.0)),
            freq_penalty=float(body.get("frequency_penalty", 0.0)),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            seed=int(body.get("seed", -1)),
            n_keep=int(body.get("n_keep", 0)),
            stop_tokens=frozenset(stop_tokens),
            stop_strings=tuple(stop),
        )

    def serve_forever(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code: int, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _read_body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            # ---- GET ----
            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"status": "ok"})
                elif self.path == "/v1/models":
                    self._json(200, {
                        "object": "list",
                        "data": [{"id": server.model.path or "model", "object": "model",
                                  "created": int(server._t0), "owned_by": "zllm"}],
                    })
                elif self.path == "/props":
                    cfg = server.model.cfg
                    self._json(200, {
                        "model_path": server.model.path,
                        "n_ctx": server.engine.max_len,
                        "n_slots": server.engine.n_slots,
                        "arch": cfg.arch,
                        "n_params_shape": {"layers": cfg.n_layers, "embd": cfg.n_embd},
                    })
                elif self.path == "/slots":
                    self._json(200, server.engine.slot_info())
                elif self.path == "/metrics":
                    lines = []
                    for k, v in server.engine.metrics_view().items():
                        lines.append(f"# TYPE zllm_{k} counter")
                        lines.append(f"zllm_{k} {v}")
                    for name, h in (
                        ("zllm_time_to_first_token_seconds", server.engine.hist_ttft),
                        ("zllm_inter_token_latency_seconds", server.engine.hist_per_token),
                        ("zllm_request_duration_seconds", server.engine.hist_request),
                    ):
                        lines.append(f"# TYPE {name} histogram")
                        lines.append(h.prometheus(name))
                    data = ("\n".join(lines) + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._json(404, {"error": "not found"})

            # ---- POST ----
            def do_POST(self):
                try:
                    body = self._read_body()
                    if self.path in ("/v1/completions", "/completion", "/completions"):
                        self._completion(body, chat=False)
                    elif self.path == "/v1/chat/completions":
                        self._completion(body, chat=True)
                    elif self.path == "/v1/messages":
                        self._anthropic_messages(body)
                    elif self.path == "/v1/messages/count_tokens":
                        self._anthropic_count(body)
                    elif self.path == "/tokenize":
                        ids = server.model.tokenizer.encode(
                            body.get("content", ""), add_special=bool(body.get("add_special", False)),
                            parse_special=bool(body.get("parse_special", False)),
                        )
                        self._json(200, {"tokens": ids})
                    elif self.path == "/detokenize":
                        text = server.model.tokenizer.decode(body.get("tokens", []))
                        self._json(200, {"content": text})
                    elif self.path == "/apply-template":
                        text = apply_chat_template(
                            server.model, body.get("messages", []),
                            add_assistant=bool(body.get("add_generation_prompt", True)),
                            jinja=server.jinja or bool(body.get("jinja", False)),
                        )
                        self._json(200, {"prompt": text})
                    elif self.path == "/infill":
                        self._infill(body)
                    elif self.path.startswith("/slots/"):
                        self._slot_action(body)
                    elif self.path in _NOT_PORTED:
                        self._json(501, _not_ported_error("embeddings and rerank"))
                    else:
                        self._json(404, {"error": "not found"})
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001 — the request's error reply
                    try:
                        self._json(500, {"error": {"message": str(e), "type": type(e).__name__}})
                    except OSError:
                        pass

            def _drain(self, req):
                while req.stream_q.get() is not None:
                    pass

            def _open_stream(self):
                """Start a chunked SSE reply; returns its chunk writer."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunked(data: bytes):
                    self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

                return chunked

            def _encode_prompt(self, text: str) -> list[int]:
                tok = server.model.tokenizer
                ids = tok.encode(text, add_special=True, parse_special=True)
                # chat templates that render their own BOS (llama3's
                # <|begin_of_text|>) would otherwise double it
                if len(ids) >= 2 and ids[0] == tok.bos_id and ids[1] == tok.bos_id:
                    ids = ids[1:]
                return ids

            def _infill(self, body: dict):
                """Fill-in-the-middle: [bos] fim_pre prefix fim_suf suffix
                fim_mid, decoded from there; end-of-turn stops too."""
                tok = server.model.tokenizer
                v = tok.vocab
                if v.fim_pre_id < 0 or v.fim_suf_id < 0 or v.fim_mid_id < 0:
                    self._json(501, {"error": "model lacks FIM tokens (infill unsupported)"})
                    return
                prefix = body.get("input_prefix", body.get("prompt", ""))
                suffix = body.get("input_suffix", "")
                ids = ([v.fim_pre_id] + tok.encode(prefix) + [v.fim_suf_id] + tok.encode(suffix)
                       + [v.fim_mid_id])
                if v.add_bos and v.bos_id >= 0:
                    ids = [v.bos_id] + ids
                req = server._make_request(body, ids)
                if v.eot_id >= 0:
                    req.stop_tokens = frozenset(set(req.stop_tokens) | {v.eot_id})
                server.engine.submit(req)
                self._drain(req)
                self._json(200, {"content": tok.decode(req.out_tokens),
                                 "tokens_predicted": len(req.out_tokens),
                                 "stop_type": req.finish_reason})

            def _slot_action(self, body: dict):
                """POST /slots/{id}?action=save|restore|erase: a state file
                named by the body's `filename` (its basename) under
                slot_save_path."""
                path, _, query = self.path.partition("?")
                try:
                    idx = int(path.rsplit("/", 1)[1])
                except ValueError:
                    idx = -1
                action = urllib.parse.parse_qs(query).get("action", [""])[0]
                if not 0 <= idx < server.engine.n_slots:
                    self._json(400, {"error": "invalid slot id"})
                    return
                fname = body.get("filename", f"slot{idx}.bin")
                fpath = os.path.join(server.slot_save_path or ".", os.path.basename(fname))
                if action == "save":
                    self._json(200, server.engine.save_slot(idx, fpath))
                elif action == "restore":
                    self._json(200, server.engine.restore_slot(idx, fpath, body.get("tokens")))
                elif action == "erase":
                    self._json(200, server.engine.erase_slot(idx))
                else:
                    self._json(400, {"error": f"unknown action {action!r}"})

            # -- the Anthropic Messages API ------------------------------
            def _anthropic_prompt(self, body: dict) -> list[int]:
                msgs = []
                system = body.get("system")
                if system:
                    if isinstance(system, list):  # content blocks
                        system = "".join(b.get("text", "") for b in system)
                    msgs.append({"role": "system", "content": system})
                for m in body.get("messages", []):
                    content = m.get("content", "")
                    if isinstance(content, list):
                        content = "".join(b.get("text", "") for b in content
                                          if b.get("type") == "text")
                    msgs.append({"role": m.get("role", "user"), "content": content})
                text = apply_chat_template(server.model, msgs, jinja=server.jinja)
                return self._encode_prompt(text)

            def _anthropic_count(self, body: dict):
                self._json(200, {"input_tokens": len(self._anthropic_prompt(body))})

            def _anthropic_messages(self, body: dict):
                ids = self._anthropic_prompt(body)
                oai_body = {"max_tokens": body.get("max_tokens", 4096),
                            "temperature": body.get("temperature", 1.0),
                            "top_p": body.get("top_p", 1.0), "top_k": body.get("top_k", 0),
                            "stop": body.get("stop_sequences", [])}
                req = server._make_request(oai_body, ids)
                server.engine.submit(req)
                mid = "msg_" + req.rid
                model_name = body.get("model", "zllm")
                stop_map = {"stop": "end_turn", "length": "max_tokens"}

                if not body.get("stream", False):
                    self._drain(req)
                    text = server.model.tokenizer.decode(req.out_tokens)
                    stop_reason = stop_map.get(req.finish_reason, "end_turn")
                    for ss in req.stop_strings:
                        i = text.find(ss)
                        if i >= 0:
                            text, stop_reason = text[:i], "stop_sequence"
                            break
                    self._json(200, {
                        "id": mid, "type": "message", "role": "assistant", "model": model_name,
                        "content": [{"type": "text", "text": text}],
                        "stop_reason": stop_reason, "stop_sequence": None,
                        "usage": {"input_tokens": len(ids), "output_tokens": len(req.out_tokens)},
                    })
                    return

                chunked = self._open_stream()

                def ev(name: str, obj: dict):
                    chunked(f"event: {name}\ndata: {json.dumps(obj)}\n\n".encode())

                ev("message_start", {"type": "message_start", "message": {
                    "id": mid, "type": "message", "role": "assistant", "model": model_name,
                    "content": [], "stop_reason": None, "stop_sequence": None,
                    "usage": {"input_tokens": len(ids), "output_tokens": 0}}})
                ev("content_block_start", {"type": "content_block_start", "index": 0,
                                           "content_block": {"type": "text", "text": ""}})
                from ..tokenizer import IncrementalDecoder

                inc = IncrementalDecoder(server.model.tokenizer)
                while True:
                    t = req.stream_q.get()
                    piece = inc.flush() if t is None else inc.push(t)
                    if piece:
                        ev("content_block_delta", {"type": "content_block_delta", "index": 0,
                                                   "delta": {"type": "text_delta", "text": piece}})
                    if t is None:
                        break
                ev("content_block_stop", {"type": "content_block_stop", "index": 0})
                ev("message_delta", {"type": "message_delta",
                                     "delta": {"stop_reason": stop_map.get(req.finish_reason,
                                                                           "end_turn"),
                                               "stop_sequence": None},
                                     "usage": {"output_tokens": len(req.out_tokens)}})
                ev("message_stop", {"type": "message_stop"})
                chunked(b"")

            def _completion(self, body: dict, chat: bool):
                from .toolcall import TOOL_OPEN, make_tool_grammar, parse_tool_calls, \
                    prepare_messages

                tok = server.model.tokenizer
                tools = body.get("tools") or []
                tool_choice = body.get("tool_choice", "auto")
                # auto: a lazy grammar that wakes at <tool_call>; required
                # or a named function: forced from the first token
                tools_on = bool(chat and tools and tool_choice != "none")
                grammar = None
                if chat:
                    msgs = body.get("messages", [])
                    if tools_on:
                        msgs = prepare_messages(msgs, tools)
                        only = None
                        forced = tool_choice == "required"
                        if isinstance(tool_choice, dict):
                            only = tool_choice.get("function", {}).get("name")
                            forced = True
                        grammar = make_tool_grammar(tools, tok, only=only, lazy=not forced)
                    text = apply_chat_template(server.model, msgs, jinja=server.jinja)
                else:
                    text = body.get("prompt", "")
                if isinstance(text, list):
                    text = "".join(text)
                ids = self._encode_prompt(text)
                req = server._make_request(body, ids, grammar=grammar)
                stream = bool(body.get("stream", False))
                server.engine.submit(req)

                created = int(time.time())
                oid = ("chatcmpl-" if chat else "cmpl-") + req.rid
                if stream:
                    chunked = self._open_stream()
                    from ..tokenizer import IncrementalDecoder

                    inc = IncrementalDecoder(tok)
                    sent = 0
                    done = False
                    # stop-string holdback: never emit a tail that could be
                    # the start of a stop string; with tools on, <tool_call>
                    # is held back the same way and its block buffered whole
                    holds = list(req.stop_strings) + ([TOOL_OPEN] if tools_on else [])
                    holdback = max((len(s) for s in holds), default=1) - 1
                    pending = ""
                    stopped = False
                    tc_buf = ""
                    while not done:
                        t = req.stream_q.get()
                        done = t is None
                        if stopped:
                            continue
                        pending += inc.flush() if done else inc.push(t)
                        if tc_buf:
                            tc_buf += pending
                            pending = ""
                            continue
                        hit = min((i for i in (pending.find(s) for s in req.stop_strings) if i >= 0),
                                  default=-1)
                        thit = pending.find(TOOL_OPEN) if tools_on else -1
                        if thit >= 0 and (hit < 0 or thit < hit):
                            # the text before the block streams, the block buffers
                            piece, tc_buf, pending = pending[:thit], pending[thit:], ""
                        elif hit >= 0:
                            piece, pending, stopped = pending[:hit], "", True
                        elif done:
                            piece, pending = pending, ""
                        elif len(pending) > holdback:
                            cut = len(pending) - holdback
                            piece, pending = pending[:cut], pending[cut:]
                        else:
                            piece = ""
                        if not piece:
                            continue
                        if chat:
                            delta = {"role": "assistant", "content": piece} if sent == 0 else {"content": piece}
                            payload = {"id": oid, "object": "chat.completion.chunk", "created": created,
                                       "model": "zllm", "choices": [{"index": 0, "delta": delta, "finish_reason": None}]}
                        else:
                            payload = {"id": oid, "object": "text_completion", "created": created,
                                       "model": "zllm", "choices": [{"index": 0, "text": piece, "finish_reason": None}]}
                        chunked(_sse(payload))
                        sent += 1
                    finish = req.finish_reason
                    if tc_buf:
                        _, calls = parse_tool_calls(tc_buf, req.rid)
                        if calls:
                            finish = "tool_calls"
                            for ci, c in enumerate(calls):
                                c["index"] = ci
                            chunked(_sse({"id": oid, "object": "chat.completion.chunk",
                                          "created": created, "model": "zllm",
                                          "choices": [{"index": 0, "delta": {"tool_calls": calls},
                                                       "finish_reason": None}]}))
                    fin = {"id": oid, "object": "chat.completion.chunk" if chat else "text_completion",
                           "created": created, "model": "zllm",
                           "choices": [{"index": 0, "delta": {} if chat else None, "text": None if chat else "",
                                        "finish_reason": finish}]}
                    chunked(_sse(fin))
                    chunked(b"data: [DONE]\n\n")
                    chunked(b"")
                    return

                # non-streaming: drain
                self._drain(req)
                out_text = tok.decode(req.out_tokens)
                for ss in req.stop_strings:
                    i = out_text.find(ss)
                    if i >= 0:
                        out_text = out_text[:i]
                        break
                usage = {"prompt_tokens": len(ids), "completion_tokens": len(req.out_tokens),
                         "total_tokens": len(ids) + len(req.out_tokens)}
                if chat:
                    message = {"role": "assistant", "content": out_text}
                    finish = req.finish_reason
                    if tools_on:
                        content, calls = parse_tool_calls(out_text, req.rid)
                        if calls:
                            message = {"role": "assistant", "content": content or None,
                                       "tool_calls": calls}
                            finish = "tool_calls"
                    self._json(200, {
                        "id": oid, "object": "chat.completion", "created": created, "model": "zllm",
                        "choices": [{"index": 0, "message": message, "finish_reason": finish}],
                        "usage": usage,
                    })
                else:
                    self._json(200, {
                        "id": oid, "object": "text_completion", "created": created, "model": "zllm",
                        "choices": [{"index": 0, "text": out_text, "finish_reason": req.finish_reason}],
                        "usage": usage,
                    })

        self.engine.start()
        httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = httpd.server_address[1]  # before start_background sees httpd
        self.httpd = httpd
        httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True, name="zllm-http")
        t.start()
        while self.httpd is None:
            time.sleep(0.02)
        self._http_thread = t
        return t

    def shutdown(self):
        """Stop serving and the engine thread; a background server's HTTP
        thread is joined, so nothing of it holds the model afterwards."""
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()
        self.engine.stop()
        t = getattr(self, "_http_thread", None)
        if t is not None:
            t.join(timeout=30)
