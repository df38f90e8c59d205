"""OpenAI tool calling (function calling): the port's copy of
`zllm/server/toolcall.py`, pure Python over the port's grammars.

Tools are rendered into the system turn, the output is parsed back into
`tool_calls`, and a "lazy" grammar constrains the generation only once the
trigger string appears.  The protocol is Hermes/Qwen's
`<tool_call>{json}</tool_call>` over any chat template.
"""

from __future__ import annotations

import json
import re

from ..grammar import json_schema_to_gbnf, parse_gbnf
from ..grammar.gbnf import GrammarSampler

TOOL_OPEN = "<tool_call>"
TOOL_CLOSE = "</tool_call>"

_SYS_PREAMBLE = (
    "You are a function-calling AI. You may call one or more of the "
    "functions below to answer the user. The available functions are "
    "listed inside <tools></tools> XML tags, one JSON schema each:\n"
    "<tools>\n{tools}\n</tools>\n"
    "For each function call, return exactly one JSON object wrapped in "
    "<tool_call></tool_call> XML tags, shaped "
    '{{"name": <function-name>, "arguments": <args-json-object>}}.'
)


def _tool_schemas(tools: list[dict]) -> list[dict]:
    out = []
    for t in tools:
        fn = t.get("function", t) or {}
        out.append({
            "name": fn.get("name", ""),
            "description": fn.get("description", ""),
            "parameters": fn.get("parameters", {"type": "object"}),
        })
    return out


def prepare_messages(messages: list[dict], tools: list[dict]) -> list[dict]:
    """Rewrite an OpenAI message list for a tool-call conversation: the
    tool inventory is injected into the system turn, assistant tool_calls
    become <tool_call> text, and tool-result turns become
    <tool_response> user turns (so every chat template can render them)."""
    schemas = _tool_schemas(tools)
    preamble = _SYS_PREAMBLE.format(
        tools="\n".join(json.dumps(s, ensure_ascii=False) for s in schemas)
    )
    out = []
    had_system = False
    for m in messages:
        role = m.get("role", "user")
        if role == "system" and not had_system:
            had_system = True
            out.append({"role": "system", "content": f"{m.get('content', '')}\n\n{preamble}"})
            continue
        if role == "assistant" and m.get("tool_calls"):
            parts = [m.get("content") or ""]
            for tc in m["tool_calls"]:
                fn = tc.get("function", {})
                args = fn.get("arguments", "{}")
                if isinstance(args, str):
                    try:
                        args = json.loads(args)
                    except json.JSONDecodeError:
                        pass
                obj = {"name": fn.get("name", ""), "arguments": args}
                parts.append(f"{TOOL_OPEN}\n{json.dumps(obj, ensure_ascii=False)}\n{TOOL_CLOSE}")
            out.append({"role": "assistant", "content": "\n".join(p for p in parts if p)})
            continue
        if role == "tool":
            content = m.get("content", "")
            out.append({
                "role": "user",
                "content": f"<tool_response>\n{content}\n</tool_response>",
            })
            continue
        out.append(m)
    if not had_system:
        out.insert(0, {"role": "system", "content": preamble})
    return out


def tool_call_gbnf(tools: list[dict], only: str | None = None) -> str:
    """GBNF forcing one-or-more <tool_call>{json}</tool_call> blocks whose
    JSON conforms to one of the tool schemas (reference:
    common/chat.cpp building JSON-schema grammars per tool).  `only`
    restricts to a single named function (tool_choice={"function":...})."""
    alts = []
    for s in _tool_schemas(tools):
        if only is not None and s["name"] != only:
            continue
        alts.append({
            "type": "object",
            "properties": {
                "name": {"const": s["name"]},
                "arguments": s["parameters"] or {"type": "object"},
            },
            "required": ["name", "arguments"],
        })
    if not alts:
        raise ValueError(f"tool_choice names unknown function {only!r}")
    schema = alts[0] if len(alts) == 1 else {"anyOf": alts}
    body = json_schema_to_gbnf(schema)
    body = body.replace("root ::=", "tcjson ::=", 1)
    return (
        'root ::= tc+\n'
        f'tc ::= "{TOOL_OPEN}" sp tcjson "{TOOL_CLOSE}" sp\n'
        # bounded so a sampler can't stall in a whitespace loop
        'sp ::= [ \\t\\n]{0,3}\n' + body
    )


def make_tool_grammar(tools: list[dict], tokenizer, only: str | None = None,
                      lazy: bool = False):
    """GrammarSampler (forced) or LazyGrammarSampler (auto tool choice:
    free text until the model opens a <tool_call>, constrained after)."""
    g = parse_gbnf(tool_call_gbnf(tools, only))
    if lazy:
        return LazyGrammarSampler(g, tokenizer, trigger=TOOL_OPEN)
    return GrammarSampler(g, tokenizer)


class LazyGrammarSampler:
    """Grammar constraint that stays dormant until `trigger` appears in
    the generated text (reference: common_grammar_trigger / grammar_lazy,
    common/sampling.cpp — tool-call grammars must not constrain the
    free-text part of a reply).  Duck-types GrammarSampler's engine
    interface (allowed / accept_token)."""

    def __init__(self, grammar, tokenizer, trigger: str):
        self.g = grammar
        self.tok = tokenizer
        self.trigger = trigger
        self.active: GrammarSampler | None = None
        self._buf = ""

    def allowed(self, candidate_ids):
        if self.active is not None:
            return self.active.allowed(candidate_ids)
        return [int(t) for t in candidate_ids]

    def accept_token(self, tid: int):
        if self.active is not None:
            self.active.accept_token(tid)
            return
        self._buf += self.tok.decode([int(tid)], skip_special=False)
        i = self._buf.find(self.trigger)
        if i < 0:
            # keep only a potential trigger-prefix tail
            keep = len(self.trigger) - 1
            self._buf = self._buf[-keep:] if keep else ""
            return
        self.active = GrammarSampler(self.g, self.tok)
        for c in self._buf[i:]:
            if not self.active.state.accept(ord(c)):
                # the trigger matched but the tail diverged (e.g. partial
                # json already emitted) — constrain from scratch next token
                self.active = None
                self._buf = ""
                return


_TC_RE = re.compile(re.escape(TOOL_OPEN) + r"\s*(\{.*?\})\s*" + re.escape(TOOL_CLOSE),
                    re.DOTALL)


def parse_tool_calls(text: str, rid: str = "") -> tuple[str, list[dict]]:
    """Extract <tool_call> blocks from a completion into OpenAI tool_calls
    (reference: common/chat-parser.cpp consume_tool_calls).  Returns
    (remaining_content, tool_calls)."""
    calls = []

    def _mk(obj, idx):
        args = obj.get("arguments", obj.get("parameters", {}))
        return {
            "id": f"call_{rid or 'tc'}_{idx}",
            "type": "function",
            "function": {
                "name": str(obj.get("name", "")),
                "arguments": args if isinstance(args, str) else json.dumps(args, ensure_ascii=False),
            },
        }

    out_text = []
    last = 0
    for i, m in enumerate(_TC_RE.finditer(text)):
        out_text.append(text[last:m.start()])
        last = m.end()
        try:
            calls.append(_mk(json.loads(m.group(1)), len(calls)))
        except json.JSONDecodeError:
            out_text.append(m.group(0))  # malformed: keep as text
    out_text.append(text[last:])
    content = "".join(out_text).strip()
    # a generation cut off by the token budget can leave an unterminated
    # block behind — unusable, so drop it rather than leak it as content
    i = content.rfind(TOOL_OPEN)
    if i >= 0 and TOOL_CLOSE not in content[i:]:
        content = content[:i].strip()

    if not calls:
        # forced-JSON models may answer with a bare {"name":..., "arguments":...}
        t = text.strip()
        if t.startswith("{") and t.endswith("}"):
            try:
                obj = json.loads(t)
                if isinstance(obj, dict) and "name" in obj and (
                    "arguments" in obj or "parameters" in obj
                ):
                    return "", [_mk(obj, 0)]
            except json.JSONDecodeError:
                pass
    return content, calls
