"""The port's tool calling (zllm_torch.server.toolcall) against zllm's, on
the CPU: tests/test_toolcall.py's four cases run on the port's functions,
and each function's output is held equal to zllm's on the same inputs
(rendered messages, GBNF text, grammar accept/reject sets, parsed calls)."""

import json

import pytest

WEATHER = {
    "type": "function",
    "function": {
        "name": "get_weather",
        "description": "Get the weather",
        "parameters": {
            "type": "object",
            "properties": {"city": {"type": "string"}},
            "required": ["city"],
        },
    },
}
TIME = {
    "type": "function",
    "function": {
        "name": "get_time",
        "parameters": {"type": "object", "properties": {}},
    },
}
HISTORY = [
    {"role": "system", "content": "Be brief."},
    {"role": "user", "content": "weather in Oslo?"},
    {"role": "assistant", "tool_calls": [{
        "id": "call_1", "type": "function",
        "function": {"name": "get_weather", "arguments": '{"city": "Oslo"}'},
    }]},
    {"role": "tool", "tool_call_id": "call_1", "content": '{"temp": -3}'},
]
# (tools, only) -> texts the grammar must accept / reject
GRAMMARS = {
    "both": (([WEATHER, TIME], None),
             ['<tool_call>{"name": "get_weather", "arguments": {"city": "Oslo"}}</tool_call>',
              '<tool_call>{"name": "get_time", "arguments": {}}</tool_call>\n'
              '<tool_call>{"name": "get_time", "arguments": {}}</tool_call>'],
             ['<tool_call>{"name": "nope"', '{"name": "get_time", "arguments": {}}',
              '<tool_call>{"name": "get_weather", "arguments": {}}</tool_call>']),
    "only": (([WEATHER, TIME], "get_time"),
             ['<tool_call>{"name": "get_time", "arguments": {}}</tool_call>'],
             ['<tool_call>{"name": "get_weather"']),
}
OUTPUTS = [
    "Let me check.\n<tool_call>\n"
    '{"name": "get_weather", "arguments": {"city": "Oslo"}}\n</tool_call>',
    '{"name": "get_time", "arguments": {}}',
    "just words",
    '<tool_call>{"name": "a", "arguments": {}}</tool_call> and '
    '<tool_call>{"name": "b", "parameters": {"x": 1}}</tool_call>',
    '<tool_call>{not json}</tool_call> tail',
    'text <tool_call>{"name": "cut", "argu',
]


class _ByteTok:
    """decode(ids) = chr(id); eos_id 0."""

    eos_id = 0

    def decode(self, ids, skip_special=False):
        return "".join(chr(i) for i in ids if i != 0)


def test_prepare_messages_injects_tools_and_flattens_history():
    from zllm.server import toolcall as z
    from zllm_torch.server.toolcall import TOOL_OPEN, prepare_messages

    out = prepare_messages(HISTORY, [WEATHER])
    assert out[0]["role"] == "system"
    assert "get_weather" in out[0]["content"] and "Be brief." in out[0]["content"]
    assert TOOL_OPEN in out[2]["content"] and '"Oslo"' in out[2]["content"]
    assert out[3]["role"] == "user" and "<tool_response>" in out[3]["content"]
    out2 = prepare_messages([{"role": "user", "content": "hi"}], [WEATHER])
    assert out2[0]["role"] == "system" and "<tools>" in out2[0]["content"]
    assert out == z.prepare_messages(HISTORY, [WEATHER])
    assert out2 == z.prepare_messages([{"role": "user", "content": "hi"}], [WEATHER])


@pytest.mark.parametrize("case", list(GRAMMARS))
def test_tool_grammar_accepts_exact_calls_and_rejects_junk(case):
    from zllm.grammar.gbnf import GrammarState as ZState
    from zllm.grammar.gbnf import parse_gbnf as zparse
    from zllm.server import toolcall as z
    from zllm_torch.grammar.gbnf import GrammarState, parse_gbnf
    from zllm_torch.server.toolcall import tool_call_gbnf

    (tools, only), accept, reject = GRAMMARS[case]
    text = tool_call_gbnf(tools, only=only)
    assert text == z.tool_call_gbnf(tools, only=only)
    g, zg = parse_gbnf(text), zparse(text)
    for t in accept + reject:
        got = GrammarState(g).accepts_text(t)
        assert got == ZState(zg).accepts_text(t), t
        assert got == (t in accept), t
    with pytest.raises(ValueError, match="unknown function"):
        tool_call_gbnf(tools, only="missing")


@pytest.mark.parametrize("i", range(len(OUTPUTS)))
def test_parse_tool_calls_as_zllm(i):
    from zllm.server import toolcall as z
    from zllm_torch.server.toolcall import parse_tool_calls

    assert parse_tool_calls(OUTPUTS[i], "r1") == z.parse_tool_calls(OUTPUTS[i], "r1")


def test_parse_tool_calls_roundtrip():
    from zllm_torch.server.toolcall import parse_tool_calls

    content, calls = parse_tool_calls(OUTPUTS[0], "r1")
    assert content == "Let me check."
    assert len(calls) == 1 and calls[0]["function"]["name"] == "get_weather"
    assert json.loads(calls[0]["function"]["arguments"]) == {"city": "Oslo"}
    content, calls = parse_tool_calls(OUTPUTS[1])
    assert calls and calls[0]["function"]["name"] == "get_time"
    content, calls = parse_tool_calls("just words")
    assert content == "just words" and calls == []


def test_lazy_grammar_dormant_then_constrains():
    from zllm.grammar.gbnf import parse_gbnf as zparse
    from zllm.server import toolcall as z
    from zllm_torch.grammar.gbnf import parse_gbnf
    from zllm_torch.server.toolcall import TOOL_OPEN, LazyGrammarSampler, tool_call_gbnf

    tok = _ByteTok()
    text = tool_call_gbnf([TIME])
    lazy = LazyGrammarSampler(parse_gbnf(text), tok, trigger=TOOL_OPEN)
    zlazy = z.LazyGrammarSampler(zparse(text), tok, trigger=TOOL_OPEN)
    cand = [ord(c) for c in "Hello"]
    assert lazy.allowed(cand) == cand
    probe = [ord(c) for c in '{z <"nameat'] + [0]
    for piece in ("I will call it now. ", TOOL_OPEN, '{"name": "get_time", "arguments": {}}'):
        if piece == TOOL_OPEN:
            assert lazy.active is None  # dormant through the free text
        for c in piece:
            lazy.accept_token(ord(c))
            zlazy.accept_token(ord(c))
            assert lazy.allowed(probe) == zlazy.allowed(probe)
    assert lazy.active is not None
    assert ord("<") in lazy.allowed([ord("<")])  # the closing tag


def test_make_tool_grammar_forced_or_lazy():
    from zllm_torch.grammar import GrammarSampler
    from zllm_torch.server.toolcall import LazyGrammarSampler, make_tool_grammar

    tok = _ByteTok()
    forced = make_tool_grammar([WEATHER], tok)
    assert isinstance(forced, GrammarSampler)
    assert forced.allowed([ord("<"), ord("H")]) == [ord("<")]
    lazy = make_tool_grammar([WEATHER], tok, lazy=True)
    assert isinstance(lazy, LazyGrammarSampler) and lazy.allowed([ord("H")]) == [ord("H")]
