"""The port's copies of zllm's pure-Python grammar and chat modules
(zllm_torch/grammar, zllm_torch/server/chat.py) behave exactly like zllm's:
every builtin chat format renders the same text, the embedded-template
paths agree, and the GBNF / JSON-schema cases of tests/test_grammar.py
parse and accept the same strings and tokens."""

import json
from types import SimpleNamespace

import pytest

from zllm.grammar import GrammarState as ZState
from zllm.grammar import json_schema_to_gbnf as zschema
from zllm.grammar import parse_gbnf as zparse
from zllm.server import chat as zchat
from zllm_torch.grammar import GrammarState, json_schema_to_gbnf, parse_gbnf
from zllm_torch.server import chat

MSGS = [
    {"role": "system", "content": "You are terse."},
    {"role": "user", "content": "Hello there"},
    {"role": "assistant", "content": " Hi! "},
    {"role": "user", "content": "What is 2+2?"},
]


@pytest.mark.parametrize("fmt", sorted(zchat.FORMATS))
def test_every_format_renders_like_zllm(fmt):
    assert sorted(chat.FORMATS) == sorted(zchat.FORMATS)
    for add_ass in (True, False):
        for msgs in (MSGS, MSGS[1:2]):
            want = zchat.apply_chat_template(None, msgs, fmt=fmt, add_assistant=add_ass)
            got = chat.apply_chat_template(None, msgs, fmt=fmt, add_assistant=add_ass)
            assert got == want


@pytest.mark.parametrize("template,arch", [
    ("", "llama"), ("{{ '<|im_start|>' }}", "llama"), ("[INST] x", "llama"),
    ("<|im_start|><|im_sep|>", "llama"), ("", "gpt-oss"),
    ("{% for m in messages %}<{{ m.role }}>{{ m.content }}{% endfor %}"
     "{% if add_generation_prompt %}<assistant>{% endif %}", "llama"),
], ids=["none", "chatml", "mistral", "phi4", "arch", "jinja"])
def test_detection_and_jinja_like_zllm(template, arch):
    from zllm_torch.tokenizer import Tokenizer
    from zllm_torch.tokenizer.vocab import Vocab

    tokens = ["<unk>", "<s>", "</s>", "a"]
    vocab = Vocab(model="llama", pre="default", tokens=tokens, scores=[0.0] * 4,
                  types=[2, 3, 3, 1], bos_id=1, eos_id=2, unk_id=0, chat_template=template)
    model = SimpleNamespace(cfg=SimpleNamespace(arch=arch), tokenizer=Tokenizer(vocab),
                            chat_template=template)
    assert chat.detect_format(model) == zchat.detect_format(model)
    for jinja in (False, True):
        want = zchat.apply_chat_template(model, MSGS, jinja=jinja)
        assert chat.apply_chat_template(model, MSGS, jinja=jinja) == want


def test_model_chat_template_property(tmp_path):
    from zllm.gguf.constants import GGMLType
    from zllm_torch.models.loader import Model
    from zllm_torch.testing import make_llama_gguf

    path = make_llama_gguf(str(tmp_path / "m.gguf"), n_layers=1, n_embd=64, n_heads=2,
                           n_kv_heads=1, n_ff=64, vocab_size=260, gtype=GGMLType.F32,
                           with_tokenizer=True)
    m = Model.load(path, device="cpu")
    assert m.chat_template == ""
    m.tokenizer.vocab.chat_template = "<|im_start|>"
    assert m.chat_template == "<|im_start|>" and chat.detect_format(m) == "chatml"
    m.tokenizer = None
    assert m.chat_template == ""


JSON_GRAMMAR = (
    'root ::= object\n'
    'object ::= "{" ( string ":" value ("," string ":" value)* )? "}"\n'
    'value ::= object | string | number\n'
    'string ::= "\\"" [a-z]* "\\""\n'
    'number ::= [0-9]+\n'
)
GBNF_CASES = {
    "literal_alternates": ('root ::= "yes" | "no"\n', ["yes", "no", "maybe", "ye"]),
    "classes_repetition": ('root ::= [a-z]+ "-" [0-9]*\n', ["abc-123", "x-", "-1", "ABC-1"]),
    "recursion": ('root ::= expr\nexpr ::= term (("+" | "-") term)*\n'
                  'term ::= [0-9]+ | "(" expr ")"\n', ["1+2-3", "(1+2)-3", "((7))", "1+", "(1"]),
    "bounded_repeat": ('root ::= "a"? "b"{2,3}\n', ["bb", "abbb", "b", "abbbb"]),
    "negated_class": ('root ::= "\\"" [^"]* "\\""\n', ['"hello"', '"a"b"']),
    "partial_prefix": ('root ::= "hello"\n', ["hel", "hello"]),
    "json_like": (JSON_GRAMMAR, ["{}", '{"a":1}', '{"a":{"b":22},"c":3}', '{"a":}']),
}
SCHEMA_CASES = {
    "object": ({"type": "object",
                "properties": {"name": {"type": "string"}, "age": {"type": "integer"}},
                "required": ["name", "age"]},
               ['{"name": "bob", "age": 42}', '{"name": "x", "age": -1}', '{"age": 42}',
                '{"name": 3, "age": 42}']),
    "enum_array": ({"type": "object",
                    "properties": {"color": {"enum": ["red", "green"]},
                                   "nums": {"type": "array", "items": {"type": "integer"},
                                            "minItems": 1}},
                    "required": ["color", "nums"]},
                   ['{"color": "red", "nums": [1, 2]}', '{"color": "blue", "nums": [1]}',
                    '{"color": "red", "nums": []}']),
}


def _accepts(state_cls, g, text: str):
    """(accepted prefix length, can stop) of one string."""
    st = state_cls(g)
    for i, ch in enumerate(text):
        if not st.accept(ord(ch)):
            return i, False
    return len(text), st.can_stop


@pytest.mark.parametrize("case", sorted(GBNF_CASES) + sorted(SCHEMA_CASES))
def test_grammar_cases_like_zllm(case):
    if case in GBNF_CASES:
        src, inputs = GBNF_CASES[case]
        zsrc = tsrc = src
    else:
        schema, inputs = SCHEMA_CASES[case]
        zsrc, tsrc = zschema(schema), json_schema_to_gbnf(json.loads(json.dumps(schema)))
        assert tsrc == zsrc
    zg, tg = zparse(zsrc), parse_gbnf(tsrc)
    results = [_accepts(GrammarState, tg, s) for s in inputs]
    assert results == [_accepts(ZState, zg, s) for s in inputs]
    assert any(stop for _, stop in results) and not all(stop for _, stop in results)


def test_grammar_sampler_like_zllm():
    from zllm.grammar.gbnf import GrammarSampler as ZSampler
    from zllm.tokenizer import Tokenizer as ZTokenizer
    from zllm.tokenizer.vocab import Vocab as ZVocab
    from zllm_torch.grammar import GrammarSampler
    from zllm_torch.tokenizer import Tokenizer
    from zllm_torch.tokenizer.vocab import Vocab

    tokens = ["<unk>", "<s>", "</s>", "yes", "no", "maybe", "y", "es"]
    kw = dict(model="llama", pre="default", tokens=tokens, scores=[0.0] * len(tokens),
              types=[2, 3, 3] + [1] * 5, bos_id=1, eos_id=2, unk_id=0, add_bos=False,
              add_space_prefix=False)
    src = 'root ::= "yes" | "no"\n'
    zs = ZSampler(zparse(src), ZTokenizer(ZVocab(**kw)))
    ts = GrammarSampler(parse_gbnf(src), Tokenizer(Vocab(**kw)))
    for tok in (6, 7):  # "y", "es"
        assert ts.allowed(range(len(tokens))) == zs.allowed(range(len(tokens)))
        zs.accept_token(tok)
        ts.accept_token(tok)
    assert ts.allowed(range(len(tokens))) == zs.allowed(range(len(tokens))) == [2]
