"""The byte-level BPE tokenizer (`zllm_torch/tokenizer/bpe.py`) against
zllm's `BpeTokenizer`, which compiles the same pretokenizer patterns with
`regex`.

  * the hand-written pretokenizers give zllm's fragments for every ported
    tokenizer.ggml.pre name on a fixed corpus (letters, digit runs of 1-7,
    punctuation runs, contractions in both cases, spaces, tabs, \\r\\n runs,
    trailing whitespace, CJK, emoji, combining marks, U+00A0 and
    U+001C-U+001F) and on a hypothesis property over text;
  * their classes \\s, \\p{L} and \\p{N} agree with `regex` on every code point
    assigned in `unicodedata`'s Unicode 15.0.  `regex` carries newer tables,
    so code points unassigned in 15.0 (some assigned since) are out of scope,
    in the property's alphabet too;
  * the `Tokenizer` facade's ids, decoded text (specials, add_bos from the
    metadata) and `IncrementalDecoder` streams equal zllm's, on the
    factory's synthetic vocab of 3000 merges
    (`zllm_torch.testing.synthetic_bpe_vocab`), and so do the ids of the text
    chip_smoke.py encodes on the card's host (`BPE_ROUNDTRIP_IDS`);
  * `zllm_torch.tokenizer` imports and encodes with `regex` unimportable;
  * any other pre name raises NotImplementedError."""

import subprocess
import sys
import unicodedata
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from zllm_torch.tokenizer.bpe import PRETOKENIZERS

REPO = Path(__file__).resolve().parents[1]
KINDS = {"gpt2": "gpt-2", "llama3": "llama-bpe", "qwen2": "qwen2",
         "starcoder": "starcoder"}  # kind -> a pre name
CORPUS = [
    "", "Hello world", "Hello, World! How are you?",
    "It's we'RE THEY'LL you've I'M he'D it'S x'Ve 'll 'LL ''s '", "don't'll'd", "O'Neil's",
    "1 12 123 1234 12345 123456 1234567", "a1b22c333d4444e55555", " 42 x 7", "v2.0.1-rc3",
    "Hello!!! ...??? (a)[b]{c} --> ==> ;; !!", " !!\n\n", "@@\r\n\r\nx", "-- -- --",
    "a  b   c    d", "   leading", "trailing   ", "tab\tsep\t\tx\t", "\t\tword", " \t x",
    "line\r\nnext\r\n\r\nthird", "a\n\n\nb", "  \n  x", "x \n", "\r\n", "\n \n\t\n  ", "end \t ",
    "中文文本，模型在芯片上运行。", "日本語のテキスト、한국어 텍스트", "🚀🔥 ok 😀! 👍🏽x",
    "e\u0301 cafe\u0301 n\u0303a \u0301\u0301x", "a\u00a0b \u00a0x\u00a0\u00a0", "\u00a0\u00a0word",
    "a\x1cb\x1dc\x1e d\x1f\x1f e \x1c", "\u0663\u0664 \u216b \u00bd \u00b2 x\u00b2y",
    "Stra\u00dfe \u01c5 \u02b0 \u3000x \u180ey \u2028z\u2029", "\u0085\u000b\u000cz",
    "def f(x):\n    return x ** 2  # sq\n", '{"k": [1, 2, 3], "ok": true}',
]
ALPHABET = st.one_of(
    st.sampled_from(list(" \t\r\n\x0b\x0c\x1c\x1f\x85\xa0'sStTrReEvVmMlLdD1234567890.,!?-_"
                         "\u0301\u00bd\u00b2\u0663\u4e2d\U0001F600\u3000\u2028\u01c5")),
    st.characters(exclude_categories=("Cs", "Cn")))


VOCAB_FIELDS = ("model", "pre", "tokens", "scores", "types", "merges", "bos_id", "eos_id",
                "pad_id", "add_bos", "add_space_prefix")


def _tokenizers(pre: str, add_bos: bool = False):
    """zllm's and the port's Tokenizer over the factory's BPE vocab (3000
    merges, 4096 tokens)."""
    from zllm.tokenizer import Tokenizer as ZTokenizer
    from zllm.tokenizer.vocab import Vocab as ZVocab
    from zllm_torch.testing import synthetic_bpe_vocab
    from zllm_torch.tokenizer import Tokenizer

    v = synthetic_bpe_vocab(pre, 4096, add_bos=add_bos)
    return ZTokenizer(ZVocab(**{f: getattr(v, f) for f in VOCAB_FIELDS})), Tokenizer(v)


@pytest.mark.parametrize("pre", sorted(PRETOKENIZERS))
def test_pretokenizer_matches_zllm_on_the_corpus(pre):
    from zllm.tokenizer.bpe import BpeTokenizer as ZBpe
    from zllm.tokenizer.vocab import Vocab as ZVocab
    from zllm_torch.tokenizer.bpe import pretokenize

    ref = ZBpe(ZVocab(model="gpt2", pre=pre, tokens=[], scores=[], types=[]))
    for text in CORPUS:
        assert pretokenize(text, PRETOKENIZERS[pre]) == ref.pretokenize(text), repr(text)


@pytest.mark.parametrize("kind", list(KINDS))
@settings(derandomize=True, max_examples=300, deadline=None, database=None)
@given(text=st.text(alphabet=ALPHABET, max_size=40))
def test_pretokenizer_matches_zllm_on_any_text(kind, text):
    from zllm.tokenizer.bpe import BpeTokenizer as ZBpe
    from zllm.tokenizer.vocab import Vocab as ZVocab
    from zllm_torch.tokenizer.bpe import pretokenize

    ref = ZBpe(ZVocab(model="gpt2", pre=KINDS[kind], tokens=[], scores=[], types=[]))
    assert pretokenize(text, kind) == ref.pretokenize(text)


@pytest.mark.parametrize("cls,pattern", [("S", r"\s"), ("L", r"\p{L}"), ("N", r"\p{N}")])
def test_classes_match_regex_on_every_assigned_code_point(cls, pattern):
    import regex

    from zllm_torch.tokenizer.bpe import char_class

    assert unicodedata.unidata_version == "15.0.0"
    chars = [chr(c) for c in range(0x110000)
             if unicodedata.category(chr(c)) not in ("Cn", "Cs")]
    theirs = set(regex.findall(pattern, "".join(chars)))
    ours = {c for c in chars if char_class(c) == cls}
    assert ours == theirs, sorted(ours ^ theirs)[:20]
    assert len(ours) > (20 if cls == "S" else 1000)


@pytest.mark.parametrize("kind", list(KINDS))
def test_encode_and_decode_match_zllm(kind):
    ztok, tok = _tokenizers(KINDS[kind], add_bos=kind == "llama3")
    for text in CORPUS + ["<|im_start|>user\nhi ünïcödé 😀<|im_end|>\n<|im_start|>assistant\n"]:
        for special in (False, True):
            ids = tok.encode(text, add_special=special, parse_special=special)
            assert ids == ztok.encode(text, add_special=special, parse_special=special), text
            for skip in (True, False):
                assert tok.decode(ids, skip_special=skip) == ztok.decode(ids, skip_special=skip)
            if not special:
                assert tok.decode(ids) == text
    ids = tok.encode("<|im_start|>x<|im_end|>", add_special=True, parse_special=True)
    first = tok.vocab.bos_id
    assert ids == ([first] if kind == "llama3" else []) + [first + 1, *tok.encode("x"), first + 2]
    assert tok.decode(ids, skip_special=False) == "x"  # a CONTROL piece is empty


@pytest.mark.parametrize("kind", list(KINDS))
def test_incremental_decoder_matches_zllm(kind):
    from zllm.tokenizer import IncrementalDecoder as ZInc
    from zllm_torch.tokenizer import IncrementalDecoder

    ztok, tok = _tokenizers(KINDS[kind])
    text = "héllo 中文😀👍🏽 é ok\n" * 2
    ids = tok.encode(text)
    # a multi-byte character split across tokens: some token decodes to
    # part of one
    assert any(len(tok.inner.decode_piece(i).decode("utf-8", errors="ignore"))
               < len(tok.inner.decode_piece(i)) for i in ids if tok.inner.decode_piece(i))
    dec, zdec = IncrementalDecoder(tok), ZInc(ztok)
    stream = [dec.push(i) for i in ids] + [dec.flush()]
    assert stream == [zdec.push(i) for i in ids] + [zdec.flush()]
    assert "".join(stream) == text and "�" not in "".join(stream)


@pytest.mark.parametrize("pre", ["qwen2", "llama-bpe", "gpt-2"])
def test_roundtrip_ids_are_zllms(pre):
    """The ids chip_smoke.py checks on the card's host: zllm's."""
    from zllm_torch.testing import BPE_ROUNDTRIP_IDS, BPE_ROUNDTRIP_TEXT

    ztok, tok = _tokenizers(pre)
    ids = ztok.encode(BPE_ROUNDTRIP_TEXT, add_special=True, parse_special=True)
    assert ids == BPE_ROUNDTRIP_IDS[pre]
    assert tok.encode(BPE_ROUNDTRIP_TEXT, add_special=True, parse_special=True) == ids
    assert tok.decode(ids) == BPE_ROUNDTRIP_TEXT.replace("<|im_start|>", "")


def test_tokenizer_needs_no_regex():
    code = ("import sys; sys.modules['regex'] = None\n"
            "from zllm_torch.testing import BPE_ROUNDTRIP_IDS, BPE_ROUNDTRIP_TEXT, "
            "synthetic_bpe_vocab\n"
            "from zllm_torch.tokenizer import Tokenizer\n"
            "tok = Tokenizer(synthetic_bpe_vocab('qwen2', 4096))\n"
            "ids = tok.encode(BPE_ROUNDTRIP_TEXT, add_special=True, parse_special=True)\n"
            "assert ids == BPE_ROUNDTRIP_IDS['qwen2'] and 'regex' not in "
            "[m for m in sys.modules if sys.modules[m] is not None]\n"
            "print(len(ids))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.strip()) > 0


@pytest.mark.parametrize("pre", ["default", "falcon", "deepseek-llm", "seed-coder", "tekken",
                                 "deepseek-coder", "no-such-pre"])
def test_other_pretokenizers_are_refused(pre):
    from zllm_torch.tokenizer import Tokenizer
    from zllm_torch.tokenizer.vocab import Vocab

    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        Tokenizer(Vocab(model="gpt2", pre=pre, tokens=["a"], scores=[0.0], types=[1]))
