"""GBNF grammar engine: parser + pushdown automaton + logit masking.

The counterpart of the reference's grammar subsystem (reference:
src/llama-grammar.cpp — GBNF parser llama_grammar_parser, stack-advance
accept_impl / candidate rejection apply_impl).  Grammars constrain
sampling: after each token the automaton advances over the token's
codepoints; before sampling, tokens whose text cannot continue any parse
stack are masked out.

Grammar format (GBNF, grammars/*.gbnf in the reference):
  root ::= "yes" | "no"
  expr ::= term ([-+*/] term)*
with char classes [a-z0-9], negation [^"], literals "...", repetition
* + ? {m,n}, grouping ( ... ), alternation |.

The port's own copy of `zllm/grammar/gbnf.py` (pure Python, the same
behaviour), so that zllm_torch imports nothing of zllm.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# element kinds
CHAR = "char"  # matches a set of codepoint ranges
REF = "ref"  # rule reference
END = object()


@dataclass(frozen=True)
class CharSet:
    ranges: tuple[tuple[int, int], ...]  # inclusive
    negated: bool = False

    def matches(self, cp: int) -> bool:
        hit = any(lo <= cp <= hi for lo, hi in self.ranges)
        return (not hit) if self.negated else hit


@dataclass
class Grammar:
    rules: dict[str, list[list]]  # name -> alternatives -> [elements]
    root: str = "root"


class GBNFParser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rules: dict[str, list[list]] = {}
        self._aux = 0

    # -- lexing helpers -----------------------------------------------------
    def _ws(self):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":  # comment
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t\r\n":
                self.pos += 1
            else:
                break

    def _ws_inline(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def _peek(self):
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _name(self) -> str:
        start = self.pos
        while self.pos < len(self.text) and (self.text[self.pos].isalnum() or self.text[self.pos] in "-_"):
            self.pos += 1
        if start == self.pos:
            raise ValueError(f"expected rule name at {start}: {self.text[start:start+20]!r}")
        return self.text[start : self.pos]

    def _escape(self) -> int:
        c = self.text[self.pos]
        self.pos += 1
        if c != "\\":
            return ord(c)
        e = self.text[self.pos]
        self.pos += 1
        simple = {"n": 10, "t": 9, "r": 13, '"': 34, "\\": 92, "/": 47, "'": 39, "]": 93, "[": 91, "^": 94, "-": 45}
        if e in simple:
            return simple[e]
        if e == "x":
            v = int(self.text[self.pos : self.pos + 2], 16)
            self.pos += 2
            return v
        if e == "u":
            v = int(self.text[self.pos : self.pos + 4], 16)
            self.pos += 4
            return v
        if e == "U":
            v = int(self.text[self.pos : self.pos + 8], 16)
            self.pos += 8
            return v
        raise ValueError(f"bad escape \\{e}")

    # -- grammar productions ------------------------------------------------
    def parse(self) -> Grammar:
        self._ws()
        while self.pos < len(self.text):
            name = self._name()
            self._ws_inline()
            if self.text[self.pos : self.pos + 3] != "::=":
                raise ValueError(f"expected ::= after {name}")
            self.pos += 3
            self.rules[name] = self._alternates(name)
            self._ws()
        if "root" not in self.rules:
            raise ValueError("grammar has no root rule")
        return Grammar(rules=self.rules)

    def _alternates(self, name: str) -> list[list]:
        alts = [self._sequence(name)]
        while True:
            self._ws_inline()
            # newline ends the rule unless the next non-ws char is '|'
            save = self.pos
            self._ws()
            if self._peek() == "|":
                self.pos += 1
                alts.append(self._sequence(name))
            else:
                self.pos = save
                self._ws_inline()
                if self._peek() == "|":
                    self.pos += 1
                    alts.append(self._sequence(name))
                else:
                    break
        return alts

    def _sequence(self, name: str) -> list:
        seq: list = []
        while True:
            self._ws_inline()
            c = self._peek()
            if c == '"':
                self.pos += 1
                while self._peek() != '"':
                    cp = self._escape()
                    seq.append((CHAR, CharSet(((cp, cp),))))
                self.pos += 1
            elif c == "[":
                self.pos += 1
                negated = False
                if self._peek() == "^":
                    negated = True
                    self.pos += 1
                ranges = []
                while self._peek() != "]":
                    lo = self._escape()
                    if self._peek() == "-" and self.text[self.pos + 1] != "]":
                        self.pos += 1
                        hi = self._escape()
                    else:
                        hi = lo
                    ranges.append((lo, hi))
                self.pos += 1
                seq.append((CHAR, CharSet(tuple(ranges), negated)))
            elif c == "(":
                self.pos += 1
                aux = self._aux_rule(name, self._alternates(name))
                self._ws()
                if self._peek() != ")":
                    raise ValueError("expected )")
                self.pos += 1
                seq.append((REF, aux))
            elif c.isalpha() or c == "_":
                seq.append((REF, self._name()))
            elif c == ".":
                self.pos += 1
                seq.append((CHAR, CharSet(((0, 0x10FFFF),))))
            else:
                break
            # repetition suffix
            self._ws_inline()
            r = self._peek()
            if r in "*+?" or r == "{":
                last = seq.pop()
                seq.append(self._repeat(name, last, r))
        return seq

    def _aux_rule(self, base: str, alts: list[list]) -> str:
        self._aux += 1
        name = f"{base}__{self._aux}"
        self.rules[name] = alts
        return name

    def _repeat(self, base: str, elem, kind: str):
        if kind == "{":
            self.pos += 1
            start = self.pos
            while self._peek() not in ",}":
                self.pos += 1
            mn = int(self.text[start : self.pos] or 0)
            mx = None
            if self._peek() == ",":
                self.pos += 1
                start = self.pos
                while self._peek() != "}":
                    self.pos += 1
                tail = self.text[start : self.pos]
                mx = int(tail) if tail else None
            else:
                mx = mn
            self.pos += 1
            alts = []
            if mx is None:
                star = self._aux_rule(base, [])
                self.rules[star] = [[elem, (REF, star)], []]
                alts = [[elem] * mn + [(REF, star)]]
            else:
                for n in range(mn, mx + 1):
                    alts.append([elem] * n)
            return (REF, self._aux_rule(base, alts))
        self.pos += 1
        if kind == "?":
            return (REF, self._aux_rule(base, [[elem], []]))
        rec = self._aux_rule(base, [])
        self.rules[rec] = [[elem, (REF, rec)], []]
        if kind == "*":
            return (REF, rec)
        # '+': one then star
        return (REF, self._aux_rule(base, [[elem, (REF, rec)]]))


def parse_gbnf(text: str) -> Grammar:
    return GBNFParser(text).parse()


# ---------------------------------------------------------------------------
# pushdown automaton
# ---------------------------------------------------------------------------

class GrammarState:
    """A set of parse stacks; each stack is a tuple of (rule, alt, idx)
    continuations with the innermost frame last."""

    def __init__(self, grammar: Grammar):
        self.g = grammar
        init = ((grammar.root, 0, 0),)
        self.stacks: set = set()
        for alt in range(len(grammar.rules[grammar.root])):
            self._expand(((grammar.root, alt, 0),), self.stacks, set())

    # expand until top frame faces a CHAR (or the stack completes)
    def _expand(self, stack, out: set, seen: set):
        if stack in seen:
            return
        seen.add(stack)
        if not stack:
            out.add(stack)
            return
        rule, alt, idx = stack[-1]
        seq = self.g.rules[rule][alt]
        if idx >= len(seq):
            self._expand(stack[:-1], out, seen)
            return
        kind, arg = seq[idx]
        if kind == CHAR:
            out.add(stack)
        else:  # REF
            below = stack[:-1] + ((rule, alt, idx + 1),)
            for a in range(len(self.g.rules[arg])):
                self._expand(below + ((arg, a, 0),), out, seen)

    def accept(self, cp: int) -> bool:
        """Advance all stacks over a codepoint; False if none survive."""
        nxt: set = set()
        seen: set = set()
        for stack in self.stacks:
            if not stack:
                continue
            rule, alt, idx = stack[-1]
            seq = self.g.rules[rule][alt]
            kind, cs = seq[idx]
            if kind == CHAR and cs.matches(cp):
                self._expand(stack[:-1] + ((rule, alt, idx + 1),), nxt, seen)
        if not nxt:
            return False
        self.stacks = nxt
        return True

    def accepts_text(self, text: str) -> bool:
        probe = self.clone()
        return all(probe.accept(ord(c)) for c in text)

    @property
    def can_stop(self) -> bool:
        return any(len(s) == 0 for s in self.stacks)

    def clone(self) -> "GrammarState":
        c = GrammarState.__new__(GrammarState)
        c.g = self.g
        c.stacks = set(self.stacks)
        return c


class GrammarSampler:
    """Vocab-level grammar constraint (reference llama_sampler_init_grammar):
    masks tokens whose text can't extend the parse; EOS allowed only when a
    stack has completed."""

    def __init__(self, grammar: Grammar, tokenizer):
        self.state = GrammarState(grammar)
        self.tok = tokenizer
        self._piece_cache: dict[int, str] = {}

    def _piece(self, tid: int) -> str:
        if tid not in self._piece_cache:
            self._piece_cache[tid] = self.tok.decode([tid], skip_special=False)
        return self._piece_cache[tid]

    def allowed(self, candidate_ids) -> list[int]:
        out = []
        eos = self.tok.eos_id
        for tid in candidate_ids:
            tid = int(tid)
            if tid == eos:
                if self.state.can_stop:
                    out.append(tid)
                continue
            piece = self._piece(tid)
            if piece and self.state.accepts_text(piece):
                out.append(tid)
        return out

    def accept_token(self, tid: int):
        if tid == self.tok.eos_id:
            return
        for c in self._piece(int(tid)):
            if not self.state.accept(ord(c)):
                raise ValueError(f"token {tid} ({self._piece(int(tid))!r}) violates grammar")
