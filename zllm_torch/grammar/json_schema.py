"""JSON-schema -> GBNF compiler.

The counterpart of the reference's common/json-schema-to-grammar.cpp:
turns a JSON schema into a GBNF grammar whose language is exactly the
schema-conforming JSON documents (supported: object/properties/required/
additionalProperties=false, array/items/min-maxItems, string (enum,
const), number/integer/boolean/null, anyOf/oneOf, $defs/$ref).

The port's own copy of `zllm/grammar/json_schema.py` (pure Python, the
same behaviour).
"""

from __future__ import annotations

import json
import re

_PRIMITIVES = {
    "space": r'( " " | "\n" )?',
    "string": r'"\"" char* "\"" space',
    "char": r'[^"\\\x00-\x1f] | "\\" (["\\bfnrt/] | "u" [0-9a-fA-F]{4})',
    "number": r'"-"? ("0" | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? space',
    "integer": r'"-"? ("0" | [1-9] [0-9]*) space',
    "boolean": r'("true" | "false") space',
    "null": r'"null" space',
    "value": r"object | array | string | number | boolean | null",
    "object": r'"{" space ( member ("," space member)* )? "}" space',
    "member": r'string ":" space value',
    "array": r'"[" space ( value ("," space value)* )? "]" space',
}


def _lit(s: str) -> str:
    return json.dumps(s)


class _Compiler:
    def __init__(self, schema: dict):
        self.schema = schema
        self.rules: dict[str, str] = {"space": _PRIMITIVES["space"]}
        self._n = 0

    def _add(self, name: str, body: str) -> str:
        base = re.sub(r"[^a-zA-Z0-9-]+", "-", name) or "rule"
        key = base
        while key in self.rules and self.rules[key] != body:
            self._n += 1
            key = f"{base}{self._n}"
        self.rules[key] = body
        return key

    def _prim(self, name: str) -> str:
        for dep in {"string": ["char"], "value": ["object", "array", "string", "number", "boolean", "null", "member", "char"],
                    "object": ["member", "string", "value"], "array": ["value"]}.get(name, []):
            if dep not in self.rules:
                self.rules[dep] = _PRIMITIVES[dep]
                self._prim(dep)  # transitive deps
        self.rules.setdefault(name, _PRIMITIVES[name])
        return name

    def visit(self, schema: dict, name: str) -> str:
        if "$ref" in schema:
            ref = schema["$ref"]
            target = self.schema
            for part in ref.lstrip("#/").split("/"):
                target = target[part]
            return self.visit(target, name + "-ref")
        if "const" in schema:
            return self._add(name, f"{_lit(json.dumps(schema['const']))} space")
        if "enum" in schema:
            alts = " | ".join(_lit(json.dumps(v)) for v in schema["enum"])
            return self._add(name, f"({alts}) space")
        for comb in ("anyOf", "oneOf"):
            if comb in schema:
                subs = [self.visit(s, f"{name}-{i}") for i, s in enumerate(schema[comb])]
                return self._add(name, " | ".join(subs))

        t = schema.get("type")
        if isinstance(t, list):
            subs = [self.visit({**schema, "type": ti}, f"{name}-{ti}") for ti in t]
            return self._add(name, " | ".join(subs))
        if t == "object" or (t is None and "properties" in schema):
            return self._object(schema, name)
        if t == "array":
            item = self.visit(schema.get("items", {}), name + "-item") if "items" in schema else self._prim("value")
            mn = int(schema.get("minItems", 0))
            mx = schema.get("maxItems")
            rep = f'("," space {item})*' if mx is None else f'("," space {item}){{{max(mn - 1, 0)},{int(mx) - 1}}}'
            if mn == 0:
                body = f'"[" space ( {item} {rep} )? "]" space'
            else:
                body = f'"[" space {item} {rep} "]" space'
            return self._add(name, body)
        if t == "string":
            return self._prim("string") if name == "string" else self._add(name, self._prim("string"))
        if t in ("number", "integer", "boolean", "null"):
            return self._prim(t)
        return self._prim("value")

    def _object(self, schema: dict, name: str) -> str:
        props = schema.get("properties", {})
        required = set(schema.get("required", props.keys()))
        parts = []
        for key, sub in props.items():
            rule = self.visit(sub, f"{name}-{key}")
            kv = f'{_lit(json.dumps(key))} space ":" space {rule}'
            parts.append((key, kv, key in required))
        if not parts:
            return self._prim("object")
        # fixed order (like the reference's generated grammars)
        seq = []
        first = True
        for _, kv, req in parts:
            piece = kv if first else f'"," space {kv}'
            if not req:
                piece = f"({piece})?"
            seq.append(piece)
            first = False
        body = '"{" space ' + " ".join(seq) + ' "}" space'
        return self._add(name, body)


def json_schema_to_gbnf(schema: dict | str) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    c = _Compiler(schema)
    root = c.visit(schema, "root0")
    lines = [f"root ::= {root} space" if root != "root" else ""]
    lines = [f"root ::= {root}"]
    for name, body in c.rules.items():
        lines.append(f"{name} ::= {body}")
    return "\n".join(lines) + "\n"
