"""GBNF grammars and the JSON-schema compiler (the port's copy of
`zllm/grammar/`)."""

from .gbnf import Grammar, GrammarSampler, GrammarState, parse_gbnf
from .json_schema import json_schema_to_gbnf
