"""A small generic GML (Graph Modelling Language) parser.

The port's own copy of `shadow_tpu/net/gml.py` (the port imports nothing
of the JAX package). The grammar: a `graph [...]` block containing scalar key/value pairs and repeated
`node [...]` / `edge [...]` sub-blocks. Values are integers, floats, quoted
strings, or nested `[ ... ]` lists.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Union


class GmlError(ValueError):
    pass


_TOKEN = re.compile(
    r"""
    \s*(?:
      (?P<comment>\#[^\n]*)
    | (?P<lbracket>\[)
    | (?P<rbracket>\])
    | (?P<string>"(?:[^"\\]|\\.)*")
    | (?P<number>[+-]?(?:\d+\.\d*(?:[eE][+-]?\d+)?|\.?\d+(?:[eE][+-]?\d+)?|(?:nan|inf)\b))
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    )
    """,
    re.VERBOSE,
)


def _tokenize(text: str):
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                return
            raise GmlError(f"unexpected character at offset {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "comment":
            continue
        yield kind, m.group(kind)
    return


@dataclass
class GmlList:
    """An ordered multimap: GML allows repeated keys (every `node [...]`)."""

    items: list[tuple[str, Any]] = field(default_factory=list)

    def get(self, key: str, default=None):
        for k, v in self.items:
            if k == key:
                return v
        return default

    def get_all(self, key: str) -> list:
        return [v for k, v in self.items if k == key]

    def count(self, key: str) -> int:
        return sum(1 for k, _ in self.items if k == key)


Value = Union[int, float, str, GmlList]


def _parse_list(tokens) -> GmlList:
    out = GmlList()
    while True:
        try:
            kind, text = next(tokens)
        except StopIteration:
            return out
        if kind == "rbracket":
            return out
        if kind != "ident":
            raise GmlError(f"expected key, got {text!r}")
        key = text
        try:
            vkind, vtext = next(tokens)
        except StopIteration:
            raise GmlError(f"key {key!r} has no value") from None
        if vkind == "lbracket":
            value: Value = _parse_list(tokens)
        elif vkind == "string":
            value = vtext[1:-1].replace('\\"', '"').replace("\\\\", "\\")
        elif vkind == "number":
            if re.fullmatch(r"[+-]?\d+", vtext):
                value = int(vtext)
            else:
                value = float(vtext)
        else:
            raise GmlError(f"bad value for key {key!r}: {vtext!r}")
        out.items.append((key, value))


def parse(text: str) -> GmlList:
    """Parse GML text, returning the contents of the top-level `graph [...]`."""
    tokens = _tokenize(text)
    top = _parse_list(tokens)
    graph = top.get("graph")
    if not isinstance(graph, GmlList):
        raise GmlError("no top-level 'graph [...]' block")
    return graph
