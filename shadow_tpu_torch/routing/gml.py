"""Minimal GML (Graph Modelling Language) parser — igraph-free.

Parses the subset the reference's network graphs use
(docs/network_graph_spec.md): a ``graph [ ... ]`` block with ``directed``,
``node [ id ... ]`` and ``edge [ source target ... ]`` sub-blocks, and
string/int/float attribute values. Nested blocks are handled generically.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any


class GmlParseError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    \s*(
        \#[^\n]*                   # comment to end of line (outside strings)
      | \[ | \]
      | "(?:[^"\\]|\\.)*"          # quoted string (may contain '#')
      | [^\s\[\]"]+                # bare word / number
    )
    """,
    re.VERBOSE,
)


def _tokenize(text: str):
    # Comments are recognized at token boundaries only, so a '#' inside a
    # quoted string attribute value is preserved.
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip():
                raise GmlParseError(f"bad token at offset {pos}: {text[pos:pos+20]!r}")
            return
        if not m.group(1).startswith("#"):
            yield m.group(1)
        pos = m.end()


def _coerce(tok: str) -> Any:
    if tok.startswith('"'):
        return tok[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _parse_block(tokens, top_level: bool = False) -> dict:
    """Parse key/value pairs until a closing ']' (or EOF at top level).
    Repeated keys (node, edge) accumulate into lists."""
    out: dict[str, Any] = {}
    for tok in tokens:
        if tok == "]":
            if top_level:
                raise GmlParseError("unbalanced ']'")
            return out
        if tok == "[":
            raise GmlParseError("unexpected '['")
        key = tok
        try:
            val_tok = next(tokens)
        except StopIteration:
            raise GmlParseError(f"missing value for key {key!r}") from None
        value = _parse_block(tokens) if val_tok == "[" else _coerce(val_tok)
        if key in out:
            if not isinstance(out[key], list):
                out[key] = [out[key]]
            out[key].append(value)
        else:
            out[key] = value
    if not top_level:
        raise GmlParseError("unexpected end of input: unclosed '[' block")
    return out


@dataclasses.dataclass
class GmlGraph:
    directed: bool
    nodes: list[dict]  # each has at least "id"
    edges: list[dict]  # each has at least "source", "target"
    attrs: dict


def parse_gml(text: str) -> GmlGraph:
    tokens = _tokenize(text)
    top = _parse_block(tokens, top_level=True)
    if "graph" not in top:
        raise GmlParseError("no `graph [ ... ]` block found")
    g = top["graph"]
    if isinstance(g, list):
        raise GmlParseError("multiple graph blocks")
    nodes = g.get("node", [])
    edges = g.get("edge", [])
    if isinstance(nodes, dict):
        nodes = [nodes]
    if isinstance(edges, dict):
        edges = [edges]
    for n in nodes:
        if "id" not in n:
            raise GmlParseError("node missing id")
    for e in edges:
        if "source" not in e or "target" not in e:
            raise GmlParseError("edge missing source/target")
    attrs = {k: v for k, v in g.items() if k not in ("node", "edge")}
    return GmlGraph(
        directed=bool(g.get("directed", 0)),
        nodes=nodes,
        edges=edges,
        attrs=attrs,
    )
