"""Neutral serialized host-plan format (port of ``auron_tpu/convert/hostplan.py``).

A host-engine shim (Spark/Flink) serializes its fully-optimized physical
plan into this JSON-able tree; the conversion layer consumes it. Shape:

    {"op": "ProjectExec",
     "schema": [["name", "long", true], ...],       # output schema
     "args": {"projections": [<expr>, ...], ...},   # op-specific payload
     "children": [<node>, ...]}

Expressions are dicts: {"kind": "attr", "index": i} bound references,
{"kind": "lit", "value": v, "type": t}, and {"kind": "call",
"name": <spark-expression-name>, "children": [...], ...}.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from auron_tpu_torch import types as T

_SIMPLE = {
    "boolean": T.BOOL, "byte": T.INT8, "tinyint": T.INT8, "short": T.INT16,
    "smallint": T.INT16, "int": T.INT32, "integer": T.INT32, "long": T.INT64,
    "bigint": T.INT64, "float": T.FLOAT32, "double": T.FLOAT64, "string": T.STRING,
    "binary": T.BINARY, "date": T.DATE32, "timestamp": T.TIMESTAMP, "null": T.NULL,
}


def parse_type(s: str) -> T.DataType:
    raw = s.strip()  # struct field names are case-sensitive
    s = raw.lower()
    if s in _SIMPLE:
        return _SIMPLE[s]
    if s.startswith("decimal"):
        if "(" in s:
            p, sc = s[s.index("(") + 1 : s.index(")")].split(",")
            return T.decimal(int(p), int(sc))
        return T.decimal(10, 0)
    if s.startswith("array<") and s.endswith(">"):
        return T.DataType(T.TypeKind.LIST, inner=(parse_type(raw[6:-1]),))
    if s.startswith("map<") and s.endswith(">"):
        parts = _split_top(raw[4:-1])
        if len(parts) != 2:
            raise ValueError(f"unsupported host type {s!r}")
        k, v = parts
        return T.DataType(T.TypeKind.MAP, inner=(parse_type(k), parse_type(v)))
    if s.startswith("struct<") and s.endswith(">"):
        names, inners = [], []
        for part in _split_top(raw[7:-1]):
            name, _, t = part.partition(":")
            names.append(name.strip())
            inners.append(parse_type(t))
        return T.DataType(T.TypeKind.STRUCT, inner=tuple(inners), struct_names=tuple(names))
    raise ValueError(f"unsupported host type {s!r}")


def _split_top(s: str) -> list[str]:
    """Split on commas at bracket/paren depth 0
    (struct<a:decimal(10,2),b:map<int,int>>)."""
    out, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append(s[start:i])
            start = i + 1
    out.append(s[start:])
    return [p.strip() for p in out]


@dataclass
class HostNode:
    """One operator of the host engine's physical plan."""

    op: str  # host exec class name, e.g. "ProjectExec"
    schema: T.Schema  # output schema
    args: dict = field(default_factory=dict)
    children: list["HostNode"] = field(default_factory=list)
    # set when the declared schema holds a type the engine cannot represent:
    # only this node becomes NeverConvert, sibling subtrees stay convertible
    schema_error: str | None = None

    @staticmethod
    def from_json(data: dict | str) -> "HostNode":
        if isinstance(data, str):
            data = json.loads(data)
        fields = []
        schema_error = None
        for name, t, nullable in data.get("schema", []):
            try:
                dtype = parse_type(t)
            except ValueError as e:
                # an UNSUPPORTED placeholder: the owning node degrades, and a
                # parent binding this column fails its own trial conversion
                dtype = T.DataType(T.TypeKind.UNSUPPORTED)
                if schema_error is None:
                    schema_error = str(e)
            fields.append(T.Field(name, dtype, bool(nullable)))
        return HostNode(
            op=data["op"],
            schema=T.Schema(tuple(fields)),
            args=data.get("args", {}),
            children=[HostNode.from_json(c) for c in data.get("children", [])],
            schema_error=schema_error,
        )

    def walk_up(self):
        """Post-order (children first): the tagging order."""
        for c in self.children:
            yield from c.walk_up()
        yield self

    def walk_down(self):
        yield self
        for c in self.children:
            yield from c.walk_down()
