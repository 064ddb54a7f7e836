"""Logical SQL AST.

Frozen dataclasses produced by the parser (sql/parser.py) and consumed by
the binder (sql/binder.py). Source positions ride along on every node but
are EXCLUDED from equality (``compare=False``): two parses of equivalent
text — including the canonical text :func:`to_sql` regenerates — compare
equal node-for-node. That property is load-bearing: the grammar fuzz gate
(tests/test_sql_fuzz.py) asserts ``parse(to_sql(parse(q))) == parse(q)``
for generated queries, which pins both the parser and the renderer.

Copied from ``auron_tpu/sql/sqlast.py``; only the imports differ.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

from auron_tpu_torch.sql.diagnostics import NO_POS, SourcePos


def _pos_field():
    return field(default=NO_POS, compare=False, repr=False)


class Node:
    pass


class Expr(Node):
    pass


# -- expressions -------------------------------------------------------------


@dataclass(frozen=True)
class Ident(Expr):
    """Possibly-qualified column reference: ``d_year`` / ``dt.d_year``."""

    parts: tuple[str, ...]
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class NumberLit(Expr):
    """Numeric literal, kept as written (the binder types it: int32/int64
    when it parses as an integer, float64 for '.'-form and exponent form —
    the catalog has no decimal columns, see binder._bind_NumberLit)."""

    text: str
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class StringLit(Expr):
    value: str
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class DateLit(Expr):
    """DATE 'yyyy-mm-dd'."""

    value: str
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class IntervalLit(Expr):
    """INTERVAL '30' DAY, or the bare TPC-DS form ``+ 30 days``."""

    n: int
    unit: str  # "day" only (the corpus needs no more)
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class NullLit(Expr):
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class TypeName(Node):
    """Type in a CAST: name + optional params (decimal(7,2))."""

    name: str
    params: tuple[int, ...] = ()
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    to: TypeName
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class FuncCall(Expr):
    """Function or aggregate call. ``star`` marks count(*)."""

    name: str  # lowercase
    args: tuple[Expr, ...] = ()
    distinct: bool = False
    star: bool = False
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # or|and|=|<>|<|<=|>|>=|+|-|*|/
    left: Expr
    right: Expr
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # -|+|not
    operand: Expr
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class IsNullPred(Expr):
    expr: Expr
    negated: bool = False
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    lo: Expr
    hi: Expr
    negated: bool = False
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    items: tuple[Expr, ...]
    negated: bool = False
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class InSubquery(Expr):
    expr: Expr
    query: "Query"
    negated: bool = False
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class LikePred(Expr):
    expr: Expr
    pattern: str
    negated: bool = False
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class CaseExpr(Expr):
    """Searched CASE (operand=None) or simple CASE."""

    operand: Optional[Expr]
    whens: tuple[tuple[Expr, Expr], ...]
    orelse: Optional[Expr] = None
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class ScalarSubquery(Expr):
    """(SELECT ...) in expression position — parsed, rejected by the
    binder (out of subset) so the diagnostic carries a real position."""

    query: "Query"
    pos: SourcePos = _pos_field()


# -- relations ---------------------------------------------------------------


@dataclass(frozen=True)
class TableName(Node):
    name: str
    alias: Optional[str] = None
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class DerivedTable(Node):
    query: "Query"
    alias: str = ""
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class Join(Node):
    left: "TableRef"
    right: "TableRef"
    kind: str  # inner|left
    on: Expr
    pos: SourcePos = _pos_field()


TableRef = Union[TableName, DerivedTable, Join]


# -- statements --------------------------------------------------------------


@dataclass(frozen=True)
class SelectItem(Node):
    expr: Expr
    alias: Optional[str] = None
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class OrderItem(Node):
    expr: Expr
    asc: bool = True
    nulls_first: Optional[bool] = None  # None = dialect default
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class Select(Node):
    items: tuple[SelectItem, ...]
    from_: tuple[TableRef, ...] = ()
    where: Optional[Expr] = None
    group_by: tuple[Expr, ...] = ()
    having: Optional[Expr] = None
    distinct: bool = False
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class UnionAll(Node):
    branches: tuple[Select, ...]
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class Cte(Node):
    name: str
    body: Union[Select, UnionAll]
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class Query(Node):
    """Full statement: WITH list, body, ORDER BY / LIMIT at the top."""

    body: Union[Select, UnionAll]
    ctes: tuple[Cte, ...] = ()
    order_by: tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    pos: SourcePos = _pos_field()


# -- streaming DDL (auron_tpu/stream) ----------------------------------------


@dataclass(frozen=True)
class Watermark(Node):
    """WATERMARK FOR <col> AS <col> - INTERVAL '<n>' <unit>: event time
    advances to max(observed <col>) - delay; windows whose end falls at
    or before the watermark close and emit."""

    col: Ident
    delay: IntervalLit
    pos: SourcePos = _pos_field()


@dataclass(frozen=True)
class StreamingView(Node):
    """CREATE STREAMING VIEW <name> [WATERMARK ...] AS <query> — the
    continuous-query statement the stream subsystem compiles
    (stream/lowering.py); the inner query is ordinary AST, with
    TUMBLE/HOP window calls in its GROUP BY."""

    name: str
    watermark: Optional[Watermark]
    query: Query
    pos: SourcePos = _pos_field()


# ---------------------------------------------------------------------------
# canonical rendering (the fuzz round-trip's second leg)
# ---------------------------------------------------------------------------


def to_sql(node: Node) -> str:
    return _r(node)


def _r(n: Node) -> str:
    if isinstance(n, Ident):
        return ".".join(n.parts)
    if isinstance(n, NumberLit):
        return n.text
    if isinstance(n, StringLit):
        return "'" + n.value.replace("'", "''") + "'"
    if isinstance(n, DateLit):
        return f"date '{n.value}'"
    if isinstance(n, IntervalLit):
        return f"interval '{n.n}' day"
    if isinstance(n, NullLit):
        return "null"
    if isinstance(n, TypeName):
        return n.name + (f"({', '.join(map(str, n.params))})" if n.params else "")
    if isinstance(n, Cast):
        return f"cast({_r(n.expr)} as {_r(n.to)})"
    if isinstance(n, FuncCall):
        if n.star:
            return f"{n.name}(*)"
        inner = ", ".join(_r(a) for a in n.args)
        return f"{n.name}({'distinct ' if n.distinct else ''}{inner})"
    if isinstance(n, BinOp):
        return f"({_r(n.left)} {n.op} {_r(n.right)})"
    if isinstance(n, UnaryOp):
        return f"({n.op} {_r(n.operand)})"
    if isinstance(n, IsNullPred):
        return f"({_r(n.expr)} is {'not ' if n.negated else ''}null)"
    if isinstance(n, Between):
        neg = "not " if n.negated else ""
        return f"({_r(n.expr)} {neg}between {_r(n.lo)} and {_r(n.hi)})"
    if isinstance(n, InList):
        neg = "not " if n.negated else ""
        return f"({_r(n.expr)} {neg}in ({', '.join(_r(i) for i in n.items)}))"
    if isinstance(n, InSubquery):
        neg = "not " if n.negated else ""
        return f"({_r(n.expr)} {neg}in ({_r(n.query)}))"
    if isinstance(n, LikePred):
        neg = "not " if n.negated else ""
        pat = "'" + n.pattern.replace("'", "''") + "'"
        return f"({_r(n.expr)} {neg}like {pat})"
    if isinstance(n, CaseExpr):
        parts = ["case"]
        if n.operand is not None:
            parts.append(_r(n.operand))
        for c, v in n.whens:
            parts.append(f"when {_r(c)} then {_r(v)}")
        if n.orelse is not None:
            parts.append(f"else {_r(n.orelse)}")
        parts.append("end")
        return " ".join(parts)
    if isinstance(n, ScalarSubquery):
        return f"({_r(n.query)})"
    if isinstance(n, TableName):
        return n.name + (f" {n.alias}" if n.alias else "")
    if isinstance(n, DerivedTable):
        return f"({_r(n.query)}) {n.alias}"
    if isinstance(n, Join):
        kw = "join" if n.kind == "inner" else "left join"
        return f"{_r(n.left)} {kw} {_r(n.right)} on {_r(n.on)}"
    if isinstance(n, SelectItem):
        return _r(n.expr) + (f" as {n.alias}" if n.alias else "")
    if isinstance(n, OrderItem):
        s = _r(n.expr) + ("" if n.asc else " desc")
        if n.nulls_first is not None:
            s += " nulls first" if n.nulls_first else " nulls last"
        return s
    if isinstance(n, Select):
        parts = ["select"]
        if n.distinct:
            parts.append("distinct")
        parts.append(", ".join(_r(i) for i in n.items))
        if n.from_:
            parts.append("from " + ", ".join(_r(t) for t in n.from_))
        if n.where is not None:
            parts.append("where " + _r(n.where))
        if n.group_by:
            parts.append("group by " + ", ".join(_r(g) for g in n.group_by))
        if n.having is not None:
            parts.append("having " + _r(n.having))
        return " ".join(parts)
    if isinstance(n, UnionAll):
        return " union all ".join(_r(b) for b in n.branches)
    if isinstance(n, Cte):
        return f"{n.name} as ({_r(n.body)})"
    if isinstance(n, Query):
        parts = []
        if n.ctes:
            parts.append("with " + ", ".join(_r(c) for c in n.ctes))
        parts.append(_r(n.body))
        if n.order_by:
            parts.append("order by " + ", ".join(_r(o) for o in n.order_by))
        if n.limit is not None:
            parts.append(f"limit {n.limit}")
        return " ".join(parts)
    raise TypeError(f"cannot render {type(n).__name__}")


def walk(n: Node):
    """Pre-order traversal over every nested Node (tuples included)."""
    yield n
    for v in vars(n).values():
        if isinstance(v, Node):
            yield from walk(v)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, Node):
                    yield from walk(item)
                elif isinstance(item, tuple):
                    for sub in item:
                        if isinstance(sub, Node):
                            yield from walk(sub)
