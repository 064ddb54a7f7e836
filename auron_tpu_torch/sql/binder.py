"""Binder: name resolution + typed expression binding for the SQL frontend.

Sits between the parser (sql/parser.py — pure syntax) and the lowering
(sql/lowering.py — relational algorithm). The binder owns:

- :class:`Scope`: the flattened relation layout of one SELECT's FROM
  clause (tables in FROM order, columns concatenated left-to-right —
  exactly the engine's join output layout), with qualified/unqualified
  name resolution and ambiguity diagnostics;
- :class:`ExprBinder`: AST expression -> engine ``exprs/ir`` tree with a
  derived :class:`~auron_tpu_torch.types.DataType`. Type derivation REUSES the
  engine's own rules (``exprs/ir.arith_result_type`` for arithmetic,
  ``exec/agg_exec.final_type`` for aggregates) so the binder cannot drift
  from what the operators actually produce;
- the supported-subset contract: constructs that parse but cannot lower
  exactly (correlated subqueries, string ordering comparisons, date
  column arithmetic, unknown functions, distinct aggregates, ...) raise
  :class:`SqlUnsupported` with the construct name and source position —
  never a silently wrong plan.

Determinism note (load-bearing for plan goldens): every piece of binder
state is a list or an insertion-ordered dict keyed by parse order, and
generated names (``_c0``-style ordinals) are pure functions of position —
two independent parses of the same text bind to identical trees.

Copied from ``auron_tpu/sql/binder.py``; only the imports differ (the
registry and ``AggExpr``/``final_type`` are the port's) and the integer
range check, which reads the type's numpy dtype.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field

import numpy as np

from auron_tpu_torch import types as T
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.sql import sqlast as A
from auron_tpu_torch.sql.diagnostics import (
    NO_POS,
    SourcePos,
    SqlAnalysisError,
    SqlUnsupported,
)

_EPOCH = _dt.date(1970, 1, 1)

#: aggregate function surface (parser sees them as plain FuncCalls)
AGG_FUNCS = ("sum", "avg", "min", "max", "count")

#: recognizably-aggregate names OUTSIDE the subset: reject by name so the
#: diagnostic says "aggregate stddev_samp" instead of "unknown function"
_KNOWN_OTHER_AGGS = (
    "stddev_samp", "stddev_pop", "stddev", "var_samp", "var_pop", "variance",
    "corr", "covar_samp", "covar_pop", "approx_count_distinct", "grouping",
)

#: scalar functions the binder lowers (name -> engine registry name)
_SCALAR_FUNCS = {
    "substr": "substring",
    "substring": "substring",
    "upper": "upper",
    "lower": "lower",
    "trim": "trim",
    "length": "length",
}


def date_literal_days(text: str, pos: SourcePos) -> int:
    try:
        d = _dt.date.fromisoformat(text.strip())
    except ValueError:
        raise SqlAnalysisError(f"bad date literal {text!r}", pos) from None
    return (d - _EPOCH).days


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RelEntry:
    """One relation visible in a FROM clause."""

    alias: str          # resolution name (table alias, CTE/derived alias)
    table: str          # base table name ("" for derived/CTE relations)
    schema: T.Schema
    start: int          # column offset in the flattened scope layout
    element: int        # index of the owning FROM element (join-graph unit)


@dataclass
class Scope:
    """Flattened relation layout of one SELECT. ``outer`` is the enclosing
    query's scope — consulted ONLY to diagnose correlation (a name that
    resolves there but not here is a correlated reference, which is out of
    subset, not an unknown column)."""

    entries: list[RelEntry] = field(default_factory=list)
    outer: "Scope | None" = None

    @property
    def width(self) -> int:
        return sum(len(e.schema) for e in self.entries)

    def add(self, alias: str, table: str, schema: T.Schema, element: int) -> RelEntry:
        lowered = alias.lower()
        for e in self.entries:
            if e.alias == lowered:
                raise SqlAnalysisError(f"duplicate relation alias {alias!r}")
        entry = RelEntry(lowered, table.lower(), schema, self.width, element)
        self.entries.append(entry)
        return entry

    def element_of(self, index: int) -> int:
        for e in self.entries:
            if e.start <= index < e.start + len(e.schema):
                return e.element
        raise IndexError(index)

    def entry_of(self, index: int) -> RelEntry:
        for e in self.entries:
            if e.start <= index < e.start + len(e.schema):
                return e
        raise IndexError(index)

    # -- resolution ----------------------------------------------------------

    def _find(self, parts: tuple[str, ...]) -> list[tuple[int, T.Field]]:
        name = parts[-1].lower()
        hits: list[tuple[int, T.Field]] = []
        if len(parts) == 2:
            qual = parts[0].lower()
            for e in self.entries:
                if e.alias != qual:
                    continue
                for i, f in enumerate(e.schema):
                    if f.name.lower() == name:
                        hits.append((e.start + i, f))
            return hits
        for e in self.entries:
            for i, f in enumerate(e.schema):
                if f.name.lower() == name:
                    hits.append((e.start + i, f))
        return hits

    def resolve(self, parts: tuple[str, ...], pos: SourcePos) -> tuple[int, T.Field]:
        if len(parts) > 2:
            raise SqlUnsupported(
                "catalog-qualified name", ".".join(parts), pos)
        hits = self._find(parts)
        if len(hits) == 1:
            return hits[0]
        dotted = ".".join(parts)
        if len(hits) > 1:
            raise SqlAnalysisError(f"ambiguous column {dotted!r}", pos)
        outer = self.outer
        while outer is not None:
            if outer._find(parts):
                raise SqlUnsupported(
                    "correlated subquery",
                    f"{dotted!r} resolves in an enclosing query", pos)
            outer = outer.outer
        raise SqlAnalysisError(f"unknown column {dotted!r}", pos)


# ---------------------------------------------------------------------------
# bound expressions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Bound:
    """A bound expression: engine IR + derived type + a display name hint
    (pure function of the source — see module docstring)."""

    e: ir.Expr
    dtype: T.DataType
    name: str = ""


def referenced_elements(e: ir.Expr, scope: Scope) -> frozenset[int]:
    """FROM-element ids a bound expression reads (drives pushdown and
    equi-join extraction in the lowering)."""
    out = set()
    for n in ir.walk(e):
        if isinstance(n, ir.Column):
            out.add(scope.element_of(n.index))
    return frozenset(out)


def _fits_int32(v: int) -> bool:
    return -(2**31) <= v < 2**31


def _int_range_check(v: int, to, pos: SourcePos) -> None:
    """A literal outside its type's range would WRAP on device — loud
    diagnostic, never a silently wrong comparison/fold."""
    info = np.iinfo(to.numpy_dtype())
    if not (info.min <= int(v) <= info.max):
        raise SqlUnsupported(
            f"integer literal out of range for {to}", str(v), pos)


_CMP_MAP = {"=": "eq", "<>": "neq", "<": "lt", "<=": "lteq",
            ">": "gt", ">=": "gteq"}
_ARITH_MAP = {"+": "add", "-": "sub", "*": "mul", "/": "div"}

_CAST_TYPES = {
    "int": T.INT32, "integer": T.INT32, "smallint": T.INT16,
    "tinyint": T.INT8, "bigint": T.INT64, "long": T.INT64,
    "double": T.FLOAT64, "float": T.FLOAT32, "real": T.FLOAT32,
    "date": T.DATE32, "string": T.STRING, "varchar": T.STRING,
    "char": T.STRING,
}


class ExprBinder:
    """Binds AST expressions against one scope.

    ``allow_aggs=False`` (the default): encountering an aggregate call
    raises — the lowering extracts aggregates explicitly and binds only
    their arguments here.
    """

    def __init__(self, scope: Scope):
        self.scope = scope

    # -- public --------------------------------------------------------------

    def bind(self, e: A.Expr) -> Bound:
        m = getattr(self, "_bind_" + type(e).__name__, None)
        if m is None:
            raise SqlUnsupported(type(e).__name__, "expression outside the subset",
                                 getattr(e, "pos", SourcePos()))
        return m(e)

    # -- leaves --------------------------------------------------------------

    def _bind_Ident(self, e: A.Ident) -> Bound:
        idx, f = self.scope.resolve(e.parts, e.pos)
        return Bound(ir.Column(idx, f.name), f.dtype, f.name)

    def _bind_NumberLit(self, e: A.NumberLit) -> Bound:
        t = e.text
        if t.isdigit() or (t[:1] in "+-" and t[1:].isdigit()):
            v = int(t)
            dt = T.INT32 if _fits_int32(v) else T.INT64
            return Bound(ir.Literal(v, dt), dt, t)
        # '.'-form and exponent-form numbers bind as float64: the catalog
        # carries float64 money columns (no decimal columns), so a decimal
        # literal would only force casts the engine immediately folds away
        return Bound(ir.Literal(float(t), T.FLOAT64), T.FLOAT64, t)

    def _bind_StringLit(self, e: A.StringLit) -> Bound:
        return Bound(ir.Literal(e.value, T.STRING), T.STRING)

    def _bind_DateLit(self, e: A.DateLit) -> Bound:
        return Bound(ir.Literal(date_literal_days(e.value, e.pos), T.DATE32),
                     T.DATE32)

    def _bind_NullLit(self, e: A.NullLit) -> Bound:
        return Bound(ir.Literal(None, T.NULL), T.NULL)

    def _bind_IntervalLit(self, e: A.IntervalLit) -> Bound:
        # reachable only when an interval appears OUTSIDE +/- with a date
        # (the additive case folds it before binding)
        raise SqlUnsupported("interval literal",
                             "INTERVAL only in date +/- interval", e.pos)

    # -- operators -----------------------------------------------------------

    def _bind_BinOp(self, e: A.BinOp) -> Bound:
        if e.op in ("and", "or"):
            l = self._as_predicate(e.left)
            r = self._as_predicate(e.right)
            return Bound(ir.BinaryOp(e.op, l.e, r.e), T.BOOL)
        if e.op in _CMP_MAP:
            return self._bind_comparison(e)
        if e.op in _ARITH_MAP:
            return self._bind_arith(e)
        raise SqlUnsupported(f"operator {e.op}", "", e.pos)

    def _as_predicate(self, e: A.Expr) -> Bound:
        b = self.bind(e)
        if b.dtype.kind != T.TypeKind.BOOL:
            raise SqlAnalysisError(
                f"expected a boolean predicate, got {b.dtype}",
                getattr(e, "pos", SourcePos()))
        return b

    def _bind_comparison(self, e: A.BinOp) -> Bound:
        l = self.bind(e.left)
        r = self.bind(e.right)
        op = _CMP_MAP[e.op]
        l, r = self._coerce_pair(l, r, e.op, e.pos)
        return Bound(ir.BinaryOp(op, l.e, r.e), T.BOOL)

    def _coerce_pair(self, l: Bound, r: Bound, op: str,
                     pos: SourcePos) -> tuple[Bound, Bound]:
        """Comparison operand coercion: numeric widening via the engine's
        common-type rule; strings only under (in)equality; dates compare
        directly. Operands reach the evaluator in ONE type."""
        lt, rt = l.dtype, r.dtype
        if lt == rt:
            if lt.is_string_like and op not in ("=", "<>"):
                raise SqlUnsupported(
                    "string ordering comparison",
                    "strings support = and <> only (device codes are "
                    "unordered)", pos)
            return l, r
        if lt.kind == T.TypeKind.NULL or rt.kind == T.TypeKind.NULL:
            return l, r
        if lt.is_numeric and rt.is_numeric:
            common = ir.numeric_common_type(lt, rt)
            return (self._cast_to(l, common, pos),
                    self._cast_to(r, common, pos))
        raise SqlUnsupported(
            f"comparison between {lt} and {rt}", "", pos)

    def _cast_to(self, b: Bound, to: T.DataType,
                 pos: SourcePos = NO_POS) -> Bound:
        if b.dtype == to:
            return b
        if isinstance(b.e, ir.Literal) and b.e.value is not None and to.is_numeric:
            v = b.e.value
            if to.is_integer:
                # only lossless literal narrowing folds; else keep the cast
                if float(v) == int(v):
                    _int_range_check(int(v), to, pos)
                    return Bound(ir.Literal(int(v), to), to, b.name)
            elif to.is_float:
                return Bound(ir.Literal(float(v), to), to, b.name)
        return Bound(ir.Cast(b.e, to), to, b.name)

    def _bind_arith(self, e: A.BinOp) -> Bound:
        # date +/- interval folds HERE (only literal dates: a date COLUMN
        # offset has no device lowering — loud failure, not a wrong plan)
        if e.op in ("+", "-"):
            for a, b in ((e.left, e.right), (e.right, e.left)):
                if isinstance(b, A.IntervalLit):
                    if e.op == "-" and b is e.left:
                        raise SqlUnsupported("interval - date", "", e.pos)
                    if b.unit != "day":
                        # time-unit intervals belong to streaming windows/
                        # watermarks; a sub-day DATE32 offset has no lowering
                        raise SqlUnsupported(
                            f"interval unit {b.unit}",
                            "date arithmetic folds DAY intervals only", b.pos)
                    base = self.bind(a)
                    if not (isinstance(base.e, ir.Literal)
                            and base.dtype == T.DATE32):
                        raise SqlUnsupported(
                            "date column arithmetic",
                            "only <date literal> +/- INTERVAL folds", b.pos)
                    days = base.e.value + (b.n if e.op == "+" else -b.n)
                    return Bound(ir.Literal(days, T.DATE32), T.DATE32)
        l = self.bind(e.left)
        r = self.bind(e.right)
        if not (l.dtype.is_numeric and r.dtype.is_numeric):
            raise SqlUnsupported(
                f"arithmetic over {l.dtype} and {r.dtype}", "", e.pos)
        out = ir.arith_result_type(_ARITH_MAP[e.op], l.dtype, r.dtype)
        # constant-fold integer +|-|* (TPC-DS writes years as 1999+1 and
        # month windows as 1176+11 — IN lists and plan goldens want the
        # folded literal, not an arithmetic node)
        if (e.op in ("+", "-", "*")
                and isinstance(l.e, ir.Literal) and isinstance(r.e, ir.Literal)
                and l.dtype.is_integer and r.dtype.is_integer
                and l.e.value is not None and r.e.value is not None):
            v = {"+": l.e.value + r.e.value, "-": l.e.value - r.e.value,
                 "*": l.e.value * r.e.value}[e.op]
            _int_range_check(v, out, e.pos)  # a wrapped fold is a wrong plan
            return Bound(ir.Literal(v, out), out)
        return Bound(ir.BinaryOp(_ARITH_MAP[e.op], l.e, r.e), out)

    def _bind_UnaryOp(self, e: A.UnaryOp) -> Bound:
        if e.op == "not":
            b = self._as_predicate(e.operand)
            return Bound(ir.Not(b.e), T.BOOL)
        b = self.bind(e.operand)
        if e.op == "+":
            return b
        if not b.dtype.is_numeric:
            raise SqlAnalysisError(f"cannot negate {b.dtype}", e.pos)
        if isinstance(b.e, ir.Literal) and b.e.value is not None:
            return Bound(ir.Literal(-b.e.value, b.dtype), b.dtype)
        minus_one = ir.Literal(-1, b.dtype if b.dtype.is_integer else T.FLOAT64)
        out = ir.arith_result_type("mul", minus_one.dtype, b.dtype)
        return Bound(ir.BinaryOp("mul", minus_one, b.e), out)

    # -- predicates ----------------------------------------------------------

    def _bind_IsNullPred(self, e: A.IsNullPred) -> Bound:
        b = self.bind(e.expr)
        node = ir.IsNotNull(b.e) if e.negated else ir.IsNull(b.e)
        return Bound(node, T.BOOL)

    def _bind_Between(self, e: A.Between) -> Bound:
        x = self.bind(e.expr)
        lo = self.bind(e.lo)
        hi = self.bind(e.hi)
        xl, lo = self._coerce_pair(x, lo, ">=", e.pos)
        xh, hi = self._coerce_pair(x, hi, "<=", e.pos)
        pred = ir.BinaryOp(
            "and",
            ir.BinaryOp("gteq", xl.e, lo.e),
            ir.BinaryOp("lteq", xh.e, hi.e),
        )
        if e.negated:
            return Bound(ir.Not(pred), T.BOOL)
        return Bound(pred, T.BOOL)

    def _bind_InList(self, e: A.InList) -> Bound:
        x = self.bind(e.expr)
        values = []
        for item in e.items:
            b = self.bind(item)
            if not isinstance(b.e, ir.Literal):
                raise SqlUnsupported("non-literal IN list item", "", item.pos
                                     if hasattr(item, "pos") else e.pos)
            b = self._coerce_in_item(b, x.dtype, e.pos)
            if not isinstance(b.e, ir.Literal):
                # _cast_to kept a runtime Cast: the item is not exactly
                # representable in the column's type (e.g. 2.5 against an
                # int column) — loud diagnostic, not a wrong membership
                raise SqlUnsupported(
                    "non-exact IN list item",
                    f"not representable exactly as {x.dtype}",
                    getattr(item, "pos", e.pos))
            values.append(ir.Literal(b.e.value, x.dtype))
        # In carries typed Literals so the lowering ships exactly the
        # column's type (builders re-wraps raw values via ir.lit otherwise)
        return Bound(ir.In(x.e, tuple(values), e.negated), T.BOOL)

    def _coerce_in_item(self, b: Bound, to: T.DataType, pos: SourcePos) -> Bound:
        if b.dtype == to:
            return b
        if b.dtype.is_numeric and to.is_numeric:
            return self._cast_to(b, to, pos)
        raise SqlUnsupported(f"IN item of type {b.dtype} against {to}", "", pos)

    def _bind_LikePred(self, e: A.LikePred) -> Bound:
        x = self.bind(e.expr)
        if not x.dtype.is_string_like:
            raise SqlAnalysisError(f"LIKE over {x.dtype}", e.pos)
        return Bound(ir.Like(x.e, e.pattern, e.negated), T.BOOL)

    def _bind_InSubquery(self, e: A.InSubquery) -> Bound:
        # only the lowering can place a semi join; reaching the binder means
        # the subquery sits under OR / inside an expression
        raise SqlUnsupported(
            "in subquery under an expression",
            "IN (SELECT ...) must be a top-level WHERE conjunct", e.pos)

    def _bind_ScalarSubquery(self, e: A.ScalarSubquery) -> Bound:
        raise SqlUnsupported("scalar subquery",
                             "subqueries in expression position", e.pos)

    # -- composite -----------------------------------------------------------

    def _bind_CaseExpr(self, e: A.CaseExpr) -> Bound:
        whens: list[tuple[ir.Expr, Bound]] = []
        if e.operand is not None:
            op = self.bind(e.operand)
            for c, v in e.whens:
                cv = self.bind(c)
                opc, cvc = self._coerce_pair(op, cv, "=", e.pos)
                whens.append((ir.BinaryOp("eq", opc.e, cvc.e), self.bind(v)))
        else:
            for c, v in e.whens:
                whens.append((self._as_predicate(c).e, self.bind(v)))
        orelse = self.bind(e.orelse) if e.orelse is not None else None

        values = [v for _, v in whens] + ([orelse] if orelse is not None else [])
        out = _common_branch_type(values, e.pos)
        branches = tuple(
            (c, self._branch_to(v, out).e) for c, v in whens
        )
        orelse_e = self._branch_to(orelse, out).e if orelse is not None else None
        return Bound(ir.Case(branches, orelse_e), out)

    def _branch_to(self, b: Bound, to: T.DataType) -> Bound:
        if b.dtype.kind == T.TypeKind.NULL:
            return Bound(ir.Literal(None, to), to)
        return self._cast_to(b, to)

    def _bind_Cast(self, e: A.Cast) -> Bound:
        tn = e.to
        if tn.name == "decimal":
            if len(tn.params) != 2:
                raise SqlAnalysisError("decimal cast needs (precision, scale)",
                                       tn.pos)
            to = T.decimal(tn.params[0], tn.params[1])
        elif tn.name in _CAST_TYPES:
            to = _CAST_TYPES[tn.name]
        else:
            raise SqlUnsupported(f"cast to {tn.name}", "", tn.pos)
        b = self.bind(e.expr)
        if to == T.DATE32 and isinstance(b.e, ir.Literal) \
                and b.dtype == T.STRING:
            # constant-fold string->date so literal date arithmetic
            # (cast('2000-05-25' as date) + 60 days) folds too
            return Bound(
                ir.Literal(date_literal_days(b.e.value, e.pos), T.DATE32),
                T.DATE32)
        if b.dtype == to:
            return b
        return Bound(ir.Cast(b.e, to), to, b.name)

    def _bind_FuncCall(self, e: A.FuncCall) -> Bound:
        name = e.name
        if name in AGG_FUNCS:
            raise SqlAnalysisError(
                f"aggregate {name}(...) is not allowed here", e.pos)
        if name in _KNOWN_OTHER_AGGS:
            raise SqlUnsupported(f"aggregate {name}", "outside the subset",
                                 e.pos)
        if name == "coalesce":
            args = [self.bind(a) for a in e.args]
            if not args:
                raise SqlAnalysisError("coalesce needs arguments", e.pos)
            out = _common_branch_type(args, e.pos)
            return Bound(
                ir.Coalesce(tuple(self._branch_to(a, out).e for a in args)),
                out)
        if name in _SCALAR_FUNCS:
            args = [self.bind(a) for a in e.args]
            if not args or not args[0].dtype.is_string_like:
                raise SqlAnalysisError(
                    f"{name} expects a string first argument", e.pos)
            fn = ir.ScalarFunc(_SCALAR_FUNCS[name],
                               tuple(a.e for a in args))
            from auron_tpu_torch.functions import registry

            out = registry.infer_dtype(_SCALAR_FUNCS[name],
                                       [a.dtype for a in args])
            return Bound(fn, out)
        raise SqlUnsupported(f"function {name}", "not in the supported subset",
                             e.pos)


def _common_branch_type(values: list[Bound], pos: SourcePos) -> T.DataType:
    """Result type of CASE branches / COALESCE args (NULL literals defer)."""
    out: T.DataType | None = None
    for v in values:
        if v.dtype.kind == T.TypeKind.NULL:
            continue
        if out is None:
            out = v.dtype
        elif out != v.dtype:
            if out.is_numeric and v.dtype.is_numeric:
                out = ir.numeric_common_type(out, v.dtype)
            else:
                raise SqlAnalysisError(
                    f"incompatible branch types {out} and {v.dtype}", pos)
    if out is None:
        raise SqlAnalysisError("all branches are NULL", pos)
    return out


# ---------------------------------------------------------------------------
# aggregate analysis (used by the lowering)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AggCall:
    """One distinct aggregate call of a SELECT (dedup key: func + bound
    argument), in first-appearance order."""

    func: str               # sum|avg|min|max|count|count_star
    arg: Bound | None       # None for count(*)
    ast: A.FuncCall

    @property
    def out_dtype(self) -> T.DataType:
        from auron_tpu_torch.exec.agg_exec import AggExpr, final_type

        return final_type(AggExpr(self.func, None),
                          self.arg.dtype if self.arg is not None else None)


def is_agg_call(e: A.Expr) -> bool:
    return isinstance(e, A.FuncCall) and (
        e.name in AGG_FUNCS or e.name in _KNOWN_OTHER_AGGS)


def contains_agg(e: A.Expr) -> bool:
    return any(is_agg_call(n) for n in A.walk(e))


def collect_aggs(exprs: list[A.Expr], binder: ExprBinder) -> list[AggCall]:
    """Distinct aggregate calls across `exprs`, in appearance order, with
    bound arguments. Rejects nested and out-of-subset aggregates."""
    out: list[AggCall] = []
    seen: dict[tuple, int] = {}
    for top in exprs:
        for node in A.walk(top):
            if not is_agg_call(node):
                continue
            if node.name in _KNOWN_OTHER_AGGS:
                raise SqlUnsupported(f"aggregate {node.name}",
                                     "outside the subset", node.pos)
            if node.distinct:
                raise SqlUnsupported(
                    "distinct aggregate",
                    f"{node.name}(DISTINCT ...) needs the two-level rewrite",
                    node.pos)
            for a in node.args:
                if contains_agg(a):
                    raise SqlAnalysisError("nested aggregate", node.pos)
            if node.star or not node.args:
                if node.name != "count":
                    raise SqlAnalysisError(f"{node.name}(*) is not defined",
                                           node.pos)
                key = ("count_star",)
                if key not in seen:
                    seen[key] = len(out)
                    out.append(AggCall("count_star", None, node))
                continue
            if len(node.args) != 1:
                raise SqlAnalysisError(
                    f"{node.name} takes one argument", node.pos)
            arg = binder.bind(node.args[0])
            if node.name in ("sum", "avg") and not arg.dtype.is_numeric:
                raise SqlUnsupported(f"{node.name} over {arg.dtype}", "",
                                     node.pos)
            if node.name in ("min", "max") and arg.dtype.is_string_like:
                raise SqlUnsupported(
                    "min/max over strings",
                    "device dictionary codes are unordered", node.pos)
            key = (node.name, arg.e)
            if key not in seen:
                seen[key] = len(out)
                out.append(AggCall(node.name, arg, node))
    return out


def agg_slot(aggs: list[AggCall], node: A.FuncCall, binder: ExprBinder) -> int:
    """Index of `node`'s AggCall in `aggs` (same dedup key as collect_aggs)."""
    if node.star or not node.args:
        key = ("count_star",)
    else:
        key = (node.name, binder.bind(node.args[0]).e)
    for i, a in enumerate(aggs):
        akey = ("count_star",) if a.arg is None else (a.func, a.arg.e)
        if akey == key:
            return i
    raise SqlAnalysisError("aggregate did not resolve", node.pos)
