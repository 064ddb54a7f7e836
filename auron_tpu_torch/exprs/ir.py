"""Physical expression IR (the subset the port evaluates).

Copied from ``auron_tpu/exprs/ir.py``: frozen, structurally hashable
dataclasses with the same names and fields, and the same Spark result-type
rules (``arith_result_type``). ``HostUDF`` is evaluated through the
bridge's callback registry (``bridge/udf.py``).
``Literal(None, T.INT64)`` is a typed NULL. ``remap_columns`` re-binds an
expression to a schema of only the columns it references.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

from auron_tpu_torch import types as T


class Expr:
    def dtype_of(self, schema: T.Schema) -> T.DataType:
        raise NotImplementedError

    def children(self) -> tuple["Expr", ...]:
        return ()


@dataclass(frozen=True)
class Column(Expr):
    index: int
    name: str = ""

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return schema[self.index].dtype


@dataclass(frozen=True)
class Literal(Expr):
    value: Any
    dtype: T.DataType

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return self.dtype


@dataclass(frozen=True)
class Cast(Expr):
    child: Expr
    to: T.DataType
    try_: bool = False

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return self.to

    def children(self):
        return (self.child,)


_CMP_OPS = ("eq", "neq", "lt", "lteq", "gt", "gteq")
_LOGIC_OPS = ("and", "or")
_ARITH_OPS = ("add", "sub", "mul", "div", "mod")


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # one of _CMP_OPS, _LOGIC_OPS, _ARITH_OPS
    left: Expr
    right: Expr

    def children(self):
        return (self.left, self.right)

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        if self.op in _CMP_OPS or self.op in _LOGIC_OPS:
            return T.BOOL
        return arith_result_type(self.op, self.left.dtype_of(schema),
                                 self.right.dtype_of(schema))


@dataclass(frozen=True)
class Not(Expr):
    child: Expr

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return T.BOOL

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class IsNull(Expr):
    child: Expr

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return T.BOOL

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class IsNotNull(Expr):
    child: Expr

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return T.BOOL

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class If(Expr):
    cond: Expr
    then: Expr
    orelse: Expr

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return self.then.dtype_of(schema)

    def children(self):
        return (self.cond, self.then, self.orelse)


@dataclass(frozen=True)
class Case(Expr):
    """CASE WHEN c1 THEN v1 WHEN c2 THEN v2 ... ELSE e END."""

    branches: tuple[tuple[Expr, Expr], ...]
    orelse: Expr | None = None

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return self.branches[0][1].dtype_of(schema)

    def children(self):
        cs: list[Expr] = []
        for c, v in self.branches:
            cs += [c, v]
        if self.orelse is not None:
            cs.append(self.orelse)
        return tuple(cs)


@dataclass(frozen=True)
class In(Expr):
    child: Expr
    items: tuple[Any, ...]  # literal values (or Literal nodes)
    negated: bool = False

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return T.BOOL

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class Coalesce(Expr):
    args: tuple[Expr, ...]

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return self.args[0].dtype_of(schema)

    def children(self):
        return self.args


@dataclass(frozen=True)
class Like(Expr):
    """SQL LIKE with % and _ wildcards; evaluated over the dictionary."""

    child: Expr
    pattern: str
    negated: bool = False
    escape: str = "\\"

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return T.BOOL

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class SparkPartitionId(Expr):
    """Current task partition id (Spark ``spark_partition_id()``)."""

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return T.INT32


@dataclass(frozen=True)
class MonotonicId(Expr):
    """Spark ``monotonically_increasing_id()``: (partition id << 33) + the
    row's index among the partition's live rows."""

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return T.INT64


@dataclass(frozen=True)
class RowNum(Expr):
    """1-based row number within the task's output stream."""

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return T.INT64


@dataclass(frozen=True)
class ScalarSubquery(Expr):
    """Value of an uncorrelated scalar subquery, computed before the task
    runs and handed in as a Python scalar under ``resource_id`` in the task
    resource map."""

    resource_id: str
    dtype: T.DataType

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return self.dtype


@dataclass(frozen=True)
class HostUDF(Expr):
    """Host-callback expression (reference ``exprs/ir.py:237``): the
    fallback for a function the engine cannot evaluate, called through the
    bridge's UDF callback (``bridge/udf.py``)."""

    name: str
    args: tuple[Expr, ...]
    out_dtype: T.DataType

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        return self.out_dtype

    def children(self):
        return self.args


@dataclass(frozen=True)
class ScalarFunc(Expr):
    """Named scalar function dispatched through the function registry
    (reference ``exprs/ir.py:257-270``; ``functions/registry.py``)."""

    name: str
    args: tuple[Expr, ...]
    out_dtype: T.DataType | None = None  # override; else the registry infers

    def dtype_of(self, schema: T.Schema) -> T.DataType:
        if self.out_dtype is not None:
            return self.out_dtype
        from auron_tpu_torch.functions import registry

        return registry.infer_dtype(self.name, [a.dtype_of(schema) for a in self.args])

    def children(self):
        return self.args


# ---------------------------------------------------------------------------
# Spark arithmetic result-type rules (verbatim from auron_tpu/exprs/ir.py)
# ---------------------------------------------------------------------------

_INT_RANK = {T.TypeKind.INT8: 1, T.TypeKind.INT16: 2, T.TypeKind.INT32: 3, T.TypeKind.INT64: 4}


def numeric_common_type(lt: T.DataType, rt: T.DataType) -> T.DataType:
    if lt == rt:
        return lt
    if lt.kind == T.TypeKind.FLOAT64 or rt.kind == T.TypeKind.FLOAT64:
        return T.FLOAT64
    if lt.kind == T.TypeKind.FLOAT32 or rt.kind == T.TypeKind.FLOAT32:
        other = rt if lt.kind == T.TypeKind.FLOAT32 else lt
        if other.kind in (T.TypeKind.INT64, T.TypeKind.DECIMAL):
            return T.FLOAT64
        return T.FLOAT32
    if lt.kind == T.TypeKind.DECIMAL or rt.kind == T.TypeKind.DECIMAL:
        ld, rd = _as_decimal(lt), _as_decimal(rt)
        scale = max(ld.scale, rd.scale)
        prec = max(ld.precision - ld.scale, rd.precision - rd.scale) + scale
        return T.decimal(min(prec, 38), scale)
    if lt.is_integer and rt.is_integer:
        return lt if _INT_RANK[lt.kind] >= _INT_RANK[rt.kind] else rt
    if lt.kind == T.TypeKind.NULL:
        return rt
    if rt.kind == T.TypeKind.NULL:
        return lt
    if lt.is_string_like or rt.is_string_like:
        return T.STRING
    raise TypeError(f"no common type for {lt} and {rt}")


def _as_decimal(t: T.DataType) -> T.DataType:
    if t.kind == T.TypeKind.DECIMAL:
        return t
    p, s = {T.TypeKind.INT8: (3, 0), T.TypeKind.INT16: (5, 0),
            T.TypeKind.INT32: (10, 0), T.TypeKind.INT64: (20, 0)}[t.kind]
    return T.decimal(p, s)


def _bounded(p: int, s: int) -> T.DataType:
    if p <= 38:
        return T.decimal(p, s)
    digits = p - s
    return T.decimal(38, max(38 - digits, min(s, 6)))


def arith_result_type(op: str, lt: T.DataType, rt: T.DataType) -> T.DataType:
    if lt.kind == T.TypeKind.DECIMAL or rt.kind == T.TypeKind.DECIMAL:
        if lt.is_float or rt.is_float:
            return T.FLOAT64
        ld, rd = _as_decimal(lt), _as_decimal(rt)
        p1, s1, p2, s2 = ld.precision, ld.scale, rd.precision, rd.scale

        def emit(p, s):
            t = _bounded(p, s)
            if t.precision > 18 and not (lt.is_wide_decimal or rt.is_wide_decimal):
                return T.decimal(18, min(t.scale, 18))
            return t

        if op in ("add", "sub"):
            s = max(s1, s2)
            return emit(max(p1 - s1, p2 - s2) + s + 1, s)
        if op == "mul":
            return emit(p1 + p2 + 1, s1 + s2)
        if op == "div":
            s = max(6, s1 + p2 + 1)
            return emit(p1 - s1 + s2 + s, s)
        if op == "mod":
            return emit(min(p1 - s1, p2 - s2) + max(s1, s2), max(s1, s2))
        raise ValueError(op)
    if op == "div":
        return T.FLOAT64 if (lt.is_integer and rt.is_integer) else numeric_common_type(lt, rt)
    return numeric_common_type(lt, rt)


def col(index: int, name: str = "") -> Column:
    return Column(index, name)


def lit(value: Any, dtype: T.DataType | None = None) -> Literal:
    if dtype is None:
        if isinstance(value, bool):
            dtype = T.BOOL
        elif isinstance(value, int):
            dtype = T.INT64 if not (-(2**31) <= value < 2**31) else T.INT32
        elif isinstance(value, float):
            dtype = T.FLOAT64
        elif isinstance(value, str):
            dtype = T.STRING
        elif isinstance(value, bytes):
            dtype = T.BINARY
        elif value is None:
            dtype = T.NULL
        else:
            raise TypeError(f"cannot infer literal type of {value!r}")
    return Literal(value, dtype)


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def remap_columns(e: Expr, mapping: dict) -> Expr:
    """Rebuild an expression with Column indices remapped (every node is a
    frozen dataclass). Containers are walked to any depth (Case.branches is
    a tuple of (cond, value) tuples), so every Column that ``walk`` reaches
    is rewritten."""

    def rebuild(v):
        if isinstance(v, Column):
            return Column(mapping[v.index], v.name)
        if isinstance(v, Expr):
            changes = {}
            for f in dataclasses.fields(v):
                old = getattr(v, f.name)
                new = rebuild(old)
                if new is not old:
                    changes[f.name] = new
            return dataclasses.replace(v, **changes) if changes else v
        if isinstance(v, (tuple, list)):
            new = type(v)(rebuild(x) for x in v)
            return v if all(a is b for a, b in zip(new, v)) else new
        return v

    return rebuild(e)
