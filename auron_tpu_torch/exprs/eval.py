"""Expression evaluator: IR trees -> eager torch programs.

Port of the ``auron_tpu/exprs/eval.py`` subset the ported slices use:
Column, Literal, Cast (fixed-width types), BinaryOp (Kleene AND/OR,
comparisons incl. dictionary-string equality/order, arithmetic), Not,
IsNull, IsNotNull, If and Case (fixed-width or dictionary-string
branches), Coalesce, In, Like and the task-context expressions
(SparkPartitionId, MonotonicId, RowNum, ScalarSubquery) — with Spark's
null semantics:
arithmetic propagates NULLs, division and modulo by zero give NULL
(non-ANSI), AND/OR are three-valued, a NULL CASE condition counts as
false, and ``x IN (...)`` is NULL when x is NULL or when nothing matches
and the list holds a NULL. Branches over dictionary strings merge their
host vocabularies into one and remap the codes with one gather; IN and
LIKE over a dictionary string test each vocabulary entry once on the host
and gather the answer by code on the device.
Common subexpressions evaluate once per batch (structural memo).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch, merge_vocab
from auron_tpu_torch.exprs import ir


@dataclass
class ColumnVal:
    values: torch.Tensor
    validity: torch.Tensor
    dtype: T.DataType
    dict: np.ndarray | None = None  # host vocabulary iff dtype.is_dict_encoded


_INT_BOUNDS = {
    T.TypeKind.INT8: (-(2**7), 2**7 - 1),
    T.TypeKind.INT16: (-(2**15), 2**15 - 1),
    T.TypeKind.INT32: (-(2**31), 2**31 - 1),
    T.TypeKind.INT64: (-(2**63), 2**63 - 1),
}


def cast_values(values: torch.Tensor, validity: torch.Tensor, src: T.DataType,
                dst: T.DataType) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-width device cast (``auron_tpu/exprs/cast.py:cast_values``
    without the decimal branches): int->int wraps, float->int truncates
    with NaN -> 0 and Java saturation, timestamp->long is seconds."""
    if src == dst:
        return values, validity
    sk, dk = src.kind, dst.kind
    if sk == T.TypeKind.DECIMAL or dk == T.TypeKind.DECIMAL:
        raise TypeError("decimal casts are not in this slice of the port")
    if sk == T.TypeKind.NULL:
        return torch.zeros_like(values, dtype=dst.physical_dtype()), torch.zeros_like(validity)
    if sk == T.TypeKind.BOOL:
        return cast_values(values.to(torch.int64), validity, T.INT64, dst)
    if dk == T.TypeKind.BOOL:
        return values != 0, validity
    us_per_day = 86_400_000_000
    if sk == T.TypeKind.DATE32 and dk == T.TypeKind.TIMESTAMP:
        return values.to(torch.int64) * us_per_day, validity
    if sk == T.TypeKind.TIMESTAMP and dk == T.TypeKind.DATE32:
        return torch.div(values, us_per_day, rounding_mode="floor").to(torch.int32), validity
    if sk == T.TypeKind.DATE32 and dst.is_numeric:
        return cast_values(values.to(torch.int32), validity, T.INT32, dst)
    if sk == T.TypeKind.TIMESTAMP and dst.is_numeric:
        secs = torch.div(values, 1_000_000, rounding_mode="floor")
        return cast_values(secs, validity, T.INT64, dst)
    if src.is_integer and dk == T.TypeKind.DATE32:
        return values.to(torch.int32), validity
    if src.is_integer and dk == T.TypeKind.TIMESTAMP:
        return values.to(torch.int64) * 1_000_000, validity
    if src.is_float and dst.is_integer:
        lo, hi = _INT_BOUNDS[dk]
        f = values.to(torch.float64)
        t = torch.trunc(f)
        if dk == T.TypeKind.INT64:
            iv = t.clamp(-(2.0**63), float(2**63 - 1024)).to(torch.int64)
            iv = torch.where(t >= 2.0**63, torch.full_like(iv, hi), iv)
        else:
            iv = t.clamp(float(lo), float(hi)).to(torch.int64)
        iv = torch.where(torch.isnan(f), torch.zeros_like(iv), iv)
        return iv.to(dst.physical_dtype()), validity
    if (src.is_integer or src.is_float) and (dst.is_integer or dst.is_float):
        return values.to(dst.physical_dtype()), validity
    raise TypeError(f"unsupported device cast {src} -> {dst}")


def _cmp_apply(op: str, l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    if op == "eq":
        return l == r
    if op == "neq":
        return l != r
    if op == "lt":
        return l < r
    if op == "lteq":
        return l <= r
    if op == "gt":
        return l > r
    if op == "gteq":
        return l >= r
    raise ValueError(op)


def _utf8_key(s):
    return s.encode("utf-8") if isinstance(s, str) else (s if s is not None else b"")


class Evaluator:
    """``partition_id`` and ``resources`` are the task's (operators pass
    their ``ExecutionContext``'s); ``row_offset`` counts the live rows an
    operator already emitted, for MonotonicId and RowNum."""

    def __init__(self, schema: T.Schema, partition_id: int = 0, row_offset: int = 0,
                 resources: dict | None = None):
        self.schema = schema
        self.partition_id = partition_id
        self.row_offset = row_offset
        self.resources = resources if resources is not None else {}

    def evaluate(self, batch: Batch, exprs: list[ir.Expr]) -> list[ColumnVal]:
        memo: dict = {}
        return [self._eval(e, batch, memo) for e in exprs]

    def _eval(self, e: ir.Expr, b: Batch, memo: dict) -> ColumnVal:
        if e in memo:
            return memo[e]
        out = self._eval_uncached(e, b, memo)
        memo[e] = out
        return out

    def _eval_uncached(self, e: ir.Expr, b: Batch, memo: dict) -> ColumnVal:
        if isinstance(e, ir.Column):
            f = self.schema[e.index]
            return ColumnVal(b.col_values(e.index), b.col_validity(e.index), f.dtype,
                             b.dicts[e.index])
        if isinstance(e, ir.Literal):
            return self._literal(e, b.capacity, b.torch_device)
        if isinstance(e, ir.Cast):
            return self._cast(self._eval(e.child, b, memo), e.to)
        if isinstance(e, ir.BinaryOp):
            l = self._eval(e.left, b, memo)
            r = self._eval(e.right, b, memo)
            if e.op in ir._LOGIC_OPS:
                return self._logic(e.op, l, r)
            if e.op in ir._CMP_OPS:
                return self._compare(e.op, l, r)
            return self._arith(e.op, l, r)
        if isinstance(e, ir.Not):
            c = self._eval(e.child, b, memo)
            return ColumnVal(~c.values.to(torch.bool), c.validity, T.BOOL)
        if isinstance(e, ir.IsNull):
            c = self._eval(e.child, b, memo)
            return ColumnVal(~c.validity, torch.ones_like(c.validity), T.BOOL)
        if isinstance(e, ir.IsNotNull):
            c = self._eval(e.child, b, memo)
            return ColumnVal(c.validity, torch.ones_like(c.validity), T.BOOL)
        if isinstance(e, ir.If):
            return self._case([(e.cond, e.then)], e.orelse, b, memo)
        if isinstance(e, ir.Case):
            return self._case(list(e.branches), e.orelse, b, memo)
        if isinstance(e, ir.Coalesce):
            return self._coalesce([self._eval(a, b, memo) for a in e.args])
        if isinstance(e, ir.In):
            return self._in(e, b, memo)
        if isinstance(e, ir.Like):
            return self._like(e, b, memo)
        if isinstance(e, (ir.SparkPartitionId, ir.MonotonicId, ir.RowNum, ir.ScalarSubquery)):
            return self._task_context(e, b)
        raise TypeError(f"unsupported expression {type(e).__name__}")

    def _task_context(self, e: ir.Expr, b: Batch) -> ColumnVal:
        """Expressions of the task rather than the row (``eval.py:128-153``):
        the partition id, positions among the live rows after
        ``row_offset``, and a scalar subquery's value broadcast as a
        literal."""
        cap, dev = b.capacity, b.torch_device
        ones = torch.ones(cap, dtype=torch.bool, device=dev)
        if isinstance(e, ir.SparkPartitionId):
            return ColumnVal(torch.full((cap,), self.partition_id, dtype=torch.int32,
                                        device=dev), ones, T.INT32)
        if isinstance(e, ir.ScalarSubquery):
            if e.resource_id not in self.resources:
                raise KeyError(f"scalar subquery value '{e.resource_id}' is not in the task "
                               "resource map (it must be set before the task runs)")
            return self._literal(ir.Literal(self.resources[e.resource_id], e.dtype), cap, dev)
        live = torch.cumsum(b.device.sel.to(torch.int64), 0)
        if isinstance(e, ir.RowNum):
            return ColumnVal(self.row_offset + live, ones, T.INT64)
        base = (self.partition_id << 33) + self.row_offset
        return ColumnVal(base + (live - 1).clamp(min=0), ones, T.INT64)

    # ---- conditionals ----

    def _case(self, branches, orelse: ir.Expr | None, b: Batch, memo: dict) -> ColumnVal:
        """CASE WHEN c THEN v ... ELSE e END (``eval.py:_case``): a NULL
        condition counts as false, the first true branch wins, branch values
        unify (``_unify_vals``); no ELSE is a NULL of the first branch's type."""
        conds = [self._eval(c, b, memo) for c, _ in branches]
        vals = [self._eval(v, b, memo) for _, v in branches]
        els = self._eval(orelse, b, memo) if orelse is not None else _null_like(vals[0])
        vals = self._unify_vals(vals + [els])
        out_v, out_m = vals[-1].values, vals[-1].validity
        taken = torch.zeros_like(out_m)
        for c, v in zip(conds, vals[:-1]):
            fire = c.validity & c.values.to(torch.bool) & ~taken
            out_v = torch.where(fire, v.values, out_v)
            out_m = torch.where(fire, v.validity, out_m)
            taken = taken | fire
        return ColumnVal(out_v, out_m, vals[0].dtype, vals[0].dict)

    def _coalesce(self, args: list[ColumnVal]) -> ColumnVal:
        """The first valid argument of each row (``eval.py:_coalesce``)."""
        args = self._unify_vals(args)
        out_v, out_m = args[0].values, args[0].validity
        for a in args[1:]:
            take = ~out_m & a.validity
            out_v = torch.where(take, a.values, out_v)
            out_m = out_m | a.validity
        return ColumnVal(out_v, out_m, args[0].dtype, args[0].dict)

    def _unify_vals(self, vals: list[ColumnVal]) -> list[ColumnVal]:
        """Make CASE/COALESCE branch values mergeable (``eval.py:_unify_vals``):
        dictionary branches get one vocabulary (first occurrence over the
        branches in order) and their codes remapped; fixed-width branches
        are cast to their numeric common type."""
        if any(v.dtype.is_dict_encoded for v in vals):
            if not all(v.dtype.is_dict_encoded for v in vals):
                raise TypeError("mixed dictionary-encoded and fixed-width branches")
            first = vals[0].dtype
            if first.kind == T.TypeKind.DECIMAL:
                raise TypeError("wide-decimal branches are not in this slice of the port")
            unified, remaps = merge_vocab([v.dict for v in vals])
            out = []
            for v, r in zip(vals, remaps):
                table = torch.from_numpy(r).to(v.values.device)
                codes = table[v.values.long().clamp(0, len(r) - 1)]
                out.append(ColumnVal(codes, v.validity, first, unified))
            return out
        target = vals[0].dtype
        for v in vals[1:]:
            if v.dtype != target:
                target = ir.numeric_common_type(target, v.dtype)
        return [self._cast(v, target) for v in vals]

    # ---- membership / pattern ----

    def _in(self, e: ir.In, b: Batch, memo: dict) -> ColumnVal:
        """``x [NOT] IN (items)`` (``eval.py:_in``): a dictionary string
        tests each vocabulary entry once on the host; NULL when x is NULL,
        or when nothing matched and the list holds a NULL."""
        c = self._eval(e.child, b, memo)
        items = [i if isinstance(i, ir.Literal) else ir.lit(i) for i in e.items]
        has_null_item = any(i.value is None for i in items)
        if c.dtype.is_string_like:
            wanted = {i.value for i in items if i.value is not None}
            member = np.array([s in wanted for s in c.dict], dtype=bool)
            hit = _gather_table(member, c.values)
        else:
            hit = torch.zeros_like(c.validity)
            for item in items:
                if item.value is not None:
                    lv = self._literal(item, b.capacity, b.torch_device)
                    hit = hit | self._compare("eq", c, lv).values
        valid = c.validity & ~(~hit & has_null_item)
        return ColumnVal(~hit if e.negated else hit, valid, T.BOOL)

    def _like(self, e: ir.Like, b: Batch, memo: dict) -> ColumnVal:
        """SQL LIKE (``eval.py:_like``): the pattern matched once over the
        dictionary on the host, the codes gather the answer on the device."""
        c = self._eval(e.child, b, memo)
        if not c.dtype.is_string_like:
            raise TypeError("LIKE requires a string input")
        rx = _like_to_regex(e.pattern, e.escape)
        match = np.array([s is not None and rx.fullmatch(s) is not None for s in c.dict],
                         dtype=bool)
        hit = _gather_table(match, c.values)
        return ColumnVal(~hit if e.negated else hit, c.validity, T.BOOL)

    # ---- literals / casts ----

    def _literal(self, e: ir.Literal, cap: int, device) -> ColumnVal:
        dt = e.dtype
        if e.value is None or dt.kind == T.TypeKind.NULL:
            phys = dt.physical_dtype() if dt.kind != T.TypeKind.NULL else torch.int8
            d = np.array([""], dtype=object) if dt.is_dict_encoded else None
            return ColumnVal(torch.zeros(cap, dtype=phys, device=device),
                             torch.zeros(cap, dtype=torch.bool, device=device), dt, d)
        ones = torch.ones(cap, dtype=torch.bool, device=device)
        if dt.is_dict_encoded:
            d = np.empty(1, dtype=object)
            d[0] = e.value
            return ColumnVal(torch.zeros(cap, dtype=torch.int32, device=device), ones, dt, d)
        if dt.kind == T.TypeKind.DECIMAL:
            raise TypeError("decimal literals are not in this slice of the port")
        return ColumnVal(torch.full((cap,), e.value, dtype=dt.physical_dtype(), device=device),
                         ones, dt)

    def _cast(self, c: ColumnVal, to: T.DataType) -> ColumnVal:
        if c.dtype == to:
            return c
        if c.dtype.is_string_like and to.is_string_like:
            return ColumnVal(c.values, c.validity, to, c.dict)
        if c.dtype.is_dict_encoded or to.is_dict_encoded:
            raise TypeError(f"cast {c.dtype} -> {to} is not in this slice of the port")
        v, m = cast_values(c.values, c.validity, c.dtype, to)
        return ColumnVal(v, m, to)

    # ---- binary ops ----

    def _logic(self, op: str, l: ColumnVal, r: ColumnVal) -> ColumnVal:
        lv, rv = l.values.to(torch.bool), r.values.to(torch.bool)
        if op == "and":
            known = (l.validity & ~lv) | (r.validity & ~rv)  # a known False
            value = ~known & lv & rv
        else:
            known = (l.validity & lv) | (r.validity & rv)  # a known True
            value = known | (lv | rv)
        return ColumnVal(value, (l.validity & r.validity) | known, T.BOOL)

    def _compare(self, op: str, l: ColumnVal, r: ColumnVal) -> ColumnVal:
        valid = l.validity & r.validity
        if l.dtype.is_string_like or r.dtype.is_string_like:
            return self._compare_strings(op, l, r)
        if l.dtype.kind == T.TypeKind.DECIMAL or r.dtype.kind == T.TypeKind.DECIMAL:
            raise TypeError("decimal comparisons are not in this slice of the port")
        common = ir.numeric_common_type(l.dtype, r.dtype) if l.dtype != r.dtype else l.dtype
        lc, rc = self._cast(l, common), self._cast(r, common)
        return ColumnVal(_cmp_apply(op, lc.values, rc.values), valid, T.BOOL)

    def _compare_strings(self, op: str, l: ColumnVal, r: ColumnVal) -> ColumnVal:
        """Codes of both sides remapped onto one joint vocabulary; order
        compares use the joint vocabulary's UTF-8 byte-order ranks."""
        joint: dict = {}
        maps = []
        for d in (l.dict, r.dict):
            m = np.empty(len(d), dtype=np.int64)
            for i, s in enumerate(d):
                m[i] = joint.setdefault(s, len(joint))
            maps.append(torch.from_numpy(m).to(l.values.device))
        lu = maps[0][l.values.long().clamp(0, len(maps[0]) - 1)]
        ru = maps[1][r.values.long().clamp(0, len(maps[1]) - 1)]
        valid = l.validity & r.validity
        if op in ("eq", "neq"):
            return ColumnVal(lu == ru if op == "eq" else lu != ru, valid, T.BOOL)
        keys = list(joint)
        order = sorted(range(len(keys)), key=lambda i: _utf8_key(keys[i]))
        rank = np.empty(len(keys), dtype=np.int64)
        rank[order] = np.arange(len(keys))
        rk = torch.from_numpy(rank).to(l.values.device)
        return ColumnVal(_cmp_apply(op, rk[lu], rk[ru]), valid, T.BOOL)

    def _arith(self, op: str, l: ColumnVal, r: ColumnVal) -> ColumnVal:
        out = ir.arith_result_type(op, l.dtype, r.dtype)
        if out.kind == T.TypeKind.DECIMAL:
            raise TypeError("decimal arithmetic is not in this slice of the port")
        valid = l.validity & r.validity
        lv, rv = self._cast(l, out).values, self._cast(r, out).values
        if op == "add":
            v = lv + rv
        elif op == "sub":
            v = lv - rv
        elif op == "mul":
            v = lv * rv
        elif op in ("div", "mod"):
            zero = rv == 0
            safe = torch.where(zero, torch.ones_like(rv), rv)
            if op == "div":
                v = lv / safe if out.is_float else torch.div(lv, safe, rounding_mode="trunc")
            elif out.is_float:
                v = lv - torch.trunc(lv / safe) * safe  # Java % keeps the dividend's sign
            else:
                v = torch.fmod(lv, safe)
            valid = valid & ~zero
        else:
            raise ValueError(op)
        return ColumnVal(v, valid, out)


def _null_like(proto: ColumnVal) -> ColumnVal:
    return ColumnVal(torch.zeros_like(proto.values), torch.zeros_like(proto.validity),
                     proto.dtype, proto.dict)


def _gather_table(table: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """``table[code]`` per row: a host table per vocabulary entry gathered
    on the device by the dictionary codes."""
    t = torch.from_numpy(table).to(codes.device)
    return t[codes.long().clamp(0, len(table) - 1)]


def _like_to_regex(pattern: str, escape: str) -> "re.Pattern":
    """LIKE pattern -> anchored-by-fullmatch regex: % any run, _ one
    character, ``escape`` + c the literal c."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("".join(out), re.DOTALL)
