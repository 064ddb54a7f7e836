"""Expression evaluator: IR trees -> eager torch programs.

Port of the ``auron_tpu/exprs/eval.py`` subset the ported slices use:
Column, Literal, Cast (``exprs/cast.py``: fixed-width, decimal, string
vocabularies cast once per entry), BinaryOp (Kleene AND/OR, comparisons
incl. dictionary-string equality/order, arithmetic), Not, IsNull,
IsNotNull, If and Case (fixed-width or dictionary branches), Coalesce,
In, Like, ScalarFunc (dispatched through ``functions/registry.py``,
reference ``eval.py:121-125``) and the task-context expressions
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

Decimals (reference ``eval.py:172-569, 688-732, 814``): decimal64 is a
scaled int64 and its comparisons and arithmetic run on the device through
the checked kernels of ``decimal_math`` (overflow and division by zero
give NULL, HALF_UP rounding). A wide decimal (precision > 18) is a
dictionary of ``decimal.Decimal`` values: it compares exactly through
base-1e13 words of the unscaled value (host tables gathered by code), and
its arithmetic evaluates exactly once per vocabulary entry against a
constant, or once per distinct (left, right) value pair on the host,
regathered by code. A float operand makes either a float64 operation.
An int64 operand of a decimal64 comparison or arithmetic enters at scale
0 as it is (the reference casts it to decimal(20,0), a dictionary, and
would compare its codes).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.arrow_c import HostBatch
from auron_tpu_torch.columnar.batch import Batch, empty_dict, merge_vocab, object_array
from auron_tpu_torch.exprs import decimal_math as D
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.cast import cast_scalar, cast_string_dict, cast_values


@dataclass
class ColumnVal:
    values: torch.Tensor
    validity: torch.Tensor
    dtype: T.DataType
    dict: np.ndarray | None = None  # host vocabulary iff dtype.is_dict_encoded
    #: a non-NULL literal's value on the host (what row 0 decodes to), so a
    #: function reading a constant argument does not read the device
    const: object = None


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
        if isinstance(e, ir.HostUDF):
            return self._host_udf(e, b, memo)
        if isinstance(e, ir.ScalarFunc):
            from auron_tpu_torch.functions import registry

            args = [self._eval(a, b, memo) for a in e.args]
            return registry.dispatch(e.name, args, b.capacity, b.torch_device)
        raise TypeError(f"unsupported expression {type(e).__name__}")

    def _host_udf(self, e: ir.HostUDF, b: Batch, memo: dict) -> ColumnVal:
        """A host callback (``bridge/udf.py``, reference ``eval.py:155-166``):
        the argument columns leave the card in one batched read, the
        callback sees every slot (padding included) and its result comes
        back as one column; the batch's selection mask is kept."""
        from auron_tpu_torch.bridge.udf import evaluate_udf
        from auron_tpu_torch.columnar.batch import host_arrays

        args = [self._eval(a, b, memo) for a in e.args]
        cap = b.capacity
        schema = T.Schema(tuple(T.Field(f"a{i}", a.dtype, True) for i, a in enumerate(args)))
        result = evaluate_udf(e.name, HostBatch(schema, cap, tuple(host_arrays(args))), cap)
        out = Batch.from_host_arrow(
            HostBatch(T.Schema((T.Field("r", e.out_dtype, True),)), cap, (result,)),
            capacity=cap, device=b.torch_device)
        return ColumnVal(out.col_values(0), out.col_validity(0), e.out_dtype, out.dicts[0])

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
        branches in order) and their codes remapped; wide-decimal branches
        first widen to Spark's branch type (the most integer digits and the
        largest scale, bounded at 38) with HALF_UP; fixed-width branches are
        cast to their numeric common type."""
        if any(v.dtype.is_dict_encoded for v in vals):
            if not all(v.dtype.is_dict_encoded for v in vals):
                raise TypeError("mixed dictionary-encoded and fixed-width branches")
            first = vals[0].dtype
            dicts = [v.dict for v in vals]
            if first.kind == T.TypeKind.DECIMAL:
                import decimal as pydec

                s_max = max(v.dtype.scale for v in vals)
                i_max = max(v.dtype.precision - v.dtype.scale for v in vals)
                first = ir._bounded(i_max + s_max, s_max)
                q = pydec.Decimal(1).scaleb(-first.scale)
                with pydec.localcontext() as hp:
                    hp.prec = 100
                    dicts = [_vocab([e.quantize(q, rounding=pydec.ROUND_HALF_UP)
                                     if e is not None else None for e in d], first)
                             for d in dicts]
            unified, remaps = merge_vocab(dicts)
            if first.kind == T.TypeKind.DECIMAL and not any(len(d) for d in dicts):
                unified = empty_dict(first)
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
            d = empty_dict(dt) if dt.is_dict_encoded else None
            return ColumnVal(torch.zeros(cap, dtype=phys, device=device),
                             torch.zeros(cap, dtype=torch.bool, device=device), dt, d)
        ones = torch.ones(cap, dtype=torch.bool, device=device)
        if dt.is_dict_encoded:
            d = np.empty(1, dtype=object)
            d[0] = T.decimal_at_scale(e.value, dt.scale) if dt.is_wide_decimal else e.value
            return ColumnVal(torch.zeros(cap, dtype=torch.int32, device=device), ones, dt, d,
                             d[0] if dt.is_string_like else None)
        if dt.kind == T.TypeKind.DECIMAL:
            import decimal as pydec

            u = int(pydec.Decimal(str(e.value)).scaleb(dt.scale).quantize(pydec.Decimal(1)))
            return ColumnVal(torch.full((cap,), u, dtype=torch.int64, device=device), ones, dt,
                             const=u)
        return ColumnVal(torch.full((cap,), e.value, dtype=dt.physical_dtype(), device=device),
                         ones, dt, const=np.array(e.value, dtype=dt.numpy_dtype()).item())

    def _cast(self, c: ColumnVal, to: T.DataType) -> ColumnVal:
        if c.dtype == to:
            return c
        if c.dtype.is_dict_encoded and to.is_dict_encoded:
            return self._cast_dict_to_dict(c, to)
        if c.dtype.is_dict_encoded:
            if to.is_string_like:
                return ColumnVal(c.values, c.validity, to, c.dict)
            dvals, dok = cast_string_dict(c.dict, to)
            return ColumnVal(_gather_table(dvals, c.values),
                             c.validity & _gather_table(dok, c.values), to)
        if to.is_dict_encoded:
            return self._cast_plain_to_dict(c, to)
        v, m = cast_values(c.values, c.validity, c.dtype, to)
        return ColumnVal(v, m, to)

    def _cast_dict_to_dict(self, c: ColumnVal, to: T.DataType) -> ColumnVal:
        """Dictionary -> dictionary: cast the vocabulary on the host, keep the
        codes; an entry that does not cast makes its rows NULL."""
        if c.dtype.is_string_like and to.is_string_like:
            return ColumnVal(c.values, c.validity, to, c.dict)
        out = [cast_scalar(v, c.dtype, to) if v is not None else None for v in c.dict]
        ok = np.array([r is not None for r in out], dtype=bool)
        return ColumnVal(c.values, c.validity & _gather_table(ok, c.values), to,
                         _vocab(out, to))

    def _cast_plain_to_dict(self, c: ColumnVal, to: T.DataType) -> ColumnVal:
        """Fixed-width -> string/binary/wide decimal: the one cast that builds
        a vocabulary from data. One host read; the distinct values cast once
        each (floats deduplicated on their bit pattern, so -0.0 and 0.0 stay
        apart), the codes go back to the values' device."""
        vals = c.values.cpu().numpy()
        if vals.dtype.kind == "f":
            bits = vals.view(np.int32 if vals.dtype == np.float32 else np.int64)
            uniq_bits, inv = np.unique(bits, return_inverse=True)
            uniq = uniq_bits.view(vals.dtype)
        else:
            uniq, inv = np.unique(vals, return_inverse=True)
        ents = [cast_scalar(u.item(), c.dtype, to) for u in uniq]
        ok = np.array([x is not None for x in ents], dtype=bool)
        codes = torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(c.values.device)
        return ColumnVal(codes, c.validity & _gather_table(ok, codes), to, _vocab(ents, to))

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
        if l.dtype.is_wide_decimal or r.dtype.is_wide_decimal:
            return self._compare_wide_decimal(op, l, r)
        if l.dtype.kind == T.TypeKind.DECIMAL or r.dtype.kind == T.TypeKind.DECIMAL:
            if l.dtype.is_float or r.dtype.is_float:  # Spark: compares as double
                return ColumnVal(_cmp_apply(op, self._wide_as_float(l), self._wide_as_float(r)),
                                 valid, T.BOOL)
            lv, rv, (bad, lf, rf) = self._align_decimals(l, r)
            res = torch.where(bad, _cmp_apply(op, lf, rf), _cmp_apply(op, lv, rv))
            return ColumnVal(res, valid, T.BOOL)
        common = ir.numeric_common_type(l.dtype, r.dtype) if l.dtype != r.dtype else l.dtype
        lc, rc = self._cast(l, common), self._cast(r, common)
        return ColumnVal(_cmp_apply(op, lc.values, rc.values), valid, T.BOOL)

    def _decimal_side(self, cv: ColumnVal) -> tuple[torch.Tensor, int, torch.Tensor]:
        """(scaled int64 values, scale, validity) of a decimal64 or integer
        operand (an integer at scale 0, as it is)."""
        if cv.dtype.kind == T.TypeKind.DECIMAL:
            return cv.values, cv.dtype.scale, cv.validity
        if cv.dtype.is_integer:
            return cv.values.to(torch.int64), 0, cv.validity
        raise TypeError(f"no decimal operation with a {cv.dtype} operand")

    def _align_decimals(self, l: ColumnVal, r: ColumnVal):
        """Both sides at their common scale; where aligning overflows int64
        (enormous values) the comparison falls back to float64."""
        lv0, ls, _ = self._decimal_side(l)
        rv0, rs, _ = self._decimal_side(r)
        s = max(ls, rs)
        lv, lok = D.rescale(lv0, ls, s)
        rv, rok = D.rescale(rv0, rs, s)
        lf = lv0.to(torch.float64) * (10.0 ** (-ls))
        rf = rv0.to(torch.float64) * (10.0 ** (-rs))
        return lv, rv, (~(lok & rok), lf, rf)

    #: 13-digit words: 5 cover any wide unscaled value after alignment
    #: (<= 38 + 18 shift digits), each word int64-safe
    _DEC_WORD_BASE = 10**13
    _DEC_WORDS = 5

    def _compare_wide_decimal(self, op: str, l: ColumnVal, r: ColumnVal) -> ColumnVal:
        """Exact comparison when either side is a wide decimal: both sides as
        base-1e13 words of the unscaled value at the common scale (wide via
        host tables, narrow by exact device div/mod), compared from the top
        word down. A float side compares through float64."""
        valid = l.validity & r.validity
        if l.dtype.is_float or r.dtype.is_float:
            return ColumnVal(_cmp_apply(op, self._wide_as_float(l), self._wide_as_float(r)),
                             valid, T.BOOL)
        ls = l.dtype.scale if l.dtype.kind == T.TypeKind.DECIMAL else 0
        rs = r.dtype.scale if r.dtype.kind == T.TypeKind.DECIMAL else 0
        s = max(ls, rs)
        # the word count from the actual scale spread (decimal(38,0) against
        # decimal(38,38) aligns to 76 digits)
        need_digits = 38 + max(s - ls, s - rs)
        n_words = max(self._DEC_WORDS, -(-need_digits // 13) + 1)
        lw = self._decimal_words(l, s, n_words)
        rw = self._decimal_words(r, s, n_words)
        lt = torch.zeros_like(valid)
        eq = torch.ones_like(valid)
        for j in reversed(range(n_words)):
            lt = lt | (eq & (lw[j] < rw[j]))
            eq = eq & (lw[j] == rw[j])
        res = {"eq": eq, "neq": ~eq, "lt": lt, "lteq": lt | eq, "gt": ~lt & ~eq,
               "gteq": ~lt}[op]
        return ColumnVal(res, valid, T.BOOL)

    def _wide_as_float(self, cv: ColumnVal) -> torch.Tensor:
        if not cv.dtype.is_wide_decimal:
            if cv.dtype.kind == T.TypeKind.DECIMAL:
                return cv.values.to(torch.float64) * (10.0 ** -cv.dtype.scale)
            return cv.values.to(torch.float64)
        tab = np.zeros(max(len(cv.dict), 1), dtype=np.float64)
        for i, e in enumerate(cv.dict):
            if e is not None:
                tab[i] = float(e)
        return _gather_table(tab, cv.values)

    def _decimal_words(self, cv: ColumnVal, s: int, n_words: int | None = None) -> list:
        """Base-1e13 little-endian words of the unscaled value at scale ``s``
        (floored decomposition: lower words in [0, 1e13), the top word
        signed)."""
        W, BASE = n_words or self._DEC_WORDS, self._DEC_WORD_BASE
        if cv.dtype.is_wide_decimal:
            n = max(len(cv.dict), 1)
            tabs = np.zeros((W, n), dtype=np.int64)
            shift = 10 ** (s - cv.dtype.scale)
            for i, e in enumerate(cv.dict):
                if e is None:
                    continue
                u = T.unscaled_int(e, cv.dtype.scale) * shift
                for j in range(W - 1):
                    u, rem = divmod(u, BASE)
                    tabs[j, i] = rem
                tabs[W - 1, i] = u
            return [_gather_table(tabs[j], cv.values) for j in range(W)]
        # narrow side: scaled int64 at its own scale (an integer at scale 0),
        # shifted up by k = s - ns digits: word j = floor(v * 10^(k-13j)) mod
        # 1e13, without overflow by exact div/mod identities
        v = cv.values.to(torch.int64)
        ns = cv.dtype.scale if cv.dtype.kind == T.TypeKind.DECIMAL else 0
        k = s - ns
        words = []
        neg = v < 0
        sign_lo = torch.where(neg, torch.full_like(v, BASE - 1), torch.zeros_like(v))
        sign_top = torch.where(neg, torch.full_like(v, -1), torch.zeros_like(v))
        for j in range(W):
            e = k - 13 * j
            if -e > 18:
                # a shift past int64's 10^18: pure floored sign extension
                words.append(sign_top if j == W - 1 else sign_lo)
            elif j == W - 1:
                words.append(torch.div(v, 10 ** (-e), rounding_mode="floor")
                             if e < 0 else v * 10**e)
            elif e >= 13:
                words.append(torch.zeros_like(v))
            elif e >= 0:
                words.append(torch.remainder(v, 10 ** (13 - e)) * 10**e)
            else:
                words.append(torch.remainder(torch.div(v, 10 ** (-e), rounding_mode="floor"),
                                             BASE))
        return words

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
        if l.dtype.is_wide_decimal or r.dtype.is_wide_decimal:
            if l.dtype.is_float or r.dtype.is_float:
                # Spark: decimal (op) double computes in double
                fv, fok = _float_arith(op, self._wide_as_float(l), self._wide_as_float(r))
                return ColumnVal(fv, l.validity & r.validity & fok, T.FLOAT64)
            out = self._wide_literal_arith(op, l, r)
            return out if out is not None else self._wide_pair_arith(op, l, r)
        out = ir.arith_result_type(op, l.dtype, r.dtype)
        valid = l.validity & r.validity
        if out.kind == T.TypeKind.DECIMAL:
            lv, ls, lm = self._decimal_side(l)
            rv, rs, rm = self._decimal_side(r)
            fn = {"add": D.add, "sub": D.sub, "mul": D.mul, "div": D.div, "mod": D.mod}[op]
            v, ok = fn(lv, ls, rv, rs, out.precision, out.scale)
            return ColumnVal(v, valid & lm & rm & ok, out)
        lv, rv = self._cast(l, out).values, self._cast(r, out).values
        if op == "add":
            v = lv + rv
        elif op == "sub":
            v = lv - rv
        elif op == "mul":
            v = lv * rv
        elif op in ("div", "mod"):
            zero = rv == 0
            if out.is_float:
                safe = torch.where(zero, torch.ones_like(rv), rv)
                # Java % keeps the dividend's sign
                v = lv / safe if op == "div" else lv - torch.trunc(lv / safe) * safe
            else:
                safe, _ = D._safe_divisor(lv, rv)
                v = D.tdiv(lv, safe) if op == "div" else torch.fmod(lv, safe)
            valid = valid & ~zero
        else:
            raise ValueError(op)
        return ColumnVal(v, valid, out)

    def _wide_literal_arith(self, op: str, l: ColumnVal, r: ColumnVal) -> ColumnVal | None:
        """Exact wide-decimal arithmetic against a constant (a one-entry
        vocabulary, or a narrow side holding one value): the op evaluates
        once per vocabulary entry with Python Decimals. None when neither
        side is constant."""
        import decimal as pydec

        def const_of(cv: ColumnVal):
            if cv.dtype.is_wide_decimal:
                return cv.dict[0] if cv.dict is not None and len(cv.dict) == 1 else None
            if cv.dtype.kind not in (T.TypeKind.DECIMAL, T.TypeKind.INT8, T.TypeKind.INT16,
                                     T.TypeKind.INT32, T.TypeKind.INT64):
                return None
            host = cv.values.cpu().numpy()
            if host.size == 0 or not (host == host.flat[0]).all():
                return None
            v = int(host.flat[0])
            if cv.dtype.kind == T.TypeKind.DECIMAL:
                return T.decimal_from_unscaled(v, cv.dtype.scale)
            return pydec.Decimal(v)

        wide, other, wide_is_left = (l, r, True) if l.dtype.is_wide_decimal else (r, l, False)
        const = const_of(other)
        if const is None or wide.dict is None:
            return None
        out_t = ir.arith_result_type(op, l.dtype, r.dtype)
        q = pydec.Decimal(1).scaleb(-out_t.scale)
        bound = pydec.Decimal(10) ** (out_t.precision - out_t.scale)
        entries: list = []
        ok_tab = np.zeros(max(len(wide.dict), 1), dtype=bool)
        with pydec.localcontext() as hp:
            hp.prec = 100
            for i, e in enumerate(wide.dict):
                v = None
                if e is not None:
                    a, b = (e, const) if wide_is_left else (const, e)
                    v = _decimal_binop_exact(op, a, b, q, bound)
                entries.append(pydec.Decimal(0) if v is None else v)
                ok_tab[i] = v is not None
        return _materialize_decimal_entries(entries, ok_tab, wide.values,
                                            l.validity & r.validity, out_t)

    def _wide_pair_arith(self, op: str, l: ColumnVal, r: ColumnVal) -> ColumnVal:
        """Exact arithmetic over two columns, one of them wide: the result is
        a function of the (left value, right value) pair, so both columns
        come to the host once, the distinct pairs evaluate exactly with
        Python Decimals, and the pair index gathers them back on the
        device."""
        import decimal as pydec

        def host_side(cv: ColumnVal):
            vals = cv.values.cpu().numpy().astype(np.int64)
            if cv.dtype.is_wide_decimal:
                entries = cv.dict
                vals = np.clip(vals, 0, max(len(entries) - 1, 0))
                return vals, lambda c: entries[int(c)]
            if cv.dtype.kind == T.TypeKind.DECIMAL:
                sc = cv.dtype.scale
                return vals, lambda v: T.decimal_from_unscaled(int(v), sc)
            return vals, lambda v: pydec.Decimal(int(v))

        lv, lfn = host_side(l)
        rv, rfn = host_side(r)
        uniq, inv = np.unique(np.stack([lv, rv], axis=1), axis=0, return_inverse=True)
        out_t = ir.arith_result_type(op, l.dtype, r.dtype)
        q = pydec.Decimal(1).scaleb(-out_t.scale)
        bound = pydec.Decimal(10) ** (out_t.precision - out_t.scale)
        entries: list = []
        ok_tab = np.zeros(max(len(uniq), 1), dtype=bool)
        with pydec.localcontext() as hp:
            hp.prec = 100
            for i, (a_raw, b_raw) in enumerate(uniq):
                a, b = lfn(a_raw), rfn(b_raw)
                v = None if a is None or b is None else _decimal_binop_exact(op, a, b, q, bound)
                entries.append(pydec.Decimal(0) if v is None else v)
                ok_tab[i] = v is not None
        codes = torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(l.values.device)
        return _materialize_decimal_entries(entries, ok_tab, codes, l.validity & r.validity,
                                            out_t)


def _null_like(proto: ColumnVal) -> ColumnVal:
    return ColumnVal(torch.zeros_like(proto.values), torch.zeros_like(proto.validity),
                     proto.dtype, proto.dict)


def _vocab(entries: list, dtype: T.DataType) -> np.ndarray:
    """A vocabulary (numpy object array) of cast or computed entries; an
    entry that failed (None: its rows are NULL) holds the type's filler,
    and a wide decimal's entries sit at its scale."""
    if not entries:
        return empty_dict(dtype)
    filler = empty_dict(dtype)[0]
    if dtype.is_nested:  # lists of one length would broadcast in a slice fill
        return object_array([e if e is not None else filler for e in entries])
    out = np.empty(len(entries), dtype=object)
    if dtype.is_wide_decimal:
        out[:] = [T.decimal_at_scale(e, dtype.scale) if e is not None else filler
                  for e in entries]
    else:
        out[:] = [e if e is not None else filler for e in entries]
    return out


def _materialize_decimal_entries(entries, ok_tab, codes, valid, out_t) -> ColumnVal:
    """Decimal entry table + per-entry ok mask + device codes -> ColumnVal:
    a wide result keeps the codes against a fresh vocabulary, a narrow one
    gathers scaled int64 values."""
    valid = valid & _gather_table(ok_tab, codes)
    if out_t.is_wide_decimal:
        return ColumnVal(codes, valid, out_t, _vocab(entries, out_t))
    tab = np.zeros(max(len(entries), 1), dtype=np.int64)
    for i, v in enumerate(entries):
        tab[i] = T.unscaled_int(v, out_t.scale)
    return ColumnVal(_gather_table(tab, codes), valid, out_t)


def _decimal_binop_exact(op: str, a, b, q, bound):
    """One exact Spark-decimal op on Python Decimals: HALF_UP at the result
    scale, overflow or division by zero -> None (NULL). Decimal % keeps the
    dividend's sign, as Spark's."""
    import decimal as pydec

    try:
        if op == "add":
            v = a + b
        elif op == "sub":
            v = a - b
        elif op == "mul":
            v = a * b
        elif op in ("div", "mod"):
            if b == 0:
                return None
            v = a / b if op == "div" else a % b
        else:
            raise ValueError(op)
        v = v.quantize(q, rounding=pydec.ROUND_HALF_UP)
    except (pydec.InvalidOperation, ZeroDivisionError):
        return None
    if abs(v) >= bound:
        return None
    return v


def _float_arith(op: str, lf: torch.Tensor, rf: torch.Tensor):
    """float64 arithmetic with Spark's semantics: (values, ok)."""
    ok = torch.ones_like(lf, dtype=torch.bool)
    if op == "add":
        return lf + rf, ok
    if op == "sub":
        return lf - rf, ok
    if op == "mul":
        return lf * rf, ok
    zero = rf == 0
    safe = torch.where(zero, torch.ones_like(rf), rf)
    if op == "div":
        return lf / safe, ok & ~zero
    if op == "mod":
        return lf - torch.trunc(lf / safe) * safe, ok & ~zero
    raise ValueError(op)


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
