"""CREATE STREAMING VIEW -> StreamingPlan (port of
``auron_tpu/stream/lowering.py``).

Rides the batch SQL front end end-to-end: `sql/parser.py`
``parse_streaming_view`` produces ordinary AST, the binder resolves
names and aggregate calls against the source record schema EXTENDED
with two virtual columns — ``window_start`` / ``window_end`` (INT64
epoch-ms), which exist only in the SELECT list — and this module gives
streaming meaning to the pieces the batch lowering has none for:

- GROUP BY must carry exactly one window call: ``TUMBLE(ts, INTERVAL
  size)`` or ``HOP(ts, INTERVAL slide, INTERVAL size)``; every other
  GROUP BY expression is a group key;
- the event-time column must be INT64 (epoch milliseconds) or
  TIMESTAMP (microseconds; scaled to ms at the source boundary);
- WHERE conjuncts become the fused Calc chain's predicates — they run
  per micro-batch BEFORE windowing, so they may not reference the
  virtual window columns or aggregates;
- SELECT items are group keys, window bounds, or aggregate calls —
  anything else has no deterministic per-window value.

The plan structures the continuous query; no stream.* knob is read
here (plan-affecting knobs live in sql/digest.py PLAN_KNOBS, and the
stream knobs deliberately shape the RUNTIME — poll size, barriers —
never the plan).
"""

from __future__ import annotations

from dataclasses import dataclass

from auron_tpu_torch import types as T
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.sql import sqlast as A
from auron_tpu_torch.sql.binder import (
    AggCall,
    Bound,
    ExprBinder,
    Scope,
    agg_slot,
    collect_aggs,
    contains_agg,
    is_agg_call,
)
from auron_tpu_torch.sql.diagnostics import SqlAnalysisError, SqlUnsupported
from auron_tpu_torch.sql.parser import parse_streaming_view
from auron_tpu_torch.stream.windows import WindowSpec, interval_ms

_WINDOW_FUNCS = ("tumble", "hop")


@dataclass(frozen=True)
class OutputCol:
    """One SELECT item of the continuous query."""

    kind: str   # key | agg | window_start | window_end
    index: int  # key/agg slot (0 for window bounds)
    name: str
    dtype: T.DataType


@dataclass
class StreamingPlan:
    """Everything the pipeline needs, bound and validated."""

    name: str
    source_table: str
    schema: T.Schema            # source record schema (no virtual cols)
    ts_index: int               # event-time column
    ts_scale_to_ms: int         # divide raw values by this to get ms
    window: WindowSpec
    watermark_index: int
    watermark_delay_ms: int
    predicates: list[ir.Expr]   # WHERE conjuncts (pre-window)
    keys: list[Bound]           # group keys (minus the window call)
    aggs: list[AggCall]
    output: list[OutputCol]

    @property
    def agg_funcs(self) -> list[str]:
        return [a.func for a in self.aggs]


def _split_conjuncts(e: A.Expr) -> list[A.Expr]:
    if isinstance(e, A.BinOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _refuses_virtual(bound_e: ir.Expr, width: int, what: str,
                     pos) -> None:
    for n in ir.walk(bound_e):
        if isinstance(n, ir.Column) and n.index >= width:
            raise SqlAnalysisError(
                f"{what} may not reference window_start/window_end "
                "(window bounds exist only in the SELECT list)", pos)


def _ts_scale(dtype: T.DataType, pos) -> int:
    if dtype == T.INT64:
        return 1        # epoch milliseconds by contract
    if dtype == T.TIMESTAMP:
        return 1000     # microseconds -> ms
    raise SqlUnsupported(
        "event-time column type",
        f"window time column must be INT64 (epoch ms) or TIMESTAMP, "
        f"got {dtype}", pos)


def _interval_arg(e: A.Expr, what: str) -> int:
    if not isinstance(e, A.IntervalLit):
        raise SqlAnalysisError(
            f"{what} must be an INTERVAL literal",
            getattr(e, "pos", None))
    return interval_ms(e.n, e.unit)


def lower_streaming_view(text_or_ast, schema: T.Schema) -> StreamingPlan:
    """Bind and lower one CREATE STREAMING VIEW against the source
    record schema."""
    v = (text_or_ast if isinstance(text_or_ast, A.StreamingView)
         else parse_streaming_view(text_or_ast))
    q = v.query
    if q.ctes or q.order_by or q.limit is not None:
        raise SqlUnsupported(
            "streaming WITH/ORDER BY/LIMIT",
            "a continuous query has no end to order or limit", q.pos)
    sel = q.body
    if not isinstance(sel, A.Select):
        raise SqlUnsupported("streaming UNION",
                             "single SELECT only", q.pos)
    if sel.distinct or sel.having is not None:
        raise SqlUnsupported("streaming DISTINCT/HAVING",
                             "outside the streaming subset", sel.pos)
    if len(sel.from_) != 1 or not isinstance(sel.from_[0], A.TableName):
        raise SqlUnsupported(
            "streaming FROM",
            "exactly one source topic (joins are batch-only)", sel.pos)
    source = sel.from_[0]

    width = len(schema)
    vschema = T.Schema.of(
        *schema,
        T.Field("window_start", T.INT64), T.Field("window_end", T.INT64))
    scope = Scope()
    scope.add(source.alias or source.name, source.name, vschema, 0)
    binder = ExprBinder(scope)

    # -- window call + keys out of GROUP BY ---------------------------------
    window = None
    ts_index = ts_scale = None
    keys: list[Bound] = []
    for g in sel.group_by:
        if isinstance(g, A.FuncCall) and g.name in _WINDOW_FUNCS:
            if window is not None:
                raise SqlAnalysisError("more than one window call", g.pos)
            if not g.args:
                raise SqlAnalysisError(f"{g.name} needs arguments", g.pos)
            tsb = binder.bind(g.args[0])
            if not isinstance(tsb.e, ir.Column) or tsb.e.index >= width:
                raise SqlAnalysisError(
                    f"{g.name} time argument must be a source column", g.pos)
            ts_index, ts_scale = tsb.e.index, _ts_scale(tsb.dtype, g.pos)
            if g.name == "tumble":
                if len(g.args) != 2:
                    raise SqlAnalysisError("TUMBLE(ts, size)", g.pos)
                window = WindowSpec.tumbling(
                    _interval_arg(g.args[1], "window size"))
            else:
                if len(g.args) != 3:
                    raise SqlAnalysisError("HOP(ts, slide, size)", g.pos)
                slide = _interval_arg(g.args[1], "hop slide")
                size = _interval_arg(g.args[2], "hop size")
                if slide <= 0 or size % slide:
                    raise SqlUnsupported(
                        "hop window shape",
                        f"size ({size}ms) must be a positive multiple of "
                        f"slide ({slide}ms)", g.pos)
                window = WindowSpec.hopping(slide, size)
            continue
        kb = binder.bind(g)
        _refuses_virtual(kb.e, width, "GROUP BY key", getattr(g, "pos", None))
        if contains_agg(g):
            raise SqlAnalysisError("aggregate in GROUP BY", g.pos)
        keys.append(kb)
    if window is None:
        raise SqlUnsupported(
            "unwindowed streaming GROUP BY",
            "a continuous aggregate needs TUMBLE(...) or HOP(...) in "
            "GROUP BY (emission requires closable windows)", sel.pos)

    # -- watermark ----------------------------------------------------------
    if v.watermark is not None:
        wb = binder.bind(v.watermark.col)
        if not isinstance(wb.e, ir.Column) or wb.e.index >= width:
            raise SqlAnalysisError(
                "watermark column must be a source column", v.watermark.pos)
        _ts_scale(wb.dtype, v.watermark.pos)
        wm_index = wb.e.index
        wm_delay = interval_ms(v.watermark.delay.n, v.watermark.delay.unit)
    else:
        wm_index, wm_delay = ts_index, 0

    # -- WHERE --------------------------------------------------------------
    predicates: list[ir.Expr] = []
    if sel.where is not None:
        for c in _split_conjuncts(sel.where):
            if contains_agg(c):
                raise SqlAnalysisError(
                    "aggregate in WHERE (no HAVING in the streaming "
                    "subset)", getattr(c, "pos", None))
            pb = binder.bind(c)
            if pb.dtype.kind != T.TypeKind.BOOL:
                raise SqlAnalysisError(
                    f"WHERE expects a boolean, got {pb.dtype}",
                    getattr(c, "pos", None))
            _refuses_virtual(pb.e, width, "WHERE", getattr(c, "pos", None))
            predicates.append(pb.e)

    # -- SELECT items -------------------------------------------------------
    item_exprs = [it.expr for it in sel.items]
    aggs = collect_aggs(item_exprs, binder)
    for a in aggs:
        if a.arg is not None:
            _refuses_virtual(a.arg.e, width, "aggregate argument",
                             a.ast.pos)
    output: list[OutputCol] = []
    for it in sel.items:
        e = it.expr
        if isinstance(e, A.Ident) and e.parts[-1].lower() in (
                "window_start", "window_end"):
            kind = e.parts[-1].lower()
            output.append(OutputCol(kind, 0, it.alias or kind, T.INT64))
            continue
        if is_agg_call(e):
            slot = agg_slot(aggs, e, binder)
            output.append(OutputCol(
                "agg", slot, it.alias or e.name, aggs[slot].out_dtype))
            continue
        b = binder.bind(e)
        for i, kb in enumerate(keys):
            if kb.e == b.e:
                output.append(OutputCol(
                    "key", i, it.alias or b.name or f"k{i}", kb.dtype))
                break
        else:
            raise SqlAnalysisError(
                "SELECT item is neither a group key, a window bound, nor "
                "an aggregate", getattr(e, "pos", None))

    return StreamingPlan(
        name=v.name, source_table=source.name, schema=schema,
        ts_index=ts_index, ts_scale_to_ms=ts_scale, window=window,
        watermark_index=wm_index, watermark_delay_ms=wm_delay,
        predicates=predicates, keys=keys, aggs=aggs, output=output)
