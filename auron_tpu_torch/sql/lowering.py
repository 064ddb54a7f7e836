"""Lowering: bound SQL AST -> executable protobuf plans.

The last stage of the frontend (parser -> binder -> HERE), emitting the
same ``plan/builders.py`` protos the hand-built gate classes ship, so
everything downstream — planner, operators, AQE, exchanges, metrics — is
exercised unchanged by real query text.

A query lowers into up to TWO stages, mirroring how the existing class
pipelines are staged by hand (models/tpcds.py):

- ``distributed``: runs at mesh width through
  :class:`~auron_tpu_torch.parallel.mesh_driver.MeshQueryDriver`. Scans read
  per-partition resources, grouped aggregation is the classic
  partial -> ``mesh_exchange`` (hash on the group keys) -> final
  pipeline, joins probe the partitioned side against REPLICATED build
  sides (see below).
- ``collect`` (optional): one single-partition task over the gathered
  distributed output — the global merge of a scalar aggregate (plus its
  HAVING/projection), ORDER BY, LIMIT. Omitted when nothing needs a
  total view.

Distribution discipline (the part a hand author decides per query; here
it is a rule): exactly ONE base relation — the first element of the
highest-cardinality FROM item (the "probe seed") — reads the PARTITIONED
resource ``sql:<table>``; every other relation reads the replicated
``sql:<table>:all`` view, because it ends up on the build side of a join
(each partition must see all build rows) or inside a replicated subplan.
Replicated subplans never contain a ``mesh_exchange`` (each partition
holds a full copy; exchanging copies would merge duplicates), so grouped
aggregation there chains partial -> final in-task.

Anything the rules cannot lower EXACTLY raises
:class:`~auron_tpu_torch.sql.diagnostics.SqlUnsupported` with the construct
name and source position — never a silently wrong plan. Determinism is
load-bearing (plan-stability goldens diff ``explain_proto`` output):
every container is a list or insertion-ordered dict keyed by parse
order, and generated names (``_g0``/``_a0``/``_c0`` ordinals) are pure
functions of position.

Port of ``auron_tpu/sql/lowering.py``: the plans are the port's own
builders' messages (``plan/builders.py`` over ``proto/wire.py``, no
``google.protobuf``), and ``_inter_schema`` builds the aggregate through
the port's planner, which allocates nothing on a device. Binding and
lowering run under the ``sql.bind`` and ``sql.lower`` spans.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from auron_tpu_torch import types as T
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.ops.sortkeys import SortSpec
from auron_tpu_torch.plan import builders as B
from auron_tpu_torch import proto as pb
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
    referenced_elements,
)
from auron_tpu_torch.sql.catalog import Catalog
from auron_tpu_torch.sql.diagnostics import (
    NO_POS,
    SourcePos,
    SqlAnalysisError,
    SqlUnsupported,
)

#: resource id of the collect stage's input (the gathered distributed output)
STAGE_RID = "sql:__stage__"


def table_rid(table: str, replicated: bool) -> str:
    return f"sql:{table}:all" if replicated else f"sql:{table}"


@dataclass(frozen=True)
class TableUse:
    """One base-table resource a lowered plan scans."""

    table: str
    rid: str
    replicated: bool


@dataclass
class LoweredQuery:
    """The executable form of one SQL text (see module docstring)."""

    distributed: pb.PhysicalPlanNode
    collect: Optional[pb.PhysicalPlanNode]
    schema: T.Schema                  # final output schema (names + dtypes)
    stage_schema: Optional[T.Schema]  # distributed output when collect runs
    tables: tuple[TableUse, ...]      # every scanned resource
    n_parts: int


def lower(query: A.Query, catalog: Catalog, n_parts: int = 2) -> LoweredQuery:
    """Lower one parsed query against a catalog. Raises SqlUnsupported /
    SqlAnalysisError (both positioned) instead of approximating."""
    from auron_tpu_torch import obs

    with obs.span("sql.lower", cat="sql"):
        return _Lowering(catalog, n_parts).lower_top(query)


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


def split_conjuncts(e: Optional[A.Expr]) -> list[A.Expr]:
    """Flatten a WHERE/ON tree at top-level ANDs, in source order."""
    if e is None:
        return []
    if isinstance(e, A.BinOp) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def _pos(e: A.Node) -> SourcePos:
    return getattr(e, "pos", NO_POS)


#: a deferred collect-stage build step: (node, fields) -> (node, fields)
_Step = Callable[["pb.PhysicalPlanNode", list], tuple]


@dataclass
class _Pipe:
    """A lowered SELECT pipeline: the distributed plan + its output
    fields + steps that must run in the single-task collect stage."""

    plan: pb.PhysicalPlanNode
    fields: list[T.Field]
    deferred: list[_Step] = field(default_factory=list)

    def apply(self, step: _Step) -> None:
        """Run `step` in the distributed plan if nothing is deferred yet,
        else queue it for the collect stage (order-preserving)."""
        if self.deferred:
            self.deferred.append(step)
        else:
            self.plan, self.fields = step(self.plan, self.fields)


@dataclass
class _Sub:
    """A lowered subquery (derived table / CTE body / IN-subquery)."""

    plan: pb.PhysicalPlanNode
    fields: list[T.Field]
    est: int  # max base-table cardinality inside (drives probe seeding)


@dataclass
class _Conj:
    """One bound WHERE/ON conjunct."""

    ast: A.Expr
    bound: Bound
    refs: frozenset[int]
    used: bool = False


@dataclass
class _Elem:
    """One FROM element during select lowering."""

    index: int                      # element id (= FROM order)
    rel: A.Node                     # TableName | DerivedTable
    alias: str
    table: str                      # "" for derived/CTE
    schema: T.Schema
    join_kind: Optional[str]        # None (item head / comma), inner, left
    on: Optional[A.Expr]
    sub: Optional[_Sub] = None      # replicated lowering (derived/CTE)
    subquery: Optional[A.Query] = None  # AST, for probe re-lowering
    est: int = 0
    pushed: list[ir.Expr] = field(default_factory=list)  # element-local preds


def _inter_schema(agg_node: pb.PhysicalPlanNode) -> T.Schema:
    from auron_tpu_torch.plan.planner import plan_from_proto

    return plan_from_proto(agg_node).inter_schema


class _PostAggBinder(ExprBinder):
    """ExprBinder that maps aggregate calls to NEGATIVE sentinel column
    indices (-(slot+1)); ``_to_post_space`` rewrites sentinels and group
    keys into the [keys..., aggs...] output layout of the final agg."""

    def __init__(self, scope: Scope, aggs: list[AggCall], base: ExprBinder):
        super().__init__(scope)
        self._aggs = aggs
        self._base = base

    def _bind_FuncCall(self, e: A.FuncCall) -> Bound:
        if is_agg_call(e):
            slot = agg_slot(self._aggs, e, self._base)
            return Bound(ir.Column(-(slot + 1), e.name),
                         self._aggs[slot].out_dtype)
        return super()._bind_FuncCall(e)


def _to_post_space(e: ir.Expr, key_irs: list[ir.Expr], key_names: list[str],
                   n_keys: int, pos: SourcePos) -> ir.Expr:
    """Rewrite a sentinel-bearing scope-space expression into the post-agg
    layout. A residual real Column means the expression reads a column
    that is neither grouped nor aggregated."""
    import dataclasses

    def rec(n):
        if isinstance(n, ir.Expr):
            for i, kir in enumerate(key_irs):
                if n == kir:
                    return ir.Column(i, key_names[i])
        if isinstance(n, ir.Column):
            if n.index < 0:
                return ir.Column(n_keys + (-n.index - 1), n.name)
            raise SqlAnalysisError(
                f"column {n.name or '#%d' % n.index!s} is neither grouped "
                f"nor aggregated", pos)
        if isinstance(n, ir.Expr):
            changes = {}
            for f_ in dataclasses.fields(n):
                old = getattr(n, f_.name)
                new = rec(old)
                if new is not old:
                    changes[f_.name] = new
            return dataclasses.replace(n, **changes) if changes else n
        if isinstance(n, tuple):
            new = tuple(rec(x) for x in n)
            return n if all(a is b for a, b in zip(new, n)) else new
        return n

    return rec(e)


def _expr_nullable(e: ir.Expr, fields: list[T.Field]) -> bool:
    """Conservative output nullability for a projected expression."""
    if isinstance(e, ir.Column):
        return fields[e.index].nullable if 0 <= e.index < len(fields) else True
    if isinstance(e, ir.Literal):
        return e.value is None
    return True


def _and_all(parts: list[ir.Expr]) -> Optional[ir.Expr]:
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = ir.BinaryOp("and", out, p)
    return out


def _widen_pair(lk: ir.Expr, lt: T.DataType, rk: ir.Expr, rt: T.DataType,
                pos: SourcePos, what: str) -> tuple[ir.Expr, ir.Expr]:
    """ONE numeric-widening rule for every equi-key pairing (ON/WHERE
    equi joins and IN-subquery semi joins): both sides cast to
    numeric_common_type, anything else refuses loudly."""
    if lt == rt:
        return lk, rk
    if lt.is_numeric and rt.is_numeric:
        common = ir.numeric_common_type(lt, rt)
        if lt != common:
            lk = ir.Cast(lk, common)
        if rt != common:
            rk = ir.Cast(rk, common)
        return lk, rk
    raise SqlUnsupported(f"{what} types {lt} and {rt}", "", pos)


def _scan_rids(node: pb.PhysicalPlanNode) -> set:
    """Every memory_scan resource_id reachable in a proto plan tree."""
    which = node.WhichOneof("plan")
    inner = getattr(node, which)
    out = set()
    if which == "memory_scan":
        out.add(inner.resource_id)
    if which == "union":
        for c in inner.children:
            out |= _scan_rids(c)
    else:
        for f in ("child", "left", "right"):
            try:
                present = inner.HasField(f)
            except ValueError:
                continue
            if present:
                out |= _scan_rids(getattr(inner, f))
    return out


# ---------------------------------------------------------------------------
# the lowering proper
# ---------------------------------------------------------------------------


class _Lowering:
    def __init__(self, catalog: Catalog, n_parts: int):
        self.catalog = catalog
        self.n_parts = int(n_parts)
        self._tables: dict[str, TableUse] = {}  # rid -> use, insertion order

    # -- entry points --------------------------------------------------------

    def lower_top(self, q: A.Query) -> LoweredQuery:
        ctes = self._cte_env({}, q.ctes)
        if isinstance(q.body, A.UnionAll):
            pipe = self._lower_union(q.body, None, False, ctes,
                                     q.order_by, q.limit)
        else:
            pipe = self.lower_select(q.body, None, False, ctes,
                                     q.order_by, q.limit)
        out_fields = pipe.fields
        collect = None
        stage_schema = None
        if pipe.deferred:
            stage_schema = T.Schema(tuple(pipe.fields))
            node: pb.PhysicalPlanNode = B.memory_scan(stage_schema, STAGE_RID)
            fields = pipe.fields
            for step in pipe.deferred:
                node, fields = step(node, fields)
            collect = node
            out_fields = fields
        # Prune table uses no emitted scan references: probe-seed derived
        # tables are lowered replicated first (schema discovery) and
        # re-lowered partitioned, and the discarded phase-1 plan may be
        # the only user of its replicated rids — shipping those would
        # upload full table copies nothing reads.
        used = _scan_rids(pipe.plan)
        if collect is not None:
            used |= _scan_rids(collect)
        return LoweredQuery(
            distributed=pipe.plan,
            collect=collect,
            schema=T.Schema(tuple(out_fields)),
            stage_schema=stage_schema,
            tables=tuple(u for r, u in self._tables.items() if r in used),
            n_parts=self.n_parts,
        )

    def _cte_env(self, outer: dict, ctes: tuple[A.Cte, ...]) -> dict:
        env = dict(outer)
        for c in ctes:
            env[c.name.lower()] = A.Query(c.body, pos=c.pos)
        return env

    def _use(self, table: str, replicated: bool) -> str:
        rid = table_rid(table, replicated)
        if rid not in self._tables:
            self._tables[rid] = TableUse(table, rid, replicated)
        return rid

    # -- subqueries ----------------------------------------------------------

    def lower_subquery(self, q: A.Query, outer: Optional[Scope],
                       repl: bool, ctes: dict) -> _Sub:
        env = self._cte_env(ctes, q.ctes)
        order_by: tuple = ()
        limit = None
        if q.limit is not None:
            if not repl:
                raise SqlUnsupported(
                    "limit in a derived table",
                    "a partitioned subplan has no total row order", q.pos)
            order_by, limit = q.order_by, q.limit
        est = [0]
        if isinstance(q.body, A.UnionAll):
            pipe = self._lower_union(q.body, outer, repl, env, order_by,
                                     limit, est_out=est)
        else:
            pipe = self.lower_select(q.body, outer, repl, env, order_by,
                                     limit, est_out=est)
        if pipe.deferred:
            raise SqlUnsupported(
                "scalar aggregate in a derived table",
                "needs a global merge; only the top-level query has one",
                q.pos)
        return _Sub(pipe.plan, pipe.fields, est[0])

    # -- union ---------------------------------------------------------------

    def _lower_union(self, u: A.UnionAll, outer: Optional[Scope], repl: bool,
                     ctes: dict, order_by=(), limit=None,
                     est_out: Optional[list] = None) -> _Pipe:
        branches: list[_Pipe] = []
        est = [0]
        for sel in u.branches:
            p = self.lower_select(sel, outer, repl, ctes, est_out=est)
            if p.deferred:
                raise SqlUnsupported(
                    "scalar aggregate in a union branch",
                    "needs a global merge", sel.pos)
            branches.append(p)
        if est_out is not None:
            est_out[0] = max(est_out[0], est[0])
        first = branches[0]
        width = len(first.fields)
        for p in branches[1:]:
            if len(p.fields) != width:
                raise SqlAnalysisError(
                    f"UNION ALL branch arity {len(p.fields)} != {width}",
                    u.pos)
        # common column types; numeric widening only
        out_fields: list[T.Field] = []
        for i in range(width):
            dt = first.fields[i].dtype
            nullable = first.fields[i].nullable
            for p in branches[1:]:
                bt = p.fields[i].dtype
                nullable = nullable or p.fields[i].nullable
                if bt != dt:
                    if bt.is_numeric and dt.is_numeric:
                        dt = ir.numeric_common_type(dt, bt)
                    else:
                        raise SqlUnsupported(
                            f"union over {dt} and {bt}",
                            f"column {first.fields[i].name!r}", u.pos)
            out_fields.append(T.Field(first.fields[i].name, dt, nullable))
        kids = []
        for p in branches:
            if all(f.dtype == o.dtype for f, o in zip(p.fields, out_fields)):
                kids.append(p.plan)
            else:
                exprs = [
                    (ir.Column(i, f.name) if f.dtype == o.dtype
                     else ir.Cast(ir.Column(i, f.name), o.dtype), o.name)
                    for i, (f, o) in enumerate(zip(p.fields, out_fields))
                ]
                kids.append(B.project(p.plan, exprs))
        pipe = _Pipe(B.union(kids), out_fields)
        if order_by:
            self._attach_order(pipe, order_by, limit, repl, out_fields,
                               item_irs=None, rewrite=None)
        elif limit is not None:
            self._attach_limit(pipe, limit, repl)
        return pipe

    # -- select --------------------------------------------------------------

    def lower_select(self, sel: A.Select, outer: Optional[Scope], repl: bool,
                     ctes: dict, order_by=(), limit=None,
                     est_out: Optional[list] = None) -> _Pipe:
        if not sel.from_:
            raise SqlUnsupported("select without FROM",
                                 "constant queries", sel.pos)
        from auron_tpu_torch import obs

        scope = Scope(outer=outer)
        elems: list[_Elem] = []
        items: list[list[_Elem]] = []  # per top-level FROM item
        with obs.span("sql.bind", cat="sql"):
            for item_ref in sel.from_:
                group: list[_Elem] = []
                for rel, kind, on in self._flatten_ref(item_ref):
                    e = self._register(rel, kind, on, scope, len(elems), ctes)
                    elems.append(e)
                    group.append(e)
                items.append(group)
        if est_out is not None:
            est_out[0] = max([est_out[0]] + [e.est for e in elems])

        binder = ExprBinder(scope)

        # ---- WHERE conjuncts: bind; peel off IN-subquery semi joins
        semi: list[A.InSubquery] = []
        conjs: list[_Conj] = []
        for c in split_conjuncts(sel.where):
            if isinstance(c, A.InSubquery):
                if c.negated:
                    raise SqlUnsupported(
                        "not in subquery",
                        "NULL semantics need a null-aware anti join", c.pos)
                semi.append(c)
                continue
            b = binder._as_predicate(c)
            conjs.append(_Conj(c, b, referenced_elements(b.e, scope)))
        on_conjs: dict[int, list[_Conj]] = {}
        for e in elems:
            if e.on is None:
                continue
            bound = []
            for c in split_conjuncts(e.on):
                b = binder._as_predicate(c)
                bound.append(_Conj(c, b, referenced_elements(b.e, scope)))
            on_conjs[e.index] = bound

        # ---- join order: probe seed = highest-cardinality item, then
        # greedily attach the first item (FROM order) with an equi link
        order = self._order_items(items, conjs, on_conjs, scope, sel.pos)
        plan_elems: list[_Elem] = [e for gi in order for e in items[gi]]
        mapping: dict[int, int] = {}
        offsets: dict[int, int] = {}
        off = 0
        for e in plan_elems:
            entry = scope.entries[e.index]
            offsets[e.index] = off
            for i in range(len(e.schema)):
                mapping[entry.start + i] = off + i
            off += len(e.schema)

        def lay(x: ir.Expr) -> ir.Expr:
            return ir.remap_columns(x, mapping)

        # ---- pushdown: single-element conjuncts onto their element
        # (never below the null-making side of a LEFT join)
        for cj in conjs:
            if len(cj.refs) != 1:
                continue
            e = elems[next(iter(cj.refs))]
            if e.join_kind == "left":
                continue
            entry = scope.entries[e.index]
            local = {entry.start + i: i for i in range(len(e.schema))}
            e.pushed.append(ir.remap_columns(cj.bound.e, local))
            cj.used = True

        # ---- assemble the join tree
        scope_schema = _scope_schema(scope)
        current: Optional[pb.PhysicalPlanNode] = None
        joined: set[int] = set()
        for gi in order:
            for e in items[gi]:
                base = self._elem_plan(e, probe=(not repl and not joined),
                                       scope=scope, ctes=ctes)
                if current is None:
                    current = base
                    joined.add(e.index)
                    continue
                if e.join_kind is not None:
                    pool = on_conjs.get(e.index, [])
                    from_on = True
                    kind = e.join_kind
                else:
                    pool = [cj for cj in conjs if not cj.used]
                    from_on = False
                    kind = "inner"
                current = self._attach(current, base, e, kind, pool, from_on,
                                       conjs, joined, scope, scope_schema,
                                       offsets, lay, sel.pos)
                joined.add(e.index)
        assert current is not None

        # ---- semi joins from IN (SELECT ...) conjuncts
        for c in semi:
            current = self._semi_join(current, c, binder, scope, lay, ctes)

        # ---- residual WHERE conjuncts
        residual = [lay(cj.bound.e) for cj in conjs if not cj.used]
        if residual:
            current = B.filter_(current, residual)

        in_fields = [f for e in plan_elems for f in e.schema]
        pipe = _Pipe(current, in_fields)

        # ---- aggregation / projection
        post_exprs = [it.expr for it in sel.items]
        if sel.having is not None:
            post_exprs.append(sel.having)
        post_exprs += [o.expr for o in order_by]
        aggs = collect_aggs(post_exprs, binder)
        names = self._out_names(sel.items)
        item_irs: list[ir.Expr] = []
        out_fields: list[T.Field] = []

        if sel.group_by or aggs:
            if sel.distinct:
                raise SqlUnsupported(
                    "select distinct with aggregation", "", sel.pos)
            for g in sel.group_by:
                if contains_agg(g):
                    raise SqlAnalysisError("aggregate in GROUP BY", _pos(g))
            key_bounds = [binder.bind(g) for g in sel.group_by]
            key_names = self._unique(
                [kb.name or f"_g{i}" for i, kb in enumerate(key_bounds)])
            post_fields = self._grouped(pipe, key_bounds, key_names, aggs,
                                        lay, repl)
            pab = _PostAggBinder(scope, aggs, binder)
            key_irs = [kb.e for kb in key_bounds]
            k = len(key_bounds)

            def rewrite(e: A.Expr) -> Bound:
                b = pab.bind(e)
                return Bound(
                    _to_post_space(b.e, key_irs, key_names, k, _pos(e)),
                    b.dtype, b.name)

            if sel.having is not None:
                hb = rewrite(sel.having)
                if hb.dtype.kind != T.TypeKind.BOOL:
                    raise SqlAnalysisError("HAVING must be boolean",
                                           _pos(sel.having))
                pipe.apply(lambda node, fields, p=hb.e:
                           (B.filter_(node, [p]), fields))
            proj = []
            for it, name in zip(sel.items, names):
                b = rewrite(it.expr)
                item_irs.append(b.e)
                proj.append((b.e, name))
                out_fields.append(
                    T.Field(name, b.dtype, _expr_nullable(b.e, post_fields)))
            pipe.apply(lambda node, fields, p=proj, f=out_fields:
                       (B.project(node, p), list(f)))
        else:
            if sel.having is not None:
                # no GROUP BY, no aggregates: nothing for HAVING to
                # filter over — refusing beats the silently-dropped
                # predicate this branch would otherwise produce
                raise SqlUnsupported(
                    "having without group by",
                    "HAVING requires GROUP BY or aggregates",
                    _pos(sel.having))
            proj = []
            for it, name in zip(sel.items, names):
                b = binder.bind(it.expr)
                e_ = lay(b.e)
                item_irs.append(e_)
                proj.append((e_, name))
                out_fields.append(
                    T.Field(name, b.dtype, _expr_nullable(e_, in_fields)))
            pipe.plan = B.project(pipe.plan, proj)
            pipe.fields = out_fields
            if sel.distinct:
                self._distinct(pipe, repl)

            def rewrite(e: A.Expr) -> Bound:
                b = binder.bind(e)
                return Bound(lay(b.e), b.dtype, b.name)

        # ---- ORDER BY / LIMIT
        if order_by:
            self._attach_order(pipe, order_by, limit, repl, out_fields,
                               item_irs, rewrite)
        elif limit is not None:
            self._attach_limit(pipe, limit, repl)
        return pipe

    # -- FROM handling -------------------------------------------------------

    def _flatten_ref(self, ref: A.Node) -> list[tuple]:
        """Join tree -> [(rel, kind, on)] in join order; head has kind None."""
        if isinstance(ref, A.Join):
            out = self._flatten_ref(ref.left)
            if isinstance(ref.right, A.Join):
                raise SqlUnsupported(
                    "parenthesized join tree", "right-nested joins",
                    _pos(ref.right))
            out.append((ref.right, ref.kind, ref.on))
            return out
        return [(ref, None, None)]

    def _register(self, rel: A.Node, kind: Optional[str], on: Optional[A.Expr],
                  scope: Scope, index: int, ctes: dict) -> _Elem:
        if isinstance(rel, A.TableName):
            name = rel.name.lower()
            if name in ctes:
                sub_ast = ctes[name]
                env = {k: v for k, v in ctes.items() if k != name}
                sub = self.lower_subquery(sub_ast, scope, True, env)
                alias = rel.alias or rel.name
                schema = T.Schema(tuple(sub.fields))
                scope.add(alias, "", schema, index)
                return _Elem(index, rel, alias, "", schema, kind, on,
                             sub=sub, subquery=sub_ast, est=sub.est)
            schema = self.catalog.schema(name)
            if schema is None:
                raise SqlAnalysisError(f"unknown table {rel.name!r}", rel.pos)
            alias = rel.alias or rel.name
            scope.add(alias, name, schema, index)
            return _Elem(index, rel, alias, name, schema, kind, on,
                         est=self.catalog.rows(name))
        if isinstance(rel, A.DerivedTable):
            sub = self.lower_subquery(rel.query, scope, True, ctes)
            schema = T.Schema(tuple(sub.fields))
            scope.add(rel.alias, "", schema, index)
            return _Elem(index, rel, rel.alias, "", schema, kind, on,
                         sub=sub, subquery=rel.query, est=sub.est)
        raise SqlUnsupported(type(rel).__name__, "relation kind", _pos(rel))

    def _elem_plan(self, e: _Elem, probe: bool, scope: Scope,
                   ctes: dict) -> pb.PhysicalPlanNode:
        if e.table:
            rid = self._use(e.table, replicated=not probe)
            plan = B.memory_scan(e.schema, rid)
        elif probe:
            # re-lower the probe subquery partitioned (phase 1 lowered it
            # replicated to learn its schema)
            env = dict(ctes)
            if isinstance(e.rel, A.TableName):
                env.pop(e.rel.name.lower(), None)
            sub = self.lower_subquery(e.subquery, scope, False, env)
            assert [f.dtype for f in sub.fields] == \
                [f.dtype for f in e.schema], "probe re-lowering drifted"
            plan = sub.plan
        else:
            plan = e.sub.plan
        if e.pushed:
            plan = B.filter_(plan, e.pushed)
        return plan

    # -- join ordering -------------------------------------------------------

    def _order_items(self, items: list[list[_Elem]], conjs: list[_Conj],
                     on_conjs: dict[int, list[_Conj]], scope: Scope,
                     pos: SourcePos) -> list[int]:
        n = len(items)
        if n == 1:
            return [0]
        ests = [max(e.est for e in group) for group in items]
        seed = max(range(n), key=lambda i: (ests[i], -i))
        order = [seed]
        placed = {e.index for e in items[seed]}
        remaining = [i for i in range(n) if i != seed]
        pool = list(conjs) + [c for cl in on_conjs.values() for c in cl]
        while remaining:
            pick = None
            for i in remaining:
                eids = {e.index for e in items[i]}
                if any(self._links(cj.bound.e, scope, placed, eids)
                       for cj in pool):
                    pick = i
                    break
            if pick is None:
                alias = items[remaining[0]][0].alias
                raise SqlUnsupported(
                    "cross join",
                    f"no equi-join predicate connects {alias!r}", pos)
            order.append(pick)
            placed |= {e.index for e in items[pick]}
            remaining.remove(pick)
        return order

    @staticmethod
    def _links(e: ir.Expr, scope: Scope, left: set[int],
               right: set[int]) -> bool:
        """True when `e` is an equality with one side entirely in `left`
        and the other entirely in `right` (either orientation)."""
        if not (isinstance(e, ir.BinaryOp) and e.op == "eq"):
            return False
        lr = referenced_elements(e.left, scope)
        rr = referenced_elements(e.right, scope)
        if not lr or not rr:
            return False
        return (lr <= left and rr <= right) or (lr <= right and rr <= left)

    # -- join assembly -------------------------------------------------------

    def _attach(self, current, base, e: _Elem, kind: str, pool: list[_Conj],
                from_on: bool, conjs: list[_Conj], joined: set[int],
                scope: Scope, scope_schema: T.Schema,
                offsets: dict[int, int], lay, pos: SourcePos):
        """Join `base` (element e) onto `current`, extracting equi keys
        from `pool`. Residual ON conjuncts become the join condition;
        residual WHERE conjuncts stay for the post-join filter pass."""
        lkeys: list[ir.Expr] = []
        rkeys: list[ir.Expr] = []
        cond_parts: list[ir.Expr] = []
        elem_off = offsets[e.index]
        local = {elem_off + i: i for i in range(len(e.schema))}
        target = {e.index}
        for cj in pool:
            if cj.used:
                continue
            if not cj.refs or not cj.refs <= joined | target:
                if from_on:
                    # ON conjunct reaching outside this join's two sides:
                    # legal for INNER (acts like a WHERE conjunct), not
                    # for LEFT (would change null-extension semantics)
                    if kind == "left":
                        raise SqlUnsupported(
                            "left join condition over other relations",
                            "", _pos(cj.ast))
                    conjs.append(cj)
                continue
            ends = self._split_equi(cj.bound.e, e.index, scope)
            if ends is not None and cj.refs & joined:
                lk, rk = ends
                lk, rk = self._coerce_keys(lk, rk, scope_schema, _pos(cj.ast))
                lkeys.append(lay(lk))
                rkeys.append(ir.remap_columns(lay(rk), local))
                cj.used = True
                continue
            if from_on:
                cond_parts.append(lay(cj.bound.e))
                cj.used = True
            # WHERE conjuncts fall through to the residual filter pass
        if not lkeys:
            raise SqlUnsupported(
                "cross join", f"no equi-join key for {e.alias!r}", pos)
        return B.hash_join(current, base, lkeys, rkeys, kind,
                           build_side="right", condition=_and_all(cond_parts))

    def _coerce_keys(self, lk: ir.Expr, rk: ir.Expr, schema: T.Schema,
                     pos: SourcePos) -> tuple[ir.Expr, ir.Expr]:
        return _widen_pair(lk, lk.dtype_of(schema), rk, rk.dtype_of(schema),
                           pos, "join key")

    def _split_equi(self, e: ir.Expr, elem: int, scope: Scope):
        """(left_expr, right_expr) when `e` is `lhs = rhs` with exactly one
        side reading only element `elem` and the other side none of it."""
        if not (isinstance(e, ir.BinaryOp) and e.op == "eq"):
            return None
        lrefs = referenced_elements(e.left, scope)
        rrefs = referenced_elements(e.right, scope)
        if not lrefs or not rrefs:
            return None
        if rrefs == {elem} and elem not in lrefs:
            return e.left, e.right
        if lrefs == {elem} and elem not in rrefs:
            return e.right, e.left
        return None

    def _semi_join(self, current, c: A.InSubquery, binder: ExprBinder,
                   scope: Scope, lay, ctes: dict):
        sub = self.lower_subquery(c.query, scope, True, ctes)
        if len(sub.fields) != 1:
            raise SqlAnalysisError(
                f"IN subquery must produce one column, got {len(sub.fields)}",
                c.pos)
        lb = binder.bind(c.expr)
        lk, rk = _widen_pair(
            lb.e, lb.dtype, ir.Column(0, sub.fields[0].name),
            sub.fields[0].dtype, c.pos, "IN subquery key")
        return B.hash_join(current, sub.plan, [lay(lk)], [rk], "left_semi",
                           build_side="right")

    # -- aggregation ---------------------------------------------------------

    def _grouped(self, pipe: _Pipe, key_bounds: list[Bound],
                 key_names: list[str], aggs: list[AggCall], lay,
                 repl: bool) -> list[T.Field]:
        """Partial/exchange/final aggregation; returns the post-agg field
        layout [keys..., agg results...] the caller projects from."""
        k = len(key_bounds)
        # dedup agg argument expressions (projected after the keys)
        arg_irs: list[ir.Expr] = []
        arg_pos: dict[ir.Expr, int] = {}
        for a in aggs:
            if a.arg is not None and a.arg.e not in arg_pos:
                arg_pos[a.arg.e] = k + len(arg_irs)
                arg_irs.append(a.arg.e)
        proj = [(lay(kb.e), nm) for kb, nm in zip(key_bounds, key_names)]
        proj += [(lay(e), f"_a{j}") for j, e in enumerate(arg_irs)]
        groupings = [(ir.col(i, nm), nm) for i, nm in enumerate(key_names)]
        agg_specs = []
        for j, a in enumerate(aggs):
            expr = None if a.arg is None else ir.col(arg_pos[a.arg.e])
            agg_specs.append((a.func, expr, f"_a{j}"))
        child = B.project(pipe.plan, proj) if proj else pipe.plan
        partial = B.hash_agg(child, groupings, agg_specs, "partial")
        post_fields = [
            T.Field(nm, kb.dtype, True)
            for kb, nm in zip(key_bounds, key_names)
        ] + [
            T.Field(f"_a{j}", a.out_dtype,
                    a.func not in ("count", "count_star"))
            for j, a in enumerate(aggs)
        ]
        if repl:
            pipe.plan = B.hash_agg(partial, groupings, agg_specs, "final")
            pipe.fields = post_fields
        elif k:
            ex = B.mesh_exchange(
                partial,
                B.hash_partitioning([ir.col(i) for i in range(k)],
                                    self.n_parts))
            pipe.plan = B.hash_agg(ex, groupings, agg_specs, "final")
            pipe.fields = post_fields
        else:
            # scalar aggregate: the global merge must be single-task
            pipe.plan = partial
            pipe.fields = list(_inter_schema(partial))
            pipe.deferred.append(
                lambda node, fields:
                (B.hash_agg(node, groupings, agg_specs, "final"),
                 list(post_fields)))
        return post_fields

    def _distinct(self, pipe: _Pipe, repl: bool) -> None:
        groupings = [(ir.col(i, f.name), f.name)
                     for i, f in enumerate(pipe.fields)]
        partial = B.hash_agg(pipe.plan, groupings, [], "partial")
        if repl:
            pipe.plan = B.hash_agg(partial, groupings, [], "final")
            return
        ex = B.mesh_exchange(
            partial,
            B.hash_partitioning([ir.col(i) for i in range(len(groupings))],
                                self.n_parts))
        pipe.plan = B.hash_agg(ex, groupings, [], "final")

    # -- output naming / ordering -------------------------------------------

    def _out_names(self, items: tuple[A.SelectItem, ...]) -> list[str]:
        names = []
        for i, it in enumerate(items):
            if it.alias:
                names.append(it.alias)
            elif isinstance(it.expr, A.Ident):
                names.append(it.expr.parts[-1])
            else:
                names.append(f"_c{i}")
        return self._unique(names)

    @staticmethod
    def _unique(names: list[str]) -> list[str]:
        seen: dict[str, int] = {}
        out = []
        for n in names:
            key = n.lower()
            if key in seen:
                seen[key] += 1
                out.append(f"{n}_{seen[key]}")
            else:
                seen[key] = 0
                out.append(n)
        return out

    def _attach_order(self, pipe: _Pipe, order_by, limit, repl: bool,
                      out_fields: list[T.Field],
                      item_irs: Optional[list[ir.Expr]],
                      rewrite) -> None:
        """Resolve ORDER BY items against the output columns (alias,
        ordinal, or select-item expression match) and place the sort —
        in-task for replicated subplans, in the collect stage otherwise."""
        def resolve(o: A.OrderItem) -> int:
            e = o.expr
            if isinstance(e, A.Ident) and len(e.parts) == 1:
                hits = [i for i, f in enumerate(out_fields)
                        if f.name.lower() == e.parts[0].lower()]
                if len(hits) == 1:
                    return hits[0]
            if isinstance(e, A.NumberLit) and e.text.isdigit():
                n = int(e.text)
                if not (1 <= n <= len(out_fields)):
                    raise SqlAnalysisError(
                        f"ORDER BY ordinal {n} out of range", e.pos)
                return n - 1
            if item_irs is not None and rewrite is not None:
                b = rewrite(e)
                for i, itir in enumerate(item_irs):
                    if itir == b.e:
                        return i
            raise SqlUnsupported(
                "order by expression not in the select list", "", _pos(e))

        specs = []
        for o in order_by:
            idx = resolve(o)
            nf = o.nulls_first if o.nulls_first is not None else o.asc
            specs.append((idx, SortSpec(o.asc, nf)))

        def step(node, fields):
            sort_fields = [(ir.col(i, fields[i].name), s) for i, s in specs]
            node = B.sort(node, sort_fields,
                          fetch=limit if limit is not None else None)
            if limit is not None:
                node = B.limit(node, limit)
            return node, fields

        if repl:
            pipe.apply(step)
        else:
            pipe.deferred.append(step)

    def _attach_limit(self, pipe: _Pipe, limit: int, repl: bool) -> None:
        def step(node, fields):
            return B.limit(node, limit), fields

        if repl:
            pipe.apply(step)
        else:
            pipe.deferred.append(step)


def _scope_schema(scope: Scope) -> T.Schema:
    """Flattened scope layout as one schema (dtype_of lookups for keys)."""
    return T.Schema(tuple(f for e in scope.entries for f in e.schema))
