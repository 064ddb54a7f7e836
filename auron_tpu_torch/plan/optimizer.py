"""Plan-proto rewrites (port of ``auron_tpu/plan/optimizer.py``):

- ``prune_columns``: every operator asks its child only for the columns it
  reads; joins get a ``projection`` so pair gathers move only the surviving
  columns. Node types outside this slice are barriers (kept as they are,
  with their children pruned with everything required);
- ``elide_smj_input_sorts``: drop the SortExec children of a sort-merge
  join (``optimizer.py:335-394``), which clusters its build side itself and
  probes in any order.

The rewrites build the port's own plan messages (``auron_tpu_torch.proto``)."""

from __future__ import annotations

from auron_tpu_torch.plan.protowalk import child_nodes

_PASSTHROUGH = ("limit", "coalesce_batches", "debug")


def _pb():
    from auron_tpu_torch import proto

    return proto


def prune_columns(plan):
    new, _ = _prune(plan, None)
    return new


def _walk_columns(msg, fn) -> None:
    if msg.DESCRIPTOR.full_name == "auron_tpu.PhysicalExprNode" and \
            msg.WhichOneof("expr") == "column":
        fn(msg.column)
        return
    for fd, val in msg.ListFields():
        if fd.type != fd.TYPE_MESSAGE:
            continue
        if fd.label == fd.LABEL_REPEATED:
            for v in val:
                _walk_columns(v, fn)
        else:
            _walk_columns(val, fn)


def _collect_cols(*msgs) -> set[int]:
    out: set[int] = set()
    for m in msgs:
        _walk_columns(m, lambda c: out.add(c.index))
    return out


def _remap_exprs(mapping, *msgs) -> None:
    if mapping is None:
        return

    def rewrite(c):
        c.index = mapping[c.index]

    for m in msgs:
        _walk_columns(m, rewrite)


def _out_width(node) -> int:
    pb = _pb()
    which = node.WhichOneof("plan")
    inner = getattr(node, which)
    if which in ("memory_scan", "ipc_reader", "ffi_reader", "parquet_scan", "orc_scan",
                 "empty_partitions", "kafka_scan"):
        return len(inner.schema.fields)
    if which == "project":
        return len(inner.exprs)
    if which in ("filter", "sort", "limit", "coalesce_batches", "debug", "shuffle_writer",
                 "rss_shuffle_writer", "mesh_exchange"):
        return _out_width(inner.child)
    if which == "rename_columns":
        return len(inner.names)
    if which in ("hash_join", "sort_merge_join"):
        if inner.has_projection:
            return len(inner.projection)
        jt = inner.join_type
        if jt in (pb.JOIN_LEFT_SEMI, pb.JOIN_LEFT_ANTI):
            return _out_width(inner.left)
        if jt == pb.JOIN_EXISTENCE:
            return _out_width(inner.left) + 1
        return _out_width(inner.left) + _out_width(inner.right)
    if which == "union":
        return _out_width(inner.children[0])
    if which == "hash_agg" and inner.mode == pb.AGG_FINAL:
        return len(inner.groupings) + len(inner.aggs)
    from auron_tpu_torch.plan.planner import plan_from_proto

    return len(plan_from_proto(node).schema)


def _req_or_all(required, width: int) -> list[int]:
    return list(range(width)) if required is None else required


def _prune(node, required):
    pb = _pb()
    which = node.WhichOneof("plan")
    handler = _HANDLERS.get(which)
    if handler is not None:
        return handler(node, required)
    new = pb.PhysicalPlanNode()
    new.CopyFrom(node)
    inner = getattr(new, which)
    if which == "union":
        for c in inner.children:
            c.CopyFrom(_prune(c, None)[0])
        return new, None
    for f in ("child", "left", "right"):
        try:
            present = inner.HasField(f)
        except ValueError:
            continue
        if present:
            sub, cmap = _prune(getattr(inner, f), None)
            assert cmap is None
            getattr(inner, f).CopyFrom(sub)
    return new, None


def _prune_project(node, required):
    pb = _pb()
    n = node.project
    keep = sorted(set(_req_or_all(required, len(n.exprs))))
    child_req = sorted(_collect_cols(*(n.exprs[i].expr for i in keep)))
    new_child, cmap = _prune(n.child, child_req)
    new = pb.PhysicalPlanNode()
    p = new.project
    p.child.CopyFrom(new_child)
    for i in keep:
        ne = p.exprs.add()
        ne.CopyFrom(n.exprs[i])
        _remap_exprs(cmap, ne.expr)
    if len(keep) == len(n.exprs):
        return new, None
    return new, {old: i for i, old in enumerate(keep)}


def _prune_filter(node, required):
    pb = _pb()
    n = node.filter
    pred_cols = _collect_cols(*n.predicates)
    child_req = None if required is None else sorted(set(required) | pred_cols)
    new_child, cmap = _prune(n.child, child_req)
    new = pb.PhysicalPlanNode()
    f = new.filter
    f.child.CopyFrom(new_child)
    for p in n.predicates:
        np_ = f.predicates.add()
        np_.CopyFrom(p)
        _remap_exprs(cmap, np_)
    return new, cmap


def _prune_sort(node, required):
    pb = _pb()
    n = node.sort
    sort_cols = _collect_cols(*(f.expr for f in n.fields))
    child_req = None if required is None else sorted(set(required) | sort_cols)
    new_child, cmap = _prune(n.child, child_req)
    new = pb.PhysicalPlanNode()
    new.CopyFrom(node)
    s = new.sort
    s.child.CopyFrom(new_child)
    for f in s.fields:
        _remap_exprs(cmap, f.expr)
    return new, cmap


def _prune_passthrough(node, required):
    pb = _pb()
    which = node.WhichOneof("plan")
    new = pb.PhysicalPlanNode()
    new.CopyFrom(node)
    inner = getattr(new, which)
    new_child, cmap = _prune(inner.child, required)
    inner.child.CopyFrom(new_child)
    return new, cmap


def _prune_hash_agg(node, required):
    pb = _pb()
    n = node.hash_agg
    new = pb.PhysicalPlanNode()
    new.CopyFrom(node)
    a = new.hash_agg
    if n.mode == pb.AGG_PARTIAL:
        child_req = sorted(_collect_cols(*(g.expr for g in n.groupings),
                                         *(sp.expr for sp in n.aggs if sp.has_expr)))
        new_child, cmap = _prune(n.child, child_req)
        a.child.CopyFrom(new_child)
        for g in a.groupings:
            _remap_exprs(cmap, g.expr)
        for sp in a.aggs:
            if sp.has_expr:
                _remap_exprs(cmap, sp.expr)
    else:
        new_child, cmap = _prune(n.child, None)
        assert cmap is None
        a.child.CopyFrom(new_child)
    return new, None


def _prune_join(node, required):
    pb = _pb()
    which = node.WhichOneof("plan")
    n = getattr(node, which)
    if n.has_projection:
        return node, None
    jt = n.join_type
    nl, nr = _out_width(n.left), _out_width(n.right)
    semi_like = jt in (pb.JOIN_LEFT_SEMI, pb.JOIN_LEFT_ANTI)
    existence = jt == pb.JOIN_EXISTENCE
    out_width = nl if semi_like else (nl + 1 if existence else nl + nr)
    R = _req_or_all(required, out_width)
    lkeys, rkeys = _collect_cols(*n.left_keys), _collect_cols(*n.right_keys)
    cond_cols = _collect_cols(n.condition) if n.has_condition else set()
    cond_l = {c for c in cond_cols if c < nl}
    cond_r = {c - nl for c in cond_cols if c >= nl}
    left_need = {c for c in R if c < nl}
    right_need = set() if (semi_like or existence) else {c - nl for c in R if c >= nl}
    child_req_l = sorted(left_need | lkeys | cond_l)
    child_req_r = sorted(right_need | rkeys | cond_r)
    new_left, lmap = _prune(n.left, child_req_l if len(child_req_l) < nl else None)
    new_right, rmap = _prune(n.right, child_req_r if len(child_req_r) < nr else None)
    lmap = lmap or {i: i for i in range(nl)}
    rmap = rmap or {i: i for i in range(nr)}
    new_nl, new_nr = _out_width(new_left), _out_width(new_right)
    new = pb.PhysicalPlanNode()
    new.CopyFrom(node)
    j = getattr(new, which)
    j.left.CopyFrom(new_left)
    j.right.CopyFrom(new_right)
    for k in j.left_keys:
        _remap_exprs(lmap, k)
    for k in j.right_keys:
        _remap_exprs(rmap, k)
    if n.has_condition:
        comb = {c: lmap[c] for c in cond_l}
        comb.update({c + nl: new_nl + rmap[c] for c in cond_r})
        _remap_exprs(comb, j.condition)
    if semi_like:
        proj, new_width = [lmap[c] for c in R], new_nl
    elif existence:
        proj, new_width = [(lmap[c] if c < nl else new_nl) for c in R], new_nl + 1
    else:
        proj = [(lmap[c] if c < nl else new_nl + rmap[c - nl]) for c in R]
        new_width = new_nl + new_nr
    if proj != list(range(new_width)):
        j.projection.extend(proj)
        j.has_projection = True
    mapping = None if required is None else {c: i for i, c in enumerate(R)}
    return new, mapping


_HANDLERS = {
    "project": _prune_project,
    "filter": _prune_filter,
    "sort": _prune_sort,
    "hash_agg": _prune_hash_agg,
    "hash_join": _prune_join,
    "sort_merge_join": _prune_join,
}
for _p in _PASSTHROUGH:
    _HANDLERS[_p] = _prune_passthrough


# ---------------------------------------------------------------------------
# Sort elision under sort-merge join
# ---------------------------------------------------------------------------

#: the task conf key that picks the elision mode; ``task_from_proto`` reads it
SMJ_ELIDE_SORTS_KEY = "auron.smj.elide.sorts"
#: the only operator whose output depends on its input's row order (head-N)
_ORDER_SENSITIVE = ("limit",)


def elide_smj_input_sorts(plan, mode: str = "build"):
    """Drop SortExec children feeding a sort-merge join, in a copy.

    - "build" (default): only the build (right) side's sort; the join's
      output order follows the probe side, so the output order never changes;
    - "full": both sides; the host asserts that nothing above needs the
      order;
    - "off": no rewrite.

    A sort with a fetch (TakeOrdered: it changes the row set) is never
    dropped, nor is any sort below an order-sensitive node (a limit)."""
    if mode == "off":
        return plan
    new = _pb().PhysicalPlanNode()
    new.CopyFrom(plan)
    _elide(new, order_sensitive=False, full=(mode == "full"))
    return new


def _elide(node, order_sensitive: bool, full: bool) -> None:
    which = node.WhichOneof("plan")
    sensitive = order_sensitive or which in _ORDER_SENSITIVE
    if which == "sort_merge_join" and not sensitive:
        j = node.sort_merge_join
        for side in (("left", "right") if full else ("right",)):
            child = getattr(j, side)
            if child.WhichOneof("plan") == "sort" and not child.sort.has_fetch:
                grand = _pb().PhysicalPlanNode()
                grand.CopyFrom(child.sort.child)
                getattr(j, side).CopyFrom(grand)
    for c in child_nodes(node):
        _elide(c, sensitive, full)
