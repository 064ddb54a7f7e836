"""Plan explain rendering and stability checking (port of
``auron_tpu/plan/explain.py``).

``explain`` renders an exec tree as indented text (operator, expressions,
limits, join type, partitioning, groupings and aggregates);
``explain_proto`` renders a plan proto (driver-resolved nodes such as
``mesh_exchange`` included); ``normalize`` strips run-specific detail
(paths, resource ids); ``check_stability`` diffs the normalized text
against a golden file, so an operator that changes shape fails a test.
"""

from __future__ import annotations

import re

from auron_tpu_torch.exec.base import ExecOperator
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.plan.protowalk import child_nodes


def expr_str(e: ir.Expr) -> str:
    if isinstance(e, ir.Column):
        return f"#{e.index}" + (f"({e.name})" if e.name else "")
    if isinstance(e, ir.Literal):
        return repr(e.value)
    if isinstance(e, ir.BinaryOp):
        return f"({expr_str(e.left)} {e.op} {expr_str(e.right)})"
    if isinstance(e, ir.Cast):
        return f"cast({expr_str(e.child)} as {e.to})"
    if isinstance(e, ir.IsNull):
        return f"isnull({expr_str(e.child)})"
    if isinstance(e, ir.IsNotNull):
        return f"isnotnull({expr_str(e.child)})"
    if isinstance(e, ir.Not):
        return f"not({expr_str(e.child)})"
    if isinstance(e, ir.ScalarFunc):
        return f"{e.name}({', '.join(expr_str(a) for a in e.args)})"
    if isinstance(e, ir.In):
        return f"{expr_str(e.child)} in {list(e.items)!r}"
    if isinstance(e, ir.Like):
        return f"{expr_str(e.child)} like {e.pattern!r}"
    if isinstance(e, ir.Case):
        return "case(...)"
    if isinstance(e, ir.If):
        return f"if({expr_str(e.cond)}, {expr_str(e.then)}, {expr_str(e.orelse)})"
    if isinstance(e, ir.Coalesce):
        return f"coalesce({', '.join(expr_str(a) for a in e.args)})"
    return type(e).__name__


def _node_detail(op: ExecOperator) -> str:
    d = []
    for attr in ("exprs", "predicates", "sort_exprs", "left_keys", "right_keys",
                 "partition_by", "gen_expr"):
        v = getattr(op, attr, None)
        if v is None:
            continue
        if isinstance(v, list):
            d.append(f"{attr}=[{', '.join(expr_str(e) for e in v)}]")
        else:
            d.append(f"{attr}={expr_str(v)}")
    for attr in ("limit", "fetch", "mode", "generator", "outer", "build_side"):
        v = getattr(op, attr, None)
        if v is not None and v is not False:
            d.append(f"{attr}={v}")
    drv = getattr(op, "driver", None)
    if drv is not None:
        d.append(f"join_type={drv.join_type}")
    part = getattr(op, "partitioning", None)
    if part is not None:
        d.append(f"partitioning={type(part).__name__}({part.num_partitions})")
    groupings = getattr(op, "groupings", None)
    if groupings:
        d.append(f"groups=[{', '.join(expr_str(e) for e, _ in groupings)}]")
    aggs = getattr(op, "aggs", None)
    if aggs:
        d.append("aggs=[" + ", ".join(
            f"{a.func}({expr_str(a.expr) if a.expr is not None else '*'}) as {n}"
            for a, n in aggs) + "]")
    return " " + " ".join(d) if d else ""


def explain(op: ExecOperator, indent: int = 0) -> str:
    lines = ["  " * indent + op.name + _node_detail(op)]
    for c in op.children:
        lines.append(explain(c, indent + 1))
    return "\n".join(lines)


#: Per-variant detail attributes ``explain_proto`` renders; every plan
#: variant of ``proto/plan.proto`` has an entry (structural nodes with
#: nothing to say an empty tuple).
PLAN_DETAILS: dict[str, tuple[str, ...]] = {
    "memory_scan": ("resource_id",),
    "ffi_reader": ("resource_id",),
    "parquet_scan": ("fs_resource_id",),
    "project": (),
    "filter": (),
    "limit": ("limit",),
    "union": (),
    "expand": (),
    "rename_columns": (),
    "empty_partitions": ("num_partitions",),
    "coalesce_batches": ("target_rows",),
    "hash_agg": (),          # mode rendered as a special case below
    "sort": ("fetch",),
    "sort_merge_join": (),
    "hash_join": ("cached_build_id",),
    "shuffle_writer": (),    # partitioning rendered as a special case
    "ipc_reader": ("resource_id",),
    "window": (),
    "generate": ("generator",),
    "parquet_sink": ("output_path",),
    "ipc_writer": ("resource_id",),
    "debug": ("tag",),
    "orc_scan": ("fs_resource_id",),
    "orc_sink": ("output_path",),
    "rss_shuffle_writer": ("rss_resource_id",),
    "mesh_exchange": ("exchange_id",),
    "kafka_scan": ("topic", "format", "startup_mode", "on_error", "source_resource_id"),
}


def explain_proto(node, indent: int = 0) -> str:
    """Render a plan proto tree (driver-resolved nodes like ``mesh_exchange``
    or ``kafka_scan`` that never become exec operators included)."""
    from auron_tpu_torch import proto as pb

    which = node.WhichOneof("plan")
    inner = getattr(node, which)
    details = []
    for attr in PLAN_DETAILS.get(which, ()):
        v = getattr(inner, attr, None)
        if v:
            details.append(f"{attr}={v}")
    if getattr(inner, "file_paths", None):
        details.append(f"files={len(inner.file_paths)}")
    part = getattr(inner, "partitioning", None)
    if part is not None and (part.num_partitions or part.kind):
        kind = pb.Partitioning.Kind.Name(part.kind).lower()
        details.append(f"partitioning={kind}({part.num_partitions})")
    if getattr(inner, "has_projection", False):
        details.append(f"projection={list(inner.projection)}")
    if which == "hash_agg":
        details.append(f"mode={pb.AggMode.Name(inner.mode).lower()}")
    lines = ["  " * indent + which + (" " + " ".join(details) if details else "")]
    lines += [explain_proto(c, indent + 1) for c in child_nodes(node)]
    return "\n".join(lines)


def normalize(plan_text: str) -> str:
    """Strip run-specific detail (paths, resource ids) for golden diffs."""
    t = re.sub(r"/[^\s]*\.(data|index|parquet|orc)", "<path>", plan_text)
    return re.sub(r"resource_id=\S+", "resource_id=<id>", t)


def check_stability(op: ExecOperator, golden_path: str, update: bool = False) -> None:
    """Compare the normalized explain output to a golden file (written when
    it is missing or ``update`` is set)."""
    import os

    text = normalize(explain(op)) + "\n"
    if update or not os.path.exists(golden_path):
        os.makedirs(os.path.dirname(golden_path), exist_ok=True)
        with open(golden_path, "w") as f:
            f.write(text)
        return
    with open(golden_path) as f:
        golden = f.read()
    if golden != text:
        raise AssertionError(f"plan changed vs golden {golden_path}:\n--- golden ---\n{golden}"
                             f"--- current ---\n{text}")
