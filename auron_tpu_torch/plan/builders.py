"""Host-side plan builders: expression IR and operator specs -> plan protos
(port of ``auron_tpu/plan/builders.py``).

The port's queries, the stage split and a host front end build plans
through these and ship serialized ``TaskDefinition`` bytes, which the
planner (``plan/planner.py``) turns back into exec trees: the wire
contract a Spark front end speaks. For the same arguments the bytes equal
the reference builders'. Plans the port's planner does not run yet
(``parquet_scan``, ``parquet_sink``, ``rss_shuffle_writer``,
``kafka_scan``) still build, as does a ``host_udf`` expression, which the
planner decodes and evaluation refuses.
"""

from __future__ import annotations

import decimal as pydec
from typing import Any

from auron_tpu_torch import proto as pb
from auron_tpu_torch import types as T
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.ops.sortkeys import SortSpec
from auron_tpu_torch.plan.planner import dtype_to_proto, schema_to_proto

# ---------------------------------------------------------------------------
# expressions: ir -> proto
# ---------------------------------------------------------------------------


def literal_to_proto(value: Any, dtype: T.DataType):
    p = pb.LiteralExpr(dtype=dtype_to_proto(dtype))
    if value is None:
        p.is_null = True
        return p
    k = dtype.kind
    if k == T.TypeKind.BOOL:
        p.bool_value = bool(value)
    elif dtype.is_integer or k in (T.TypeKind.DATE32, T.TypeKind.TIMESTAMP):
        p.int_value = int(value)
    elif dtype.is_float:
        p.float_value = float(value)
    elif k == T.TypeKind.STRING:
        p.string_value = str(value)
    elif k == T.TypeKind.BINARY:
        p.bytes_value = bytes(value)
    elif k == T.TypeKind.DECIMAL:
        p.decimal_unscaled = int(pydec.Decimal(str(value)).scaleb(dtype.scale)
                                 .quantize(pydec.Decimal(1)))
    else:
        raise TypeError(f"literal of type {dtype}")
    return p


def expr_to_proto(e: ir.Expr):
    n = pb.PhysicalExprNode()
    if isinstance(e, ir.Column):
        n.column.index = e.index
        n.column.name = e.name
    elif isinstance(e, ir.Literal):
        n.literal.CopyFrom(literal_to_proto(e.value, e.dtype))
    elif isinstance(e, ir.Cast):
        n.cast.child.CopyFrom(expr_to_proto(e.child))
        n.cast.to.CopyFrom(dtype_to_proto(e.to))
        n.cast.try_cast = e.try_
    elif isinstance(e, ir.BinaryOp):
        n.binary.op = e.op
        n.binary.left.CopyFrom(expr_to_proto(e.left))
        n.binary.right.CopyFrom(expr_to_proto(e.right))
    elif isinstance(e, ir.IsNull):
        n.is_null.child.CopyFrom(expr_to_proto(e.child))
    elif isinstance(e, ir.IsNotNull):
        n.is_not_null.child.CopyFrom(expr_to_proto(e.child))
    elif isinstance(e, ir.Not):
        getattr(n, "not").child.CopyFrom(expr_to_proto(e.child))
    elif isinstance(e, ir.If):
        n.if_expr.cond.CopyFrom(expr_to_proto(e.cond))
        n.if_expr.then.CopyFrom(expr_to_proto(e.then))
        n.if_expr.orelse.CopyFrom(expr_to_proto(e.orelse))
    elif isinstance(e, ir.Case):
        for c, v in e.branches:
            b = n.case_expr.branches.add()
            b.when.CopyFrom(expr_to_proto(c))
            b.then.CopyFrom(expr_to_proto(v))
        if e.orelse is not None:
            n.case_expr.orelse.CopyFrom(expr_to_proto(e.orelse))
    elif isinstance(e, ir.In):
        n.in_list.child.CopyFrom(expr_to_proto(e.child))
        n.in_list.negated = e.negated
        for item in e.items:
            lit = item if isinstance(item, ir.Literal) else ir.lit(item)
            n.in_list.items.add().CopyFrom(literal_to_proto(lit.value, lit.dtype))
    elif isinstance(e, ir.Coalesce):
        for a in e.args:
            n.coalesce.args.add().CopyFrom(expr_to_proto(a))
    elif isinstance(e, ir.Like):
        n.like.child.CopyFrom(expr_to_proto(e.child))
        n.like.pattern = e.pattern
        n.like.negated = e.negated
        n.like.escape = e.escape
    elif isinstance(e, ir.ScalarFunc):
        n.scalar_func.name = e.name
        for a in e.args:
            n.scalar_func.args.add().CopyFrom(expr_to_proto(a))
        if e.out_dtype is not None:
            n.scalar_func.out_dtype.CopyFrom(dtype_to_proto(e.out_dtype))
            n.scalar_func.has_out_dtype = True
    elif isinstance(e, ir.HostUDF):
        n.host_udf.name = e.name
        for a in e.args:
            n.host_udf.args.add().CopyFrom(expr_to_proto(a))
        n.host_udf.out_dtype.CopyFrom(dtype_to_proto(e.out_dtype))
    elif isinstance(e, ir.SparkPartitionId):
        n.spark_partition_id.SetInParent()
    elif isinstance(e, ir.MonotonicId):
        n.monotonic_id.SetInParent()
    elif isinstance(e, ir.RowNum):
        n.row_num.SetInParent()
    elif isinstance(e, ir.ScalarSubquery):
        n.scalar_subquery.resource_id = e.resource_id
        n.scalar_subquery.dtype.CopyFrom(dtype_to_proto(e.dtype))
    else:
        raise TypeError(f"cannot serialize {type(e).__name__}")
    return n


def sort_field(e: ir.Expr, spec: SortSpec):
    f = pb.SortField(asc=spec.asc, nulls_first=spec.nulls_first)
    f.expr.CopyFrom(expr_to_proto(e))
    return f


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------


def _wrap(**kwargs):
    return pb.PhysicalPlanNode(**kwargs)


def memory_scan(schema: T.Schema, resource_id: str):
    return _wrap(memory_scan=pb.MemoryScanNode(schema=schema_to_proto(schema),
                                               resource_id=resource_id))


def ffi_reader(schema: T.Schema, resource_id: str):
    return _wrap(ffi_reader=pb.FfiReaderNode(schema=schema_to_proto(schema),
                                             resource_id=resource_id))


def parquet_scan(schema: T.Schema, files: list[str], pruning: list[ir.Expr] = (),
                 fs_resource_id: str = ""):
    n = pb.ParquetScanNode(schema=schema_to_proto(schema), file_paths=list(files),
                           fs_resource_id=fs_resource_id)
    for p in pruning:
        n.pruning_predicates.add().CopyFrom(expr_to_proto(p))
    return _wrap(parquet_scan=n)


def project(child, exprs: list[tuple[ir.Expr, str]]):
    n = pb.ProjectNode(child=child)
    for e, name in exprs:
        ne = n.exprs.add()
        ne.expr.CopyFrom(expr_to_proto(e))
        ne.name = name
    return _wrap(project=n)


def filter_(child, predicates: list[ir.Expr]):
    n = pb.FilterNode(child=child)
    for p in predicates:
        n.predicates.add().CopyFrom(expr_to_proto(p))
    return _wrap(filter=n)


def limit(child, k: int):
    return _wrap(limit=pb.LimitNode(child=child, limit=k))


def union(children: list):
    return _wrap(union=pb.UnionNode(children=children))


def rename_columns(child, names: list[str]):
    return _wrap(rename_columns=pb.RenameColumnsNode(child=child, names=list(names)))


def empty_partitions(schema: T.Schema, num_partitions: int):
    return _wrap(empty_partitions=pb.EmptyPartitionsNode(schema=schema_to_proto(schema),
                                                         num_partitions=num_partitions))


def coalesce_batches(child, target_rows: int = 0):
    return _wrap(coalesce_batches=pb.CoalesceBatchesNode(child=child, target_rows=target_rows))


def debug(child, tag: str = "debug"):
    return _wrap(debug=pb.DebugNode(child=child, tag=tag))


def expand(child, projections: list[list[ir.Expr]], names: list[str]):
    """ROLLUP/CUBE lowering: one output batch per projection per input."""
    n = pb.ExpandNode(child=child, names=names)
    for proj in projections:
        p = n.projections.add()
        for e in proj:
            p.exprs.append(expr_to_proto(e))
    return _wrap(expand=n)


_AGG_MODES = {"partial": "AGG_PARTIAL", "partial_merge": "AGG_PARTIAL_MERGE",
              "final": "AGG_FINAL"}
_AGG_FUNCS = {"sum": "AGG_SUM", "count": "AGG_COUNT", "count_star": "AGG_COUNT_STAR",
              "avg": "AGG_AVG", "min": "AGG_MIN", "max": "AGG_MAX", "first": "AGG_FIRST",
              "first_ignores_null": "AGG_FIRST_IGNORES_NULL",
              "collect_list": "AGG_COLLECT_LIST", "collect_set": "AGG_COLLECT_SET",
              "host_udaf": "AGG_HOST_UDAF"}


def hash_agg(child, groupings: list[tuple[ir.Expr, str]], aggs: list[tuple], mode: str):
    """aggs: (func, expr, name) or (func, expr, name, udaf_name) tuples."""
    n = pb.HashAggNode(child=child, mode=getattr(pb, _AGG_MODES[mode]))
    for e, name in groupings:
        g = n.groupings.add()
        g.expr.CopyFrom(expr_to_proto(e))
        g.name = name
    for spec in aggs:
        func, e, name = spec[0], spec[1], spec[2]
        a = n.aggs.add()
        a.func = getattr(pb, _AGG_FUNCS[func])
        a.name = name
        if len(spec) > 3 and spec[3]:
            a.udaf = spec[3]
        if e is not None:
            a.expr.CopyFrom(expr_to_proto(e))
            a.has_expr = True
    return _wrap(hash_agg=n)


def sort(child, fields: list[tuple[ir.Expr, SortSpec]], fetch: int | None = None):
    n = pb.SortNode(child=child)
    for e, s in fields:
        n.fields.add().CopyFrom(sort_field(e, s))
    if fetch is not None:
        n.fetch = fetch
        n.has_fetch = True
    return _wrap(sort=n)


_JOIN_TYPES = {"inner": "JOIN_INNER", "left": "JOIN_LEFT", "right": "JOIN_RIGHT",
               "full": "JOIN_FULL", "left_semi": "JOIN_LEFT_SEMI",
               "left_anti": "JOIN_LEFT_ANTI", "existence": "JOIN_EXISTENCE"}


def _join_keys(n, left_keys, right_keys, condition) -> None:
    for e in left_keys:
        n.left_keys.add().CopyFrom(expr_to_proto(e))
    for e in right_keys:
        n.right_keys.add().CopyFrom(expr_to_proto(e))
    if condition is not None:
        n.condition.CopyFrom(expr_to_proto(condition))
        n.has_condition = True


def sort_merge_join(left, right, left_keys, right_keys, join_type, condition=None):
    n = pb.SortMergeJoinNode(left=left, right=right,
                             join_type=getattr(pb, _JOIN_TYPES[join_type]))
    _join_keys(n, left_keys, right_keys, condition)
    return _wrap(sort_merge_join=n)


def hash_join(left, right, left_keys, right_keys, join_type, build_side="right",
              condition=None, cached_build_id: str = ""):
    n = pb.HashJoinNode(left=left, right=right, join_type=getattr(pb, _JOIN_TYPES[join_type]),
                        build_side=pb.BUILD_LEFT if build_side == "left" else pb.BUILD_RIGHT,
                        cached_build_id=cached_build_id)
    _join_keys(n, left_keys, right_keys, condition)
    return _wrap(hash_join=n)


def hash_partitioning(exprs: list[ir.Expr], n: int):
    p = pb.Partitioning(kind=pb.Partitioning.HASH, num_partitions=n)
    for e in exprs:
        p.hash_exprs.add().CopyFrom(expr_to_proto(e))
    return p


def shuffle_writer(child, partitioning, data_file: str, index_file: str):
    return _wrap(shuffle_writer=pb.ShuffleWriterNode(
        child=child, partitioning=partitioning, output_data_file=data_file,
        output_index_file=index_file))


def mesh_exchange(child, partitioning, exchange_id: str = ""):
    """A repartition boundary that ``parallel/mesh_driver.MeshQueryDriver``
    resolves (device-resident or file transport, per ``exchange.mode``)."""
    return _wrap(mesh_exchange=pb.MeshExchangeNode(child=child, partitioning=partitioning,
                                                   exchange_id=exchange_id))


def rss_shuffle_writer(child, partitioning, rss_resource_id: str):
    return _wrap(rss_shuffle_writer=pb.RssShuffleWriterNode(
        child=child, partitioning=partitioning, rss_resource_id=rss_resource_id))


def ipc_reader(schema: T.Schema, resource_id: str):
    return _wrap(ipc_reader=pb.IpcReaderNode(schema=schema_to_proto(schema),
                                             resource_id=resource_id))


def window(child, partition_by: list[ir.Expr], order_by: list[tuple[ir.Expr, SortSpec]],
           funcs: list[tuple]):
    """funcs: (kind, agg, expr, offset, frame_whole, name) tuples."""
    n = pb.WindowNode(child=child)
    for e in partition_by:
        n.partition_by.add().CopyFrom(expr_to_proto(e))
    for e, s in order_by:
        n.order_by.add().CopyFrom(sort_field(e, s))
    for kind, agg, e, offset, whole, name in funcs:
        f = n.funcs.add()
        f.kind = kind
        f.agg = agg or ""
        if e is not None:
            f.expr.CopyFrom(expr_to_proto(e))
            f.has_expr = True
        f.offset = offset
        f.frame_whole = whole
        f.name = name
    return _wrap(window=n)


def generate(child, generator: str, gen_expr: ir.Expr, required_cols: list[int], outer=False,
             json_fields=(), elem_name="col", pos_name="pos"):
    n = pb.GenerateNode(child=child, generator=generator, required_cols=list(required_cols),
                        outer=outer, json_fields=list(json_fields), elem_name=elem_name,
                        pos_name=pos_name)
    n.gen_expr.CopyFrom(expr_to_proto(gen_expr))
    return _wrap(generate=n)


def parquet_sink(child, output_path: str, props: dict | None = None,
                 partition_by: list[str] | None = None):
    return _wrap(parquet_sink=pb.ParquetSinkNode(
        child=child, output_path=output_path, props=props or {},
        partition_by=list(partition_by or [])))


def ipc_writer(child, resource_id: str):
    return _wrap(ipc_writer=pb.IpcWriterNode(child=child, resource_id=resource_id))


def kafka_scan(schema: T.Schema, topic: str, source_resource_id: str,
               startup_mode: str = "earliest", start_offsets: dict | None = None,
               data_format: str = "json", on_error: str = "skip",
               pb_field_ids: list[int] | None = None, max_batch_records: int = 0,
               zigzag_cols: list[int] | None = None):
    n = pb.KafkaScanNode(schema=schema_to_proto(schema), topic=topic,
                         startup_mode=startup_mode, format=data_format, on_error=on_error,
                         source_resource_id=source_resource_id,
                         max_batch_records=max_batch_records)
    for k, v in (start_offsets or {}).items():
        n.start_offsets[int(k)] = int(v)
    if pb_field_ids:
        n.pb_field_ids.extend(pb_field_ids)
    if zigzag_cols:
        n.zigzag_cols.extend(zigzag_cols)
    return _wrap(kafka_scan=n)


def task(plan, stage_id=0, partition_id=0, conf: dict | None = None):
    t = pb.TaskDefinition(plan=plan, stage_id=stage_id, partition_id=partition_id)
    for k, v in (conf or {}).items():
        t.conf[k] = str(v)
    return t
