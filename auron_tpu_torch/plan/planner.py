"""Physical planner: plan proto -> executable operator tree.

Port of ``auron_tpu/plan/planner.py`` for the node and expression variants
the ported slices execute (memory_scan, ffi_reader, parquet_scan,
orc_scan, parquet_sink, orc_sink, ipc_writer, project,
filter, limit, union,
expand, rename_columns, empty_partitions, coalesce_batches, debug,
hash_agg, sort, window, generate, hash_join, sort_merge_join, shuffle_writer and
rss_shuffle_writer with single/hash/round-robin/range partitioning, ipc_reader,
kafka_scan (``exec/streaming.KafkaScanExec``), mesh_exchange (a
``MeshExchangeExec`` stage boundary that
``parallel/mesh_driver.MeshQueryDriver`` resolves); column, literal, cast,
binary, not, is_null, is_not_null, if_expr, case_expr, in_list, coalesce,
like, scalar_func, host_udf (through ``bridge/udf.py``), spark_partition_id,
monotonic_id, row_num, scalar_subquery).
Other variants raise ``NotImplementedError`` naming the variant.

The exec tree is the JAX package's tree with whole-stage fusion off
(``exec.fuse.enable=off``), which the JAX package guarantees gives
bit-identical results (plan/fusion.py:1200-1206). Plan protos are the
port's own codec's messages (``auron_tpu_torch.proto``); a message of
another implementation with the same schema reads the same.
"""

from __future__ import annotations

from auron_tpu_torch import types as T
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.ops.sortkeys import SortSpec
from auron_tpu_torch.utils.config import Configuration


def _pb():
    """The plan IR's message classes (``auron_tpu_torch.proto``)."""
    from auron_tpu_torch import proto

    return proto


def dtype_from_proto(p) -> T.DataType:
    kind = T.TypeKind[_pb().DataType.Kind.Name(p.kind)]
    if kind == T.TypeKind.LIST:
        return T.DataType(kind, inner=(dtype_from_proto(p.inner),))
    if kind in (T.TypeKind.MAP, T.TypeKind.STRUCT):
        return T.DataType(kind, inner=tuple(dtype_from_proto(i) for i in p.inners),
                          struct_names=tuple(p.struct_names))
    return T.DataType(kind, p.precision, p.scale)


def dtype_to_proto(t: T.DataType):
    pb = _pb()
    try:
        kind = pb.DataType.Kind.Value(t.kind.name)
    except ValueError:
        # a kind with no wire form (UNSUPPORTED, a host column type the engine
        # cannot represent) fails as the reference's kind lookup does
        raise KeyError(t.kind) from None
    p = pb.DataType(kind=kind, precision=t.precision, scale=t.scale)
    if t.kind == T.TypeKind.LIST:
        p.inner.CopyFrom(dtype_to_proto(t.inner[0]))
    elif t.kind in (T.TypeKind.MAP, T.TypeKind.STRUCT):
        p.inners.extend(dtype_to_proto(i) for i in t.inner)
        if t.struct_names:
            p.struct_names.extend(t.struct_names)
    return p


def schema_from_proto(p) -> T.Schema:
    return T.Schema(tuple(T.Field(f.name, dtype_from_proto(f.dtype), f.nullable)
                          for f in p.fields))


def schema_to_proto(s: T.Schema):
    pb = _pb()
    return pb.Schema(fields=[pb.Field(name=f.name, dtype=dtype_to_proto(f.dtype),
                                      nullable=f.nullable) for f in s.fields])


def _literal_from_proto(p) -> ir.Literal:
    dt = dtype_from_proto(p.dtype)
    if p.is_null:
        return ir.Literal(None, dt)
    which = p.WhichOneof("value")
    if which in ("bool_value", "int_value", "float_value", "string_value", "bytes_value"):
        return ir.Literal(getattr(p, which), dt)
    if which == "decimal_unscaled":
        import decimal

        return ir.Literal(decimal.Decimal(p.decimal_unscaled).scaleb(-dt.scale), dt)
    return ir.Literal(None, dt)


def _in_item(lit: ir.Literal):
    """An IN item: its value, or the Literal itself for a decimal, whose
    type a bare Decimal value does not carry."""
    return lit if lit.dtype.kind == T.TypeKind.DECIMAL and lit.value is not None else lit.value


def expr_from_proto(p) -> ir.Expr:
    which = p.WhichOneof("expr")
    if which == "column":
        return ir.Column(p.column.index, p.column.name)
    if which == "literal":
        return _literal_from_proto(p.literal)
    if which == "cast":
        return ir.Cast(expr_from_proto(p.cast.child), dtype_from_proto(p.cast.to),
                       p.cast.try_cast)
    if which == "binary":
        return ir.BinaryOp(p.binary.op, expr_from_proto(p.binary.left),
                           expr_from_proto(p.binary.right))
    if which == "is_null":
        return ir.IsNull(expr_from_proto(p.is_null.child))
    if which == "is_not_null":
        return ir.IsNotNull(expr_from_proto(p.is_not_null.child))
    if which == "not":
        return ir.Not(expr_from_proto(getattr(p, "not").child))
    if which == "if_expr":
        return ir.If(expr_from_proto(p.if_expr.cond), expr_from_proto(p.if_expr.then),
                     expr_from_proto(p.if_expr.orelse))
    if which == "case_expr":
        n = p.case_expr
        return ir.Case(tuple((expr_from_proto(b.when), expr_from_proto(b.then))
                             for b in n.branches),
                       expr_from_proto(n.orelse) if n.HasField("orelse") else None)
    if which == "in_list":
        return ir.In(expr_from_proto(p.in_list.child),
                     tuple(_in_item(_literal_from_proto(i)) for i in p.in_list.items),
                     p.in_list.negated)
    if which == "coalesce":
        return ir.Coalesce(tuple(expr_from_proto(a) for a in p.coalesce.args))
    if which == "like":
        return ir.Like(expr_from_proto(p.like.child), p.like.pattern, p.like.negated,
                       p.like.escape or "\\")
    if which == "scalar_func":
        n = p.scalar_func
        return ir.ScalarFunc(n.name, tuple(expr_from_proto(a) for a in n.args),
                             dtype_from_proto(n.out_dtype) if n.has_out_dtype else None)
    if which == "host_udf":
        n = p.host_udf
        return ir.HostUDF(n.name, tuple(expr_from_proto(a) for a in n.args),
                          dtype_from_proto(n.out_dtype))
    if which == "spark_partition_id":
        return ir.SparkPartitionId()
    if which == "monotonic_id":
        return ir.MonotonicId()
    if which == "row_num":
        return ir.RowNum()
    if which == "scalar_subquery":
        return ir.ScalarSubquery(p.scalar_subquery.resource_id,
                                 dtype_from_proto(p.scalar_subquery.dtype))
    raise NotImplementedError(f"expression variant {which} is not in this slice of the port")


def _sort_fields(fields):
    return ([expr_from_proto(f.expr) for f in fields],
            [SortSpec(asc=f.asc, nulls_first=f.nulls_first) for f in fields])


_AGG_FUNC = {0: "sum", 1: "count", 2: "count_star", 3: "avg", 4: "min", 5: "max",
             6: "first", 7: "first_ignores_null", 8: "collect_list", 9: "collect_set",
             10: "host_udaf"}
_AGG_MODE = {0: "partial", 1: "partial_merge", 2: "final"}
_JOIN_TYPE = {0: "inner", 1: "left", 2: "right", 3: "full", 4: "left_semi",
              5: "left_anti", 6: "existence"}


def partitioning_from_proto(p):
    from auron_tpu_torch.exec.shuffle.partitioning import (
        HashPartitioning, RoundRobinPartitioning, SinglePartitioning,
    )

    pb = _pb()
    if p.kind == pb.Partitioning.SINGLE:
        return SinglePartitioning()
    if p.kind == pb.Partitioning.HASH:
        return HashPartitioning([expr_from_proto(e) for e in p.hash_exprs], p.num_partitions)
    if p.kind == pb.Partitioning.ROUND_ROBIN:
        return RoundRobinPartitioning(p.num_partitions)
    if p.kind == pb.Partitioning.RANGE:
        import numpy as np

        from auron_tpu_torch.exec.shuffle.partitioning import RangePartitioning

        exprs, specs = _sort_fields(p.range_fields)
        w = p.range_words_per_bound
        arr = np.array(list(p.range_bound_words), dtype=np.uint64)
        bounds = arr.reshape(-1, w) if w else np.zeros((0, 1), np.uint64)
        return RangePartitioning(exprs, specs, p.num_partitions, bounds)
    raise ValueError(p.kind)


def plan_from_proto(p):
    from auron_tpu_torch.exec import basic
    from auron_tpu_torch.exec.agg_exec import AggExpr, HashAggExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec
    from auron_tpu_torch.exec.sort_exec import SortExec

    pb = _pb()
    which = p.WhichOneof("plan")
    if which == "memory_scan":
        return basic.ResourceScanExec(schema_from_proto(p.memory_scan.schema),
                                      p.memory_scan.resource_id)
    if which == "ffi_reader":
        from auron_tpu_torch.exec.scan import FFIReaderExec

        return FFIReaderExec(schema_from_proto(p.ffi_reader.schema), p.ffi_reader.resource_id)
    if which in ("parquet_scan", "orc_scan"):
        from auron_tpu_torch.exec.scan import OrcScanExec, ParquetScanExec

        n = getattr(p, which)
        return (ParquetScanExec if which == "parquet_scan" else OrcScanExec)(
            schema_from_proto(n.schema), list(n.file_paths),
            [expr_from_proto(e) for e in n.pruning_predicates], n.fs_resource_id or None,
            partitions=[list(fp.paths) for fp in n.partitions] or None)
    if which == "parquet_sink":
        from auron_tpu_torch.exec.sink import ParquetSinkExec

        n = p.parquet_sink
        return ParquetSinkExec(plan_from_proto(n.child), n.output_path, dict(n.props),
                               partition_by=list(n.partition_by) or None)
    if which == "orc_sink":
        from auron_tpu_torch.exec.sink import OrcSinkExec

        n = p.orc_sink
        return OrcSinkExec(plan_from_proto(n.child), n.output_path, dict(n.props))
    if which == "ipc_writer":
        from auron_tpu_torch.exec.sink import IpcWriterExec

        return IpcWriterExec(plan_from_proto(p.ipc_writer.child), p.ipc_writer.resource_id)
    if which == "project":
        return basic.ProjectExec(plan_from_proto(p.project.child),
                                 [expr_from_proto(e.expr) for e in p.project.exprs],
                                 [e.name for e in p.project.exprs])
    if which == "filter":
        return basic.FilterExec(plan_from_proto(p.filter.child),
                                [expr_from_proto(e) for e in p.filter.predicates])
    if which == "limit":
        return basic.LimitExec(plan_from_proto(p.limit.child), p.limit.limit)
    if which == "union":
        return basic.UnionExec([plan_from_proto(c) for c in p.union.children])
    if which == "expand":
        return basic.ExpandExec(plan_from_proto(p.expand.child),
                                [[expr_from_proto(e) for e in proj.exprs]
                                 for proj in p.expand.projections],
                                list(p.expand.names))
    if which == "rename_columns":
        return basic.RenameColumnsExec(plan_from_proto(p.rename_columns.child),
                                       list(p.rename_columns.names))
    if which == "empty_partitions":
        return basic.EmptyPartitionsExec(schema_from_proto(p.empty_partitions.schema),
                                         p.empty_partitions.num_partitions)
    if which == "coalesce_batches":
        return basic.CoalesceBatchesExec(plan_from_proto(p.coalesce_batches.child),
                                         p.coalesce_batches.target_rows or None)
    if which == "debug":
        return basic.DebugExec(plan_from_proto(p.debug.child), p.debug.tag)
    if which == "window":
        from auron_tpu_torch.exec.window_exec import WindowExec, WindowFunc

        n = p.window
        order_exprs, order_specs = _sort_fields(n.order_by)
        return WindowExec(
            plan_from_proto(n.child), [expr_from_proto(e) for e in n.partition_by],
            list(zip(order_exprs, order_specs)),
            [(WindowFunc(f.kind, agg=f.agg or None,
                         expr=expr_from_proto(f.expr) if f.has_expr else None,
                         offset=f.offset or 1, frame_whole=f.frame_whole), f.name)
             for f in n.funcs],
        )
    if which == "generate":
        from auron_tpu_torch.exec.generate_exec import GenerateExec

        n = p.generate
        return GenerateExec(plan_from_proto(n.child), n.generator, expr_from_proto(n.gen_expr),
                            list(n.required_cols), outer=n.outer,
                            json_fields=list(n.json_fields), elem_name=n.elem_name or "col",
                            pos_name=n.pos_name or "pos", udtf=n.udtf or None)
    if which == "hash_agg":
        n = p.hash_agg
        return HashAggExec(
            plan_from_proto(n.child),
            [(expr_from_proto(g.expr), g.name) for g in n.groupings],
            [(AggExpr(_AGG_FUNC[a.func], expr_from_proto(a.expr) if a.has_expr else None,
                      udaf=a.udaf or None), a.name) for a in n.aggs],
            _AGG_MODE[n.mode],
        )
    if which == "sort":
        n = p.sort
        exprs, specs = _sort_fields(n.fields)
        return SortExec(plan_from_proto(n.child), exprs, specs,
                        fetch=n.fetch if n.has_fetch else None)
    if which == "sort_merge_join":
        from auron_tpu_torch.exec.joins.smj import SortMergeJoinExec

        n = p.sort_merge_join
        return SortMergeJoinExec(
            plan_from_proto(n.left), plan_from_proto(n.right),
            [expr_from_proto(e) for e in n.left_keys],
            [expr_from_proto(e) for e in n.right_keys],
            _JOIN_TYPE[n.join_type],
            condition=expr_from_proto(n.condition) if n.has_condition else None,
            exists_col=n.exists_col or "exists",
            projection=list(n.projection) if n.has_projection else None,
        )
    if which == "hash_join":
        n = p.hash_join
        return BroadcastHashJoinExec(
            plan_from_proto(n.left), plan_from_proto(n.right),
            [expr_from_proto(e) for e in n.left_keys],
            [expr_from_proto(e) for e in n.right_keys],
            _JOIN_TYPE[n.join_type],
            build_side="left" if n.build_side == pb.BUILD_LEFT else "right",
            condition=expr_from_proto(n.condition) if n.has_condition else None,
            cached_build_id=n.cached_build_id or None,
            exists_col=n.exists_col or "exists",
            projection=list(n.projection) if n.has_projection else None,
        )
    if which == "shuffle_writer":
        from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec

        n = p.shuffle_writer
        return ShuffleWriterExec(plan_from_proto(n.child),
                                 partitioning_from_proto(n.partitioning),
                                 n.output_data_file, n.output_index_file)
    if which == "rss_shuffle_writer":
        from auron_tpu_torch.exec.shuffle.writer import RssShuffleWriterExec

        n = p.rss_shuffle_writer
        return RssShuffleWriterExec(plan_from_proto(n.child),
                                    partitioning_from_proto(n.partitioning), n.rss_resource_id)
    if which == "ipc_reader":
        from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec

        return IpcReaderExec(schema_from_proto(p.ipc_reader.schema), p.ipc_reader.resource_id)
    if which == "mesh_exchange":
        from auron_tpu_torch.parallel.mesh_driver import MeshExchangeExec

        n = p.mesh_exchange
        return MeshExchangeExec(plan_from_proto(n.child), partitioning_from_proto(n.partitioning),
                                n.exchange_id)
    if which == "kafka_scan":
        from auron_tpu_torch.exec.streaming import KafkaScanExec

        n = p.kafka_scan
        return KafkaScanExec(
            schema_from_proto(n.schema), n.topic, n.source_resource_id,
            startup_mode=n.startup_mode or "earliest",
            start_offsets={int(k): int(v) for k, v in n.start_offsets.items()},
            data_format=n.format or "json",
            on_error=n.on_error or "skip",
            pb_field_ids=list(n.pb_field_ids) or None,
            max_batch_records=n.max_batch_records or 8192,
            zigzag_cols=set(n.zigzag_cols) or None,
        )
    raise NotImplementedError(f"plan variant {which} is not in this slice of the port")


def tree_from_plan(plan, mode: str = "build"):
    """The exec tree of a plan proto before fusion: SMJ input sorts elided
    in ``mode`` (``elide_smj_input_sorts``), columns pruned, operators
    planned. ``task_from_proto`` fuses it for the task's device."""
    from auron_tpu_torch.plan.optimizer import elide_smj_input_sorts, prune_columns

    return plan_from_proto(prune_columns(elide_smj_input_sorts(plan, mode=mode)))


def task_from_proto(task, device: str = "cuda"):
    """(root exec, stage_id, partition_id, Configuration) of a decoded
    TaskDefinition. As in auron_tpu, shuffle-writer path templates are
    filled from the task (``resolve_shuffle_templates``), the SMJ input
    sorts are elided in the mode the task conf's ``auron.smj.elide.sorts``
    names (default build), column pruning runs on every task, and
    whole-stage fusion rewrites the exec tree for the task's ``device``
    (``plan/fusion.py``; the protos are untouched)."""
    from auron_tpu_torch.plan.fusion import fuse_exec_tree
    from auron_tpu_torch.plan.optimizer import SMJ_ELIDE_SORTS_KEY

    resolve_shuffle_templates(task)
    conf = Configuration(dict(task.conf))
    plan = tree_from_plan(task.plan, dict(task.conf).get(SMJ_ELIDE_SORTS_KEY, "build"))
    return fuse_exec_tree(plan, conf, device), task.stage_id, task.partition_id, conf


def resolve_shuffle_templates(task) -> None:
    """Fill the ``{work_dir}`` and ``{partition}`` placeholders of the
    task's shuffle-writer paths from its conf's ``auron.work_dir`` and its
    partition id (reference ``planner.py:538-567``): a host ships a stage's
    plan template and sets only the partition and the conf."""
    from auron_tpu_torch.plan.protowalk import child_nodes

    work_dir = task.conf.get("auron.work_dir", "")

    def rec(node) -> None:
        if node.WhichOneof("plan") == "shuffle_writer":
            w = node.shuffle_writer
            for attr in ("output_data_file", "output_index_file"):
                v = getattr(w, attr)
                if "{work_dir}" in v or "{partition}" in v:
                    if "{work_dir}" in v and not work_dir:
                        raise ValueError("shuffle path template needs task conf auron.work_dir")
                    setattr(w, attr, v.replace("{work_dir}", work_dir)
                            .replace("{partition}", str(task.partition_id)))
        for c in child_nodes(node):
            rec(c)

    rec(task.plan)


def decode_task(task_bytes: bytes):
    """A ``TaskDefinition`` message of serialized bytes (``ValueError`` on
    malformed bytes)."""
    return _pb().TaskDefinition.FromString(bytes(task_bytes))
