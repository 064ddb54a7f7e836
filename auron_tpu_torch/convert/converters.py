"""Per-operator host-plan -> proto conversion and maximal-subtree
segmentation (port of ``auron_tpu/convert/converters.py``, the reference's
AuronConverters).

After tagging, every maximal convertible subtree is lowered into one native
plan (a ``NativeSegment``); an unconvertible child below it becomes an
``ffi_reader`` boundary node whose rows the host feeds through the resource
map at run time. Spark shuffle exchanges convert to ``mesh_exchange``
nodes: a converted multi-stage plan runs under ``MeshQueryDriver``, or
splits into host-scheduled stages (``convert/stages.py``).

Parquet/ORC scans and sinks and the Kafka source convert as in the
reference; the planner runs the file scans and sinks, and refuses the
Kafka source (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import decimal as pydec
from dataclasses import dataclass, field

from auron_tpu_torch import proto as pb
from auron_tpu_torch import types as T
from auron_tpu_torch.convert.exprs import convert_expr, convert_sort_fields
from auron_tpu_torch.convert.hostplan import HostNode, parse_type
from auron_tpu_torch.convert.strategy import ConvertTags, tag_plan
from auron_tpu_torch.plan import builders as B
from auron_tpu_torch.utils.config import Configuration


@dataclass
class NativeSegment:
    """A maximal convertible subtree lowered to one native plan."""

    plan: object  # PhysicalPlanNode
    schema: T.Schema
    inputs: list[tuple[str, "ConvertedNode"]] = field(default_factory=list)
    host: HostNode | None = None  # the subtree root this segment covers

    @property
    def is_native(self) -> bool:
        return True


@dataclass
class HostOp:
    """An operator left on the host engine."""

    node: HostNode
    children: list["ConvertedNode"] = field(default_factory=list)

    @property
    def is_native(self) -> bool:
        return False


ConvertedNode = NativeSegment | HostOp


@dataclass
class ConversionResult:
    root: ConvertedNode
    tags: ConvertTags
    host_root: HostNode

    def explain(self) -> str:
        lines: list[str] = []

        def rec(n: ConvertedNode, depth: int):
            pad = "  " * depth
            if isinstance(n, NativeSegment):
                lines.append(f"{pad}NativeSegment[{n.plan.WhichOneof('plan')}]")
                for rid, child in n.inputs:
                    lines.append(f"{pad}  <- ffi:{rid}")
                    rec(child, depth + 2)
            else:
                why = self.tags.why(n.node)
                lines.append(f"{pad}Host[{n.node.op}]" + (f"  # {why}" if why else ""))
                for c in n.children:
                    rec(c, depth + 1)

        rec(self.root, 0)
        return "\n".join(lines)


def convert_plan(root: HostNode | dict | str, conf: Configuration | None = None,
                 udf_registry: dict | None = None) -> ConversionResult:
    """Tag and segment a serialized host plan (the whole L2 pipeline)."""
    if not isinstance(root, HostNode):
        root = HostNode.from_json(root)
    conf = conf or Configuration()
    conv = _Converter(conf, udf_registry)

    def try_convert(node: HostNode, tags: ConvertTags) -> None:
        # trial conversion with the child boundaries stubbed as ffi readers
        conv.to_proto(node, [B.ffi_reader(c.schema, "__stub") for c in node.children])

    tags = tag_plan(root, conf, try_convert)
    seq = [0]

    def build(node: HostNode) -> ConvertedNode:
        if tags.ok(node):
            inputs: list[tuple[str, ConvertedNode]] = []
            proto = lower(node, inputs)
            return NativeSegment(proto, node.schema, inputs, host=node)
        return HostOp(node, [build(c) for c in node.children])

    def lower(node: HostNode, inputs):
        child_protos = []
        for c in node.children:
            if tags.ok(c):
                child_protos.append(lower(c, inputs))
            else:
                rid = f"__convert_input_{seq[0]}"
                seq[0] += 1
                inputs.append((rid, build(c)))
                child_protos.append(B.ffi_reader(c.schema, rid))
        return conv.to_proto(node, child_protos)

    return ConversionResult(build(root), tags, root)


def _bound_value(v, dt: T.DataType):
    """A JSON bound value as the typed scalar of its column: what the
    reference's ``pyarrow.array(values, type)`` takes (an int or a Decimal
    for a decimal, whole numbers for the integer and temporal types), and
    its refusal otherwise."""
    if v is None:
        return None
    k = dt.kind
    if k == T.TypeKind.DECIMAL:
        if isinstance(v, bool) or not isinstance(v, (int, pydec.Decimal)):
            raise TypeError(f"int or Decimal object expected, got {type(v).__name__}")
        return pydec.Decimal(v)
    if dt.is_integer or k in (T.TypeKind.DATE32, T.TypeKind.TIMESTAMP):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise TypeError(f"object of type {type(v)} cannot be converted to int")
        if v != int(v):
            raise ValueError(f"Float value {v} was truncated converting to {dt.kind.value}")
        return int(v)
    if dt.is_float:
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise TypeError(f"Could not convert {v!r} with type {type(v).__name__}: tried to "
                            "convert to double")
        return float(v)
    if k == T.TypeKind.BOOL:
        if not isinstance(v, bool):
            raise TypeError(f"Expected bool, got {type(v).__name__}")
        return v
    raise ValueError(f"range bounds over {dt} keys")


def _range_partitioning_proto(fields, num: int, bound_rows: list):
    """RANGE partitioning proto from host-sampled bound rows.

    ``bound_rows``: one row per bound, each a list of typed literal dicts
    ({"value": v, "type": t}) for the sort keys. The bound words are the
    rows' ``sort_operands`` words, computed on the CPU from a batch built by
    the port's own column constructors. Dictionary-encoded keys (strings)
    are refused, since their words are per-vocabulary ranks that do not
    compare against data batches, so the exchange degrades to the host."""
    import numpy as np

    from auron_tpu_torch.columnar.batch import column_from_pylist
    from auron_tpu_torch.exprs.eval import ColumnVal
    from auron_tpu_torch.ops.sortkeys import sort_operands
    from auron_tpu_torch.ops.uwords import u64_numpy

    specs = [s for _, s in fields]
    part = pb.Partitioning(kind=pb.Partitioning.RANGE, num_partitions=num)
    for e, s in fields:
        part.range_fields.add().CopyFrom(B.sort_field(e, s))
    if not bound_rows:
        if num > 1:
            # without host-sampled bounds every row would route to partition
            # 0: degrade to host execution instead of mis-scattering
            raise ValueError("range partitioning requires host-sampled bounds")
        part.range_words_per_bound = 2 * len(fields)
        return part
    n = len(bound_rows)
    keys = []
    for k in range(len(bound_rows[0])):
        dt = parse_type(bound_rows[0][k]["type"])
        if dt.is_dict_encoded:
            raise ValueError("range bounds over dictionary-encoded keys")
        values = [_bound_value(r[k]["value"], dt) for r in bound_rows]
        keys.append(ColumnVal(*column_from_pylist(values, dt, n, "cpu")[:2], dt))
    mat = np.stack([u64_numpy(w) for w in sort_operands(keys, specs)], axis=1)
    part.range_words_per_bound = mat.shape[1]
    part.range_bound_words.extend(int(x) for x in mat.reshape(-1))
    return part


# ---------------------------------------------------------------------------
# per-operator converters (the reference's AuronConverters case set)
# ---------------------------------------------------------------------------


class _Converter:
    def __init__(self, conf: Configuration, udf_registry: dict | None):
        self.conf = conf
        self.udfs = udf_registry

    def expr(self, e: dict):
        return convert_expr(e, self.conf, self.udfs)

    def sort_fields(self, fields: list[dict]):
        return convert_sort_fields(fields, self.conf, self.udfs)

    def to_proto(self, node: HostNode, children: list):
        fn = getattr(self, "_c_" + node.op, None)
        if fn is None:
            from auron_tpu_torch.convert.providers import find_provider

            provider = find_provider(node, self.conf)
            if provider is not None:
                return provider.convert(node, children, self.conf)
            raise ValueError(f"{node.op} has no converter")
        return fn(node, children)

    # ---- scans ----

    def _c_LocalTableScanExec(self, n, ch):
        return B.memory_scan(n.schema, n.args["resource_id"])

    def _c_FileSourceScanExec(self, n, ch):
        fmt = n.args.get("format", "parquet")
        pruning = [self.expr(e) for e in n.args.get("filters", [])]
        # host-decided task placement: "partitions" (per-task file groups)
        # beats the flat "files" list
        partitions = n.args.get("partitions")
        if fmt == "orc":
            node = pb.OrcScanNode(schema=B.schema_to_proto(n.schema),
                                  file_paths=list(n.args["files"]),
                                  fs_resource_id=n.args.get("fs_resource_id", ""))
            for p in pruning:
                node.pruning_predicates.add().CopyFrom(B.expr_to_proto(p))
            for group in partitions or []:
                node.partitions.add().paths.extend(group)
            return B._wrap(orc_scan=node)
        node = B.parquet_scan(n.schema, n.args["files"], pruning,
                              n.args.get("fs_resource_id", ""))
        for group in partitions or []:
            node.parquet_scan.partitions.add().paths.extend(group)
        return node

    _c_OrcScanExec = _c_FileSourceScanExec

    # ---- stateless ----

    def _c_ProjectExec(self, n, ch):
        exprs = [self.expr(e) for e in n.args["projections"]]
        return B.project(ch[0], list(zip(exprs, n.schema.names)))

    def _c_FilterExec(self, n, ch):
        return B.filter_(ch[0], [self.expr(e) for e in n.args["predicates"]])

    def _c_LocalLimitExec(self, n, ch):
        return B.limit(ch[0], int(n.args["limit"]))

    _c_GlobalLimitExec = _c_LocalLimitExec

    def _c_UnionExec(self, n, ch):
        return B.union(list(ch))

    def _c_ExpandExec(self, n, ch):
        projections = [[self.expr(e) for e in proj] for proj in n.args["projections"]]
        return B.expand(ch[0], projections, list(n.schema.names))

    # ---- sort / limit+sort ----

    def _c_SortExec(self, n, ch):
        return B.sort(ch[0], self.sort_fields(n.args["order"]))

    def _c_TakeOrderedAndProjectExec(self, n, ch):
        sorted_ = B.sort(ch[0], self.sort_fields(n.args["order"]), fetch=int(n.args["limit"]))
        exprs = [self.expr(e) for e in n.args.get("projections", [])]
        if not exprs:
            return sorted_
        return B.project(sorted_, list(zip(exprs, n.schema.names)))

    # ---- aggregation ----

    def _c_HashAggregateExec(self, n, ch):
        mode = n.args.get("mode", "partial")
        groupings = [(self.expr(g["expr"]), g["name"]) for g in n.args.get("groupings", [])]
        aggs = []
        for a in n.args.get("aggs", []):
            fn = a["fn"].lower()
            e = self.expr(a["expr"]) if a.get("expr") is not None else None
            aggs.append((fn, e, a["name"]) + ((a["udaf"],) if a.get("udaf") else ()))
        return B.hash_agg(ch[0], groupings, aggs, mode)

    _c_ObjectHashAggregateExec = _c_HashAggregateExec
    _c_SortAggregateExec = _c_HashAggregateExec

    # ---- joins ----

    def _condition(self, n):
        return self.expr(n.args["condition"]) if n.args.get("condition") else None

    def _c_SortMergeJoinExec(self, n, ch):
        return B.sort_merge_join(ch[0], ch[1], [self.expr(e) for e in n.args["left_keys"]],
                                 [self.expr(e) for e in n.args["right_keys"]],
                                 n.args.get("join_type", "inner"), condition=self._condition(n))

    def _c_BroadcastHashJoinExec(self, n, ch):
        return B.hash_join(ch[0], ch[1], [self.expr(e) for e in n.args["left_keys"]],
                           [self.expr(e) for e in n.args["right_keys"]],
                           n.args.get("join_type", "inner"),
                           build_side=n.args.get("build_side", "right"),
                           condition=self._condition(n),
                           cached_build_id=n.args.get("cached_build_id", ""))

    _c_ShuffledHashJoinExec = _c_BroadcastHashJoinExec

    # ---- window / generate ----

    def _c_WindowExec(self, n, ch):
        order = self.sort_fields(n.args.get("order", []))
        funcs = []
        for f in n.args["funcs"]:
            e = self.expr(f["expr"]) if f.get("expr") is not None else None
            if f["kind"] in ("lead", "lag", "nth_value", "ntile"):
                # the offset is required and static: a missing or null offset
                # fails the trial conversion (int(None) raises)
                offset = int(f["offset"])
            else:
                offset = int(f.get("offset", 1))
            funcs.append((f["kind"], f.get("agg"), e, offset, bool(f.get("frame_whole", False)),
                          f["name"]))
        return B.window(ch[0], [self.expr(e) for e in n.args.get("partition_by", [])], order,
                        funcs)

    def _c_WindowGroupLimitExec(self, n, ch):
        # planned as a rank-family window + filter; the host shim ships it as
        # a WindowExec with a limit arg instead
        raise ValueError("ship WindowGroupLimitExec as WindowExec + limit")

    def _c_GenerateExec(self, n, ch):
        return B.generate(ch[0], n.args["generator"], self.expr(n.args["gen_expr"]),
                          list(n.args.get("required_cols", [])),
                          outer=bool(n.args.get("outer", False)),
                          json_fields=n.args.get("json_fields", ()))

    # ---- exchanges / sinks ----

    def _c_ShuffleExchangeExec(self, n, ch):
        p = n.args["partitioning"]
        kind = p.get("kind", "hash")
        num = int(p.get("num_partitions", 1))
        if kind == "hash":
            part = B.hash_partitioning([self.expr(e) for e in p["exprs"]], num)
        elif kind == "single":
            part = pb.Partitioning(kind=pb.Partitioning.SINGLE, num_partitions=1)
        elif kind == "round_robin":
            part = pb.Partitioning(kind=pb.Partitioning.ROUND_ROBIN, num_partitions=num)
        elif kind == "range":
            # bounds are sampled on the host and ship as typed literal rows;
            # the engine turns them into orderable words
            part = _range_partitioning_proto(self.sort_fields(p["order"]), num,
                                             p.get("bounds", []))
        else:
            raise ValueError(f"unsupported partitioning {kind}")
        return B.mesh_exchange(ch[0], part, n.args.get("exchange_id", ""))

    def _c_BroadcastExchangeExec(self, n, ch):
        # broadcast materialization is host-driven; inside a segment it is
        # the identity on its child (build reuse: cached_build_id)
        return ch[0]

    def _c_KafkaSourceExec(self, n, ch):
        """The streaming table source of the Flink front end; its resource is
        a JSON client config the task runtime materializes."""
        return B.kafka_scan(
            n.schema, n.args["topic"], n.args["source_resource_id"],
            startup_mode=n.args.get("startup_mode", "earliest"),
            start_offsets={int(k): int(v) for k, v in (n.args.get("start_offsets") or {}).items()},
            data_format=n.args.get("format", "json"),
            on_error=n.args.get("on_error", "skip"),
            max_batch_records=int(n.args.get("max_batch_records", 0)),
            pb_field_ids=[int(x) for x in n.args.get("pb_field_ids") or []] or None,
            zigzag_cols=[int(x) for x in n.args.get("zigzag_cols") or []] or None,
        )

    def _c_DataWritingCommandExec(self, n, ch):
        fmt = n.args.get("format", "parquet")
        partition_by = n.args.get("partition_by") or []
        if fmt == "parquet":
            return B.parquet_sink(ch[0], n.args["path"], n.args.get("props"),
                                  partition_by=partition_by)
        if partition_by:
            raise ValueError("dynamic partitioning is parquet-only for now")
        return B._wrap(orc_sink=pb.OrcSinkNode(child=ch[0], output_path=n.args["path"],
                                               props=n.args.get("props") or {}))
