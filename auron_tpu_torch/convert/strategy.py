"""Bottom-up convertibility tagging and inefficient-convert removal (port
of ``auron_tpu/convert/strategy.py``, the reference's
AuronConvertStrategy):

1. every node is trial-converted bottom-up; a failure tags it
   NeverConvert with a reason, and the per-operator enable flags
   (``convert.enable.<op>``, the same keys as the reference's) gate
   conversion;
2. a fixpoint pass reverts conversions that would force expensive
   row<->columnar boundaries for little native benefit: a filter or
   aggregate over a non-native child, a shuffle over a non-native
   aggregate, a native expand, scan or sandwiched sort feeding a
   non-native parent.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from auron_tpu_torch.convert.hostplan import HostNode
from auron_tpu_torch.utils.config import Configuration, bool_conf

# per-operator enable flags, registered once
_OP_KEYS = [
    "scan", "project", "filter", "sort", "union", "smj", "shj", "bhj",
    "local_limit", "global_limit", "take_ordered_and_project", "aggr",
    "expand", "window", "window_group_limit", "generate",
    "local_table_scan", "data_writing", "broadcast_exchange",
    "shuffle_exchange", "kafka_scan",
]
ENABLE_FLAGS = {
    k: bool_conf(f"convert.enable.{k}", True, "convert", f"convert host {k} operators to native plans")
    for k in _OP_KEYS
}

# host exec class -> enable-flag key
OP_FLAG = {
    "FileSourceScanExec": "scan",
    "OrcScanExec": "scan",
    "LocalTableScanExec": "local_table_scan",
    "ProjectExec": "project",
    "FilterExec": "filter",
    "SortExec": "sort",
    "UnionExec": "union",
    "SortMergeJoinExec": "smj",
    "ShuffledHashJoinExec": "shj",
    "BroadcastHashJoinExec": "bhj",
    "LocalLimitExec": "local_limit",
    "GlobalLimitExec": "global_limit",
    "TakeOrderedAndProjectExec": "take_ordered_and_project",
    "HashAggregateExec": "aggr",
    "ObjectHashAggregateExec": "aggr",
    "SortAggregateExec": "aggr",
    "ExpandExec": "expand",
    "WindowExec": "window",
    "WindowGroupLimitExec": "window_group_limit",
    "GenerateExec": "generate",
    "DataWritingCommandExec": "data_writing",
    "BroadcastExchangeExec": "broadcast_exchange",
    "ShuffleExchangeExec": "shuffle_exchange",
    "KafkaSourceExec": "kafka_scan",  # the streaming front end's table source
}

_AGG_OPS = {"HashAggregateExec", "ObjectHashAggregateExec", "SortAggregateExec"}


@dataclass
class ConvertTags:
    """Per-node conversion verdicts, keyed by node identity."""

    convertible: dict[int, bool] = field(default_factory=dict)
    reason: dict[int, str] = field(default_factory=dict)

    def ok(self, node: HostNode) -> bool:
        return self.convertible.get(id(node), False)

    def never(self, node: HostNode, reason: str) -> None:
        self.convertible[id(node)] = False
        self.reason.setdefault(id(node), reason)

    def why(self, node: HostNode) -> str | None:
        return self.reason.get(id(node))

    def summary(self, root: HostNode) -> list[tuple[str, bool, str | None]]:
        return [(n.op, self.ok(n), self.why(n)) for n in root.walk_down()]


def tag_plan(root: HostNode, conf: Configuration, try_convert) -> ConvertTags:
    """Bottom-up trial conversion. ``try_convert(node, tags)`` raises with a
    reason when the node (its children assumed converted where tagged)
    cannot convert."""
    from auron_tpu_torch.convert.providers import find_provider

    tags = ConvertTags()
    for node in root.walk_up():
        if node.schema_error is not None:
            # an unsupported column type: only the owning node degrades
            tags.never(node, f"{node.op}: {node.schema_error}")
            continue
        flag_key = OP_FLAG.get(node.op)
        if flag_key is None:
            # the extension point: table-format and third-party providers
            if find_provider(node, conf) is not None:
                try:
                    try_convert(node, tags)
                    tags.convertible[id(node)] = True
                except Exception as e:  # noqa: BLE001 — the reason is the tag
                    tags.never(node, f"{node.op}: {e}")
                continue
            tags.never(node, f"{node.op} is not supported yet.")
            continue
        if not conf.get(ENABLE_FLAGS[flag_key]):
            tags.never(node, f"{node.op} disabled by convert.enable.{flag_key}")
            continue
        try:
            try_convert(node, tags)
            tags.convertible[id(node)] = True
        except Exception as e:  # noqa: BLE001 — the reason is the tag
            tags.never(node, f"{node.op}: {e}")
    _remove_inefficient_converts(root, tags)
    return tags


def _remove_inefficient_converts(root: HostNode, tags: ConvertTags) -> None:
    """The fixpoint rule set of AuronConvertStrategy.removeInefficientConverts."""
    finished = False
    while not finished:
        finished = True

        def dont_convert(node: HostNode, cond: bool, reason: str):
            nonlocal finished
            if cond and tags.ok(node):
                tags.never(node, reason)
                finished = False

        def induced_boundary(e: HostNode) -> bool:
            """True when converting e would create a row->columnar boundary.
            A FlinkStreamInput child is a declared stream boundary: the
            conversion costs the same either way, so the rule keeps e."""
            return (bool(e.children) and not tags.ok(e.children[0])
                    and e.children[0].op != "FlinkStreamInput")

        for e in root.walk_down():
            # non-native -> native filter / aggregate: converting would force
            # a row->columnar conversion of a large input
            if tags.ok(e) and e.op == "FilterExec":
                dont_convert(e, induced_boundary(e), f"{e.op}, children is not native.")
            if tags.ok(e) and e.op in _AGG_OPS:
                dont_convert(e, induced_boundary(e), f"{e.op}, children is not native.")
            # aggregate -> native shuffle: the next stage likely reads
            # non-natively
            if tags.ok(e) and e.op == "ShuffleExchangeExec":
                c = e.children[0] if e.children else None
                dont_convert(e, c is not None and c.op in _AGG_OPS and not tags.ok(c),
                             f"{e.op}, children is not native and children is agg.")
            # a native expand or scan feeding a non-native parent forces a
            # columnar->row conversion of a large output
            if not tags.ok(e):
                for c in e.children:
                    if c.op == "ExpandExec":
                        dont_convert(c, tags.ok(c), f"{e.op}, children is nativeExpand.")
                    if c.op in ("FileSourceScanExec", "OrcScanExec"):
                        dont_convert(c, tags.ok(c), f"{e.op}, children is nativeParquetScan.")
                    # non-native -> native sort -> non-native sandwich
                    if c.op == "SortExec":
                        dont_convert(c, tags.ok(c) and c.children and not tags.ok(c.children[0]),
                                     f"{e.op}, children and parent both are not native.")
