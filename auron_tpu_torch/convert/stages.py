"""Host-schedulable stage splitting and the shuffle-manager contract (port
of ``auron_tpu/convert/stages.py``).

The port's ``MeshQueryDriver`` resolves ``mesh_exchange`` nodes itself,
but a host engine such as Spark schedules stages itself: stage N's plan
ends in a shuffle writer whose map output the host's shuffle tracker
commits, and stage N+1 starts with a reader fed by the host's shuffle
fetch. ``split_stages`` makes that decomposition of a plan:

    stage k   = the subtree below a mesh_exchange, wrapped in a
                shuffle_writer (one task per map partition; ``stage_task``
                fills each task's .data/.index paths)
    stage k+1 = the consumer, the exchange spliced into an ipc_reader whose
                resource id is the exchange id

``ShuffleManager`` is the host side: map tasks register their (map
partition -> data/index) outputs per exchange, reduce tasks get a block
provider over exactly those files. Its JSON manifest crosses the C ABI
(``bridge/api.put_resource_shuffle``) for out-of-process hosts.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from auron_tpu_torch import proto as pb
from auron_tpu_torch.plan.protowalk import child_nodes, rewrite_children

DATA_TEMPLATE = "{work_dir}/{exchange_id}_map{partition}.data"
INDEX_TEMPLATE = "{work_dir}/{exchange_id}_map{partition}.index"


@dataclass
class StageSpec:
    """One host-schedulable stage of a split plan."""

    stage_id: int
    plan: object  # PhysicalPlanNode; a shuffle_writer root for producer stages
    exchange_id: str | None  # the exchange this stage produces (None = final)
    num_output_partitions: int | None  # reduce width of that exchange
    input_exchange_ids: list[str] = field(default_factory=list)

    @property
    def is_final(self) -> bool:
        return self.exchange_id is None

    @property
    def data_template(self) -> str | None:
        """The shuffle data-file path with {work_dir}/{partition}
        placeholders: a host computes a task's paths by substitution."""
        if self.exchange_id is None:
            return None
        return DATA_TEMPLATE.replace("{exchange_id}", self.exchange_id)

    @property
    def index_template(self) -> str | None:
        if self.exchange_id is None:
            return None
        return INDEX_TEMPLATE.replace("{exchange_id}", self.exchange_id)


def ffi_reader_ids(plan) -> list[str]:
    """Resource ids of every ffi_reader in a plan subtree, deduplicated, in
    tree order: which segment inputs feed which stage."""
    out: list[str] = []

    def rec(node) -> None:
        if node.WhichOneof("plan") == "ffi_reader":
            rid = node.ffi_reader.resource_id
            if rid not in out:
                out.append(rid)
        for c in child_nodes(node):
            rec(c)

    rec(plan)
    return out


def split_stages(plan, namespace: str = "") -> list[StageSpec]:
    """Decompose a plan with mesh_exchange nodes into host-schedulable
    stages, producers before consumers (post-order). ``namespace`` prefixes
    every exchange id (writer paths and reader resource ids), so concurrent
    conversions in one process cannot collide on resource keys."""
    stages: list[StageSpec] = []
    counter = [0]

    def rewrite(node, inputs: list[str]):
        if node.WhichOneof("plan") == "mesh_exchange":
            ex = node.mesh_exchange
            child_inputs: list[str] = []
            child = rewrite(ex.child, child_inputs)
            ex_id = namespace + (ex.exchange_id or f"__stage_exchange_{counter[0]}")
            counter[0] += 1
            writer = pb.PhysicalPlanNode(shuffle_writer=pb.ShuffleWriterNode(
                child=child, partitioning=ex.partitioning,
                output_data_file=DATA_TEMPLATE.replace("{exchange_id}", ex_id),
                output_index_file=INDEX_TEMPLATE.replace("{exchange_id}", ex_id)))
            stages.append(StageSpec(stage_id=len(stages), plan=writer, exchange_id=ex_id,
                                    num_output_partitions=int(ex.partitioning.num_partitions),
                                    input_exchange_ids=child_inputs))
            inputs.append(ex_id)
            return pb.PhysicalPlanNode(ipc_reader=pb.IpcReaderNode(
                schema=_plan_schema(child), resource_id=ex_id))
        return rewrite_children(node, lambda c: rewrite(c, inputs))

    final_inputs: list[str] = []
    final = rewrite(plan, final_inputs)
    stages.append(StageSpec(stage_id=len(stages), plan=final, exchange_id=None,
                            num_output_partitions=None, input_exchange_ids=final_inputs))
    return stages


def _plan_schema(node):
    """Output schema of a plan subtree (instantiates operators, runs none)."""
    from auron_tpu_torch.plan.planner import plan_from_proto, schema_to_proto

    return schema_to_proto(plan_from_proto(node).schema)


def stage_task(spec: StageSpec, partition: int, work_dir: str, conf: dict | None = None):
    """One task of a stage: the stage plan cloned, this task's shuffle output
    paths filled (the host owns file placement), stage and partition ids
    stamped."""
    plan = pb.PhysicalPlanNode()
    plan.CopyFrom(spec.plan)
    _fill_paths(plan, partition, work_dir)
    t = pb.TaskDefinition(plan=plan, stage_id=spec.stage_id, partition_id=partition)
    for k, v in (conf or {}).items():
        t.conf[k] = str(v)
    return t


def _fill_paths(node, partition: int, work_dir: str) -> None:
    if node.WhichOneof("plan") == "shuffle_writer":
        inner = node.shuffle_writer
        inner.output_data_file = inner.output_data_file.format(work_dir=work_dir,
                                                               partition=partition)
        inner.output_index_file = inner.output_index_file.format(work_dir=work_dir,
                                                                 partition=partition)
    for c in child_nodes(node):
        _fill_paths(c, partition, work_dir)


# ---------------------------------------------------------------------------
# the shuffle-manager contract (the host's MapStatus commit and fetch)
# ---------------------------------------------------------------------------


class ShuffleManager:
    """Committed map outputs per exchange, served to reduce tasks as block
    providers (in-process hosts) or JSON manifests (over the C ABI)."""

    def __init__(self):
        self._outputs: dict[str, dict[int, tuple[str, str]]] = {}

    def register_map_output(self, exchange_id: str, map_partition: int, data_file: str,
                            index_file: str) -> None:
        """A map task's shuffle files become visible."""
        self._outputs.setdefault(exchange_id, {})[map_partition] = (data_file, index_file)

    def map_outputs(self, exchange_id: str) -> list[tuple[str, str]]:
        by_part = self._outputs.get(exchange_id, {})
        return [by_part[p] for p in sorted(by_part)]

    def block_provider(self, exchange_id: str):
        from auron_tpu_torch.exec.shuffle.reader import MultiMapBlockProvider

        return MultiMapBlockProvider(self.map_outputs(exchange_id))

    def manifest(self, exchange_id: str) -> bytes:
        """The exchange's map outputs as a JSON manifest
        ``[{"data": path, "index": path}, ...]``."""
        return json.dumps([{"data": d, "index": i}
                           for d, i in self.map_outputs(exchange_id)]).encode()


def provider_from_manifest(payload: bytes | str):
    """A reduce-side block provider over a JSON manifest's map outputs."""
    from auron_tpu_torch.exec.shuffle.reader import MultiMapBlockProvider

    pairs = [(e["data"], e["index"]) for e in json.loads(payload)]
    for d, i in pairs:
        if not (os.path.exists(d) and os.path.exists(i)):
            raise FileNotFoundError(f"missing shuffle files {d} / {i}")
    return MultiMapBlockProvider(pairs)
