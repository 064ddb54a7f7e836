"""Operator base classes and per-task execution context.

Port of ``auron_tpu/exec/base.py``: operators are host-side generators of
``Batch``es; per-row work runs as torch programs on the batches' device.
``ExecutionContext`` carries the task identity, the resolved configuration,
the operator's metric node, cancellation and the task resource map.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Iterable, Iterator

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch, bucket_capacity, compact_batch, device_concat
from auron_tpu_torch.exec.metrics import MetricNode
from auron_tpu_torch.utils.config import BATCH_SIZE, METRICS_ROW_COUNTS, Configuration, active_conf


class TaskCancelled(Exception):
    pass


@dataclass
class ExecutionContext:
    stage_id: int = 0
    partition_id: int = 0
    conf: Configuration = field(default_factory=lambda: active_conf().copy())
    metrics: MetricNode = field(default_factory=lambda: MetricNode("root"))
    resources: dict = field(default_factory=dict)
    #: executor-shared store (the bridge's live resource map): cached
    #: broadcast builds land here
    shared: dict | None = None
    #: device of the task (operators follow their input batches; this
    #: places outputs that have no input, e.g. a global aggregate of nothing)
    device: str = "cuda"
    _cancelled: threading.Event = field(default_factory=threading.Event)
    #: (manager, consumer) pairs the task's operators registered
    #: (memory/memmgr.py ``register``), shared by every context of a task
    consumers: list = field(default_factory=list)
    consumers_lock: threading.Lock = field(default_factory=threading.Lock)

    def cancel(self) -> None:
        self._cancelled.set()

    def check_cancelled(self) -> None:
        if self._cancelled.is_set():
            raise TaskCancelled(
                f"task stage={self.stage_id} partition={self.partition_id} cancelled"
            )

    def batch_size(self) -> int:
        return self.conf.get(BATCH_SIZE)


class ExecOperator:
    """Base class. Subclasses set ``schema`` and implement ``_execute``."""

    schema: T.Schema
    children: list["ExecOperator"]

    def __init__(self, children: list["ExecOperator"], schema: T.Schema):
        self.children = children
        self.schema = schema

    @property
    def name(self) -> str:
        return type(self).__name__

    def execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        """Stream output batches with per-operator metrics; row counts are
        conf-gated (a device count read per batch)."""
        count_rows = ctx.conf.get(METRICS_ROW_COUNTS)
        rows = None
        try:
            for batch in self._execute(partition, ctx):
                ctx.check_cancelled()
                if count_rows:
                    r = batch.device.num_rows()
                    rows = r if rows is None else rows + r
                ctx.metrics.add("output_batches", 1)
                yield batch
        finally:
            if rows is not None:
                ctx.metrics.add("output_rows", int(rows.item()))

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        raise NotImplementedError

    def child_stream(self, i: int, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        child_ctx = ExecutionContext(
            stage_id=ctx.stage_id,
            partition_id=ctx.partition_id,
            conf=ctx.conf,
            metrics=ctx.metrics.child(i),
            resources=ctx.resources,
            shared=ctx.shared,
            device=ctx.device,
            _cancelled=ctx._cancelled,
            consumers=ctx.consumers,
            consumers_lock=ctx.consumers_lock,
        )
        child_ctx.metrics.name = self.children[i].name
        return self.children[i].execute(partition, child_ctx)

    # -- conveniences for tests and host consumers (reference exec/base.py:133-142) --

    def collect(self, partition: int = 0, ctx: ExecutionContext | None = None) -> Batch:
        """Partition ``partition``'s output as one batch (an empty batch on
        ``ctx.device`` when nothing comes out)."""
        ctx = ctx or ExecutionContext()
        ctx.metrics.name = self.name
        batches = list(self.execute(partition, ctx))
        if not batches:
            return Batch.empty(self.schema, device=ctx.device)
        return device_concat(batches)

    def collect_pydict(self, partition: int = 0, ctx: ExecutionContext | None = None) -> dict:
        """``collect``'s live rows as Python lists."""
        return self.collect(partition, ctx).to_pydict()


def coalesce_stream(stream: Iterable[Batch], target_rows: int) -> Iterator[Batch]:
    """Merge small batches toward ``target_rows`` live rows
    (``auron_tpu/exec/base.py:145``): a batch already that large passes
    through; otherwise batches gather until their live rows reach the
    target and leave as one batch of their live rows, compacted. Empty
    batches are dropped."""
    pending: list[Batch] = []
    pending_rows = 0
    for b in stream:
        n = b.num_rows()
        if n == 0:
            continue
        if n >= target_rows and not pending:
            yield b
            continue
        pending.append(b)
        pending_rows += n
        if pending_rows >= target_rows:
            yield compact_batch(device_concat(pending), bucket_capacity(pending_rows))
            pending, pending_rows = [], 0
    if pending:
        yield compact_batch(device_concat(pending), bucket_capacity(pending_rows))
