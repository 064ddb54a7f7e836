"""Scans (port of ``auron_tpu/exec/scan.py``): ``FFIReaderExec`` only.

``FFIReaderExec`` pulls host-exported Arrow batches from the task's
resource map (reference ``scan.py:523-543``): the per-partition key
``<rid>.<partition>`` first (what a host executor registers when several
tasks of one stage share the process), then the shared ``<rid>``; a
callable exporter is called with the partition; an imported C stream
(``bridge/api.put_resource_c_stream``) is one-shot; ``Batch`` items pass
through (on the task's device: a ``cuda`` task handed a CPU batch raises);
empty batches are skipped and cancellation is checked per batch. Host
batches (``columnar/arrow_c.HostBatch``, or any object with Arrow's
``_export_to_c``, taken through the C data interface) ingest onto the
task's device (``Batch.from_host_arrow``).

The Parquet and ORC scans are not ported: the reference reads files with
pyarrow, which the machine with the card does not have (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

from typing import Iterator

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar import arrow_c
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.device import resolve_device
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext


class FFIReaderExec(ExecOperator):
    """Pulls host-exported Arrow batches from the resource map."""

    def __init__(self, schema: T.Schema, resource_id: str):
        super().__init__([], schema)
        self.resource_id = resource_id

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        exporter = ctx.resources.get(f"{self.resource_id}.{partition}")
        if exporter is None:
            exporter = ctx.resources[self.resource_id]
        stream = exporter(partition) if callable(exporter) else exporter
        dev = resolve_device(ctx.device)
        for item in stream:
            ctx.check_cancelled()
            if isinstance(item, Batch):
                if item.torch_device.type != dev.type:
                    raise RuntimeError(
                        f"ffi_reader {self.resource_id!r} of a {dev.type} task yielded a "
                        f"batch on {item.torch_device}")
                yield item
                continue
            if not isinstance(item, arrow_c.HostBatch):
                item = arrow_c.import_from(item)
            if item.length:
                with ctx.metrics.timer("ingest_time"):
                    b = Batch.from_host_arrow(item, device=dev, conf=ctx.conf)
                yield b
