"""Sinks (port of ``auron_tpu/exec/sink.py``): ``IpcWriterExec`` only.

``IpcWriterExec`` (reference ``sink.py:193-213``) streams the partition's
non-empty batches as length-prefixed blocks into a host channel registered
in the resource map (list-like with ``.append``, or a callable). A block is
the port's v2 shuffle block (``exec/shuffle/format.encode_block``), which
the JAX package's ``decode_blocks`` reads, as the port's ``decode_block``
reads the JAX package's. ``egress_time`` covers the live rows' copy to the
host and the encode, ``encode_time`` the encode and the push.

The Parquet and ORC sinks are not ported: the reference writes files with
pyarrow, which the machine with the card does not have (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

from typing import Iterator

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.shuffle.format import encode_block, host_planes


class IpcWriterExec(ExecOperator):
    """Streams the partition's batches as length-prefixed blocks into a host
    channel registered in the resource map (list-like with ``.append`` or
    callable)."""

    def __init__(self, child: ExecOperator, resource_id: str):
        super().__init__([child], child.schema)
        self.resource_id = resource_id

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        channel = ctx.resources[self.resource_id]
        push = channel if callable(channel) else channel.append
        for b in self.child_stream(0, partition, ctx):
            ctx.check_cancelled()
            with ctx.metrics.timer("egress_time"):
                nrows, cols = host_planes(b, ctx.metrics)
                if nrows == 0:
                    continue
                with ctx.metrics.timer("encode_time"):
                    push(encode_block(b.schema, cols))
        return
        yield  # pragma: no cover — a generator with no items
