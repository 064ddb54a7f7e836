"""Sort-merge join exec (port of ``auron_tpu/exec/joins/smj.py:22-58``).

The right side is collected and prepared as the build (a key-clustered
sorted map, or a dense table, ``core.prepare_build``); the left side
streams through the driver's batched binary-search probes with ragged pair
expansion. Input order does not matter to it, which is why the planner may
drop the SortExec children (``plan/optimizer.elide_smj_input_sorts``).
Every join type of the driver runs here, each with an optional residual
condition: one ``UniqueProbePipeline`` for the probe stream (predicted,
sync-free compaction of a unique build's output), then ``finish_probe``,
then ``finish(build)`` for the build-side completions (right/full outer
rows, build-side marks; reference ``smj.py:40-57``). The device state
the probe's transfer window holds is registered with the memory manager
as an unspillable consumer while it probes.
"""

from __future__ import annotations

from typing import Iterator

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.device import resolve_device
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.joins.driver import EquiJoinDriver, UniqueProbePipeline
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.memory import memmgr
from auron_tpu_torch.runtime.transfer import WindowGuard


class SortMergeJoinExec(ExecOperator):
    def __init__(self, left: ExecOperator, right: ExecOperator, left_keys: list[ir.Expr],
                 right_keys: list[ir.Expr], join_type: str, condition: ir.Expr | None = None,
                 exists_col: str = "exists", projection: list[int] | None = None):
        self.driver = EquiJoinDriver(left.schema, right.schema, left_keys, right_keys,
                                     join_type, "right", condition, exists_col, projection)
        super().__init__([left, right], self.driver.out_schema)

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        with ctx.metrics.timer("build_time"):
            batches = list(self.child_stream(1, partition, ctx))
            device = None if batches else resolve_device(ctx.device)
            build = self.driver.prepare(batches, device)
        pipe = UniqueProbePipeline(ctx.conf, ctx.metrics)
        guard = WindowGuard(f"smj-window-{id(self):x}", pipe.window)
        mm = memmgr.register(ctx, guard, spillable=False)
        try:
            for pb in self.child_stream(0, partition, ctx):
                ctx.check_cancelled()
                with ctx.metrics.timer("probe_time", count=True):
                    yield from self.driver.probe_batch(build, pb, ctx.conf, pipe)
            with ctx.metrics.timer("probe_time"):
                yield from self.driver.finish_probe(pipe)
            yield from self.driver.finish(build)
        finally:
            pipe.close()
            mm.unregister(guard)
