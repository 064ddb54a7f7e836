"""Sort-merge join exec (port of ``auron_tpu/exec/joins/smj.py:22-58``).

The right side is collected and prepared as the build (a key-clustered
sorted map, or a dense table, ``core.prepare_build``); the left side
streams through the driver's batched binary-search probes with ragged pair
expansion. Input order does not matter to it, which is why the planner may
drop the SortExec children (``plan/optimizer.elide_smj_input_sorts``).
Join types are the driver's: inner, left, left_semi, left_anti, each with
an optional residual condition. The probe
runs eager, as in the port's broadcast hash join (predicted compaction is a
later slice); the JAX package's ``finish`` step emits only build-side
completions (right/full outer rows, build-side marks), which this slice
refuses when the driver is built.
"""

from __future__ import annotations

from typing import Iterator

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.device import resolve_device
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.joins.driver import EquiJoinDriver
from auron_tpu_torch.exprs import ir


class SortMergeJoinExec(ExecOperator):
    def __init__(self, left: ExecOperator, right: ExecOperator, left_keys: list[ir.Expr],
                 right_keys: list[ir.Expr], join_type: str, condition: ir.Expr | None = None,
                 projection: list[int] | None = None):
        self.driver = EquiJoinDriver(left.schema, right.schema, left_keys, right_keys,
                                     join_type, "right", condition, projection)
        super().__init__([left, right], self.driver.out_schema)

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        with ctx.metrics.timer("build_time"):
            batches = list(self.child_stream(1, partition, ctx))
            device = batches[0].torch_device if batches else resolve_device(ctx.device)
            build = self.driver.prepare(batches, device)
        for pb in self.child_stream(0, partition, ctx):
            ctx.check_cancelled()
            with ctx.metrics.timer("probe_time", count=True):
                yield from self.driver.probe_batch(build, pb, ctx.conf)
