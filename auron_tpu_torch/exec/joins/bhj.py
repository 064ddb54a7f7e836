"""Broadcast hash join exec (port of ``auron_tpu/exec/joins/bhj.py``,
inner joins, and left, left-semi and left-anti joins with the build on the
right, each with an optional residual condition): the build child becomes
a prepared key map, optionally cached in
the executor-shared resource map under ``cached_build_id`` so tasks
probing the same broadcast reuse one build. While it probes, the build
stays registered with the memory manager as an unspillable consumer
(``_BuildMemGuard``, reference ``bhj.py:35-55``), so its bytes shrink the
pool the spillable consumers share."""

from __future__ import annotations

import threading
from typing import Iterator

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.joins.core import PreparedBuild
from auron_tpu_torch.exec.joins.driver import EquiJoinDriver
from auron_tpu_torch.exec.sort_exec import batch_nbytes
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.memory import memmgr

_build_lock = threading.Lock()


class _BuildMemGuard:
    """Accounting-only consumer pinning a join build's footprint for the
    probe's duration: ``spill()`` frees nothing (the probe needs the build)."""

    def __init__(self, ex, build: PreparedBuild):
        self.name = f"join-build-{id(ex):x}"
        self._bytes = batch_nbytes(build.batch) + sum(
            w.numel() * w.element_size() for w in build.words)

    def mem_used(self) -> int:
        return self._bytes

    def spill(self) -> int:
        return 0


class BroadcastHashJoinExec(ExecOperator):
    def __init__(self, left: ExecOperator, right: ExecOperator, left_keys: list[ir.Expr],
                 right_keys: list[ir.Expr], join_type: str, build_side: str = "right",
                 condition: ir.Expr | None = None, cached_build_id: str | None = None,
                 projection: list[int] | None = None):
        self.driver = EquiJoinDriver(left.schema, right.schema, left_keys, right_keys,
                                     join_type, build_side, condition, projection)
        self.build_side = build_side
        self.cached_build_id = cached_build_id
        super().__init__([left, right], self.driver.out_schema)

    def _build(self, partition: int, ctx: ExecutionContext, device) -> PreparedBuild:
        build_child = 0 if self.build_side == "left" else 1
        key = self.cached_build_id
        store = ctx.shared if ctx.shared is not None else ctx.resources
        if key is not None:
            with _build_lock:
                cached = store.get(key)
            if cached is not None:
                return cached
        with ctx.metrics.timer("build_hash_map_time"):
            batches = list(self.child_stream(build_child, partition, ctx))
            built = self.driver.prepare(batches, device)
        if key is not None:
            with _build_lock:
                store.setdefault(key, built)
        return built

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        probe_child = 1 if self.build_side == "left" else 0
        build = guard = mm = None
        try:
            for pb in self.child_stream(probe_child, partition, ctx):
                ctx.check_cancelled()
                if build is None:
                    # the build side runs on the probe batches' device
                    build = self._build(partition, ctx, pb.torch_device)
                    guard = _BuildMemGuard(self, build)
                    mm = memmgr.register(ctx, guard, spillable=False)
                with ctx.metrics.timer("probe_time", count=True):
                    yield from self.driver.probe_batch(build, pb, ctx.conf)
        finally:
            if guard is not None:
                mm.unregister(guard)
