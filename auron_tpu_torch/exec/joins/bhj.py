"""Broadcast hash join exec (port of ``auron_tpu/exec/joins/bhj.py``, every
join type with the build on either side, each with an optional residual
condition): the build child becomes a prepared key map, optionally cached
in the executor-shared resource map under ``cached_build_id`` so tasks
probing the same broadcast reuse one build (each task gets its own
build-row marks). The build is prepared before the probe loop, so a
build-outer or build-marking join whose probe stream is empty still emits
its build rows. While it probes, the build stays registered with the
memory manager as an unspillable consumer (``_BuildMemGuard``, reference
``bhj.py:35-55``), together with the device state the probe's transfer
window holds, so their bytes shrink the pool the spillable consumers share.

A stack of two or more inner joins over unique builds runs as one fused
chain (``chain.try_fused_chain``); other shapes run one operator at a time
through a ``UniqueProbePipeline``, then ``finish_probe``, then
``finish(build)`` (reference ``bhj.py:132-181``)."""

from __future__ import annotations

import threading
from typing import Iterator

import torch

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.device import resolve_device
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.joins.core import PreparedBuild
from auron_tpu_torch.exec.joins.driver import EquiJoinDriver, UniqueProbePipeline
from auron_tpu_torch.exec.sort_exec import batch_nbytes
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.memory import memmgr
from auron_tpu_torch.runtime.transfer import WindowGuard

_build_lock = threading.Lock()


class _BuildMemGuard(WindowGuard):
    """Accounting-only consumer pinning a join build's footprint, and the
    device state its probe's transfer window holds, for the probe's
    duration: ``spill()`` frees nothing (the probe needs them)."""

    def __init__(self, ex, builds: list[PreparedBuild], windows=()):
        super().__init__(f"join-build-{id(ex):x}", *windows)
        self._bytes = sum(batch_nbytes(b.batch) + sum(w.numel() * w.element_size()
                                                      for w in b.words) for b in builds)

    def mem_used(self) -> int:
        return self._bytes + super().mem_used()


class BroadcastHashJoinExec(ExecOperator):
    def __init__(self, left: ExecOperator, right: ExecOperator, left_keys: list[ir.Expr],
                 right_keys: list[ir.Expr], join_type: str, build_side: str = "right",
                 condition: ir.Expr | None = None, cached_build_id: str | None = None,
                 exists_col: str = "exists", projection: list[int] | None = None):
        self.driver = EquiJoinDriver(left.schema, right.schema, left_keys, right_keys,
                                     join_type, build_side, condition, exists_col, projection)
        self.build_side = build_side
        self.cached_build_id = cached_build_id
        super().__init__([left, right], self.driver.out_schema)

    def _build(self, partition: int, ctx: ExecutionContext) -> PreparedBuild:
        memo = ctx.resources.pop(("fusion_build_memo", id(self), partition), None)
        if memo is not None:
            return memo  # prepared during a fused-chain attempt that fell back
        build_child = 0 if self.build_side == "left" else 1
        key = self.cached_build_id
        store = ctx.shared if ctx.shared is not None else ctx.resources
        if key is not None:
            with _build_lock:
                cached = store.get(key)
            if cached is not None:
                return self.driver.fresh(cached)
        with ctx.metrics.timer("build_hash_map_time"):
            batches = list(self.child_stream(build_child, partition, ctx))
            device = None if batches else resolve_device(ctx.device)
            built = self.driver.prepare(batches, device)
        if key is not None:
            if device is None and batches and batches[0].torch_device.type == "cuda":
                # tasks on other streams probe the shared build: it is
                # complete before it is published
                torch.cuda.current_stream(batches[0].torch_device).synchronize()
            with _build_lock:
                built = store.setdefault(key, built)
            built = self.driver.fresh(built)
        return built

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        from auron_tpu_torch.exec.joins.chain import clear_chain_memos, try_fused_chain

        guard = mm = pipe = None
        try:
            fused = try_fused_chain(self, partition, ctx)
            if fused is not None:
                yield from fused
                return
            build = self._build(partition, ctx)
            pipe = UniqueProbePipeline(ctx.conf, ctx.metrics)
            guard = _BuildMemGuard(self, [build], (pipe.window,))
            mm = memmgr.register(ctx, guard, spillable=False)
            # a fused probe stage (plan/fusion.py) below carries our link:
            # publishing the prepared build arms its probe prologue
            link = getattr(self, "_probe_prep_link", None)
            if link is not None:
                self.driver.publish_probe_prep(link, build, pipe, ctx.conf)
            probe_child = 1 if self.build_side == "left" else 0
            for pb in self.child_stream(probe_child, partition, ctx):
                ctx.check_cancelled()
                with ctx.metrics.timer("probe_time", count=True):
                    yield from self.driver.probe_batch(build, pb, ctx.conf, pipe)
            with ctx.metrics.timer("probe_time"):
                yield from self.driver.finish_probe(pipe)
            yield from self.driver.finish(build)
        finally:
            link = getattr(self, "_probe_prep_link", None)
            if link is not None:
                link.clear()
            if pipe is not None:
                pipe.close()
            if guard is not None:
                mm.unregister(guard)
            # fallback memos scope to this attempt: entries for operators
            # never reached must not outlive the chain top
            clear_chain_memos(self, partition, ctx)
