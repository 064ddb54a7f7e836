"""Stateless streaming operators (port of ``auron_tpu/exec/basic.py``):
memory scan, project, filter, limit, union, expand, rename, empty
partitions, coalesce and debug. A filter refines the selection mask
instead of compacting; a limit trims with a prefix mask; an expand emits
one projected batch per projection per input batch (ROLLUP/CUBE)."""

from __future__ import annotations

from typing import Iterator, Sequence

import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch, DeviceBatch
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext, coalesce_stream
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import ColumnVal, Evaluator
from auron_tpu_torch.utils.config import FILTER_FUSE


def _uses_row_offset(e: ir.Expr) -> bool:
    if isinstance(e, (ir.RowNum, ir.MonotonicId)):
        return True
    return any(_uses_row_offset(c) for c in e.children())


def _evaluator(schema: T.Schema, ctx: ExecutionContext) -> Evaluator:
    return Evaluator(schema, partition_id=ctx.partition_id, resources=ctx.resources)


def _stream_with_offset(ev: Evaluator, exprs, stream) -> Iterator[Batch]:
    """``stream`` as it is; after each batch ``ev.row_offset`` advances by
    its live rows when an expression reads the offset (a host read per
    batch, paid only then)."""
    track = any(_uses_row_offset(e) for e in exprs)
    for b in stream:
        yield b
        if track:
            ev.row_offset += b.num_rows()


def batch_from_columns(vals: Sequence[ColumnVal], names: Sequence[str],
                       sel: torch.Tensor) -> Batch:
    fields = tuple(
        T.Field(n, v.dtype if v.dtype.kind != T.TypeKind.NULL else T.INT32, True)
        for n, v in zip(names, vals)
    )
    dev = DeviceBatch(sel, tuple(v.values for v in vals), tuple(v.validity for v in vals))
    return Batch(T.Schema(fields), dev, tuple(v.dict for v in vals))


class MemoryScanExec(ExecOperator):
    """In-memory batch source: partitions[p] is partition p's batch list."""

    def __init__(self, partitions: list[list[Batch]], schema: T.Schema):
        super().__init__([], schema)
        self.partitions = partitions

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        yield from self.partitions[partition]


class ResourceScanExec(ExecOperator):
    """memory_scan plan node: batches handed in through the task resource
    map, as ``rid.<partition>`` or a per-partition-indexed ``rid`` entry."""

    def __init__(self, schema: T.Schema, resource_id: str):
        super().__init__([], schema)
        self.resource_id = resource_id

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        parts = ctx.resources.get(f"{self.resource_id}.{partition}")
        if parts is None:
            source = ctx.resources[self.resource_id]
            if callable(source):
                parts = source(partition)
            elif isinstance(source, dict):
                parts = source[partition]
            else:
                parts = source[partition]
        yield from parts


class ProjectExec(ExecOperator):
    def __init__(self, child: ExecOperator, exprs: list[ir.Expr], names: list[str]):
        self.exprs = exprs
        self.names = names
        out = [T.Field(n, e.dtype_of(child.schema), True) for e, n in zip(exprs, names)]
        super().__init__([child], T.Schema(tuple(out)))

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        ev = _evaluator(self.children[0].schema, ctx)
        for b in _stream_with_offset(ev, self.exprs, self.child_stream(0, partition, ctx)):
            with ctx.metrics.timer("elapsed_compute"):
                vals = ev.evaluate(b, self.exprs)
                out = batch_from_columns(vals, self.names, b.device.sel)
            yield out


class FilterExec(ExecOperator):
    """Refines ``sel`` by its predicates. With ``exec.filter.fuse`` (on by
    default) a capture-safe predicate chain runs as one program per
    (schema, predicates, capacity bucket) (``plan/fusion.filter_sel``: a
    CUDA graph replayed per batch on the card), for filters outside a fused
    segment."""

    def __init__(self, child: ExecOperator, predicates: list[ir.Expr]):
        from auron_tpu_torch.plan.fusion import expr_capture_safe

        super().__init__([child], child.schema)
        self.predicates = predicates
        self._fusable = all(expr_capture_safe(p, child.schema) for p in predicates)

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        from auron_tpu_torch.plan.fusion import filter_sel

        # as in the reference, a filter keeps row_offset at 0 (no host read
        # per batch): only ProjectExec numbers rows across batches
        schema = self.children[0].schema
        ev = _evaluator(schema, ctx)
        fuse = self._fusable and ctx.conf.get(FILTER_FUSE)
        preds = tuple(self.predicates)
        reads = tuple(sorted({c.index for p in preds for c in ir.walk(p)
                              if isinstance(c, ir.Column)}))
        for b in self.child_stream(0, partition, ctx):
            with ctx.metrics.timer("elapsed_compute"):
                if fuse:
                    sel = filter_sel(b, schema, preds, reads, ctx.metrics)
                else:
                    sel = b.device.sel
                    for cv in ev.evaluate(b, self.predicates):
                        sel = sel & cv.validity & cv.values.to(torch.bool)
                yield b.with_device(DeviceBatch(sel, b.device.values, b.device.validity))


class LimitExec(ExecOperator):
    """First `limit` live rows of the partition stream."""

    def __init__(self, child: ExecOperator, limit: int):
        super().__init__([child], child.schema)
        self.limit = limit

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        remaining = self.limit
        for b in self.child_stream(0, partition, ctx):
            if remaining <= 0:
                break
            n = b.num_rows()
            if n <= remaining:
                remaining -= n
                yield b
            else:
                sel = b.device.sel
                keep = sel & (torch.cumsum(sel.to(torch.int64), 0) <= remaining)
                remaining = 0
                yield b.with_device(DeviceBatch(keep, b.device.values, b.device.validity))


class UnionExec(ExecOperator):
    """UNION ALL: partition p streams partition p of every child in turn."""

    def __init__(self, children: list[ExecOperator]):
        assert children
        super().__init__(children, children[0].schema)

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        for i in range(len(self.children)):
            yield from self.child_stream(i, partition, ctx)


class ExpandExec(ExecOperator):
    """One batch per projection per input batch (ROLLUP/CUBE grouping sets)."""

    def __init__(self, child: ExecOperator, projections: list[list[ir.Expr]], names: list[str]):
        self.projections = projections
        self.names = names
        out = tuple(T.Field(n, e.dtype_of(child.schema), True)
                    for n, e in zip(names, projections[0]))
        super().__init__([child], T.Schema(out))

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        ev = _evaluator(self.children[0].schema, ctx)
        for b in self.child_stream(0, partition, ctx):
            for proj in self.projections:
                with ctx.metrics.timer("elapsed_compute"):
                    out = batch_from_columns(ev.evaluate(b, proj), self.names, b.device.sel)
                yield out


class RenameColumnsExec(ExecOperator):
    def __init__(self, child: ExecOperator, names: list[str]):
        super().__init__([child], child.schema.rename(names))

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        for b in self.child_stream(0, partition, ctx):
            yield Batch(self.schema, b.device, b.dicts)


class EmptyPartitionsExec(ExecOperator):
    def __init__(self, schema: T.Schema, num_partitions: int):
        super().__init__([], schema)
        self.num_partitions = num_partitions

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        return iter(())


class CoalesceBatchesExec(ExecOperator):
    """Small batches merged toward ``target_rows`` live rows (the task's
    batch size by default)."""

    def __init__(self, child: ExecOperator, target_rows: int | None = None):
        super().__init__([child], child.schema)
        self.target_rows = target_rows

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        yield from coalesce_stream(self.child_stream(0, partition, ctx),
                                   self.target_rows or ctx.batch_size())


class DebugExec(ExecOperator):
    """Logs each batch flowing through (partition, index, rows, capacity)."""

    def __init__(self, child: ExecOperator, tag: str = "debug"):
        super().__init__([child], child.schema)
        self.tag = tag

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        import logging

        log = logging.getLogger("auron_tpu_torch")
        for i, b in enumerate(self.child_stream(0, partition, ctx)):
            log.info("[%s] partition=%d batch=%d rows=%d cap=%d", self.tag, partition, i,
                     b.num_rows(), b.capacity)
            yield b
