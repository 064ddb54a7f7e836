"""In-memory sort + TakeOrdered (port of ``auron_tpu/exec/sort_exec.py``
lines 45-176).

Input batches accumulate and concatenate on the device; sort keys encode
into orderable uint64 words (ops/sortkeys.py) behind a leading liveness
word (dead rows last) and an int32 iota payload; ``bitonic.ordered_sort``
sorts the operand tuple — on a CUDA tensor, through the hand-written
bitonic kernels when ``exec.device.sort.impl`` resolves to them — and the
payload permutes every column. ``fetch`` (TakeOrdered) keeps the first N
rows. Spilled runs and their k-way merge wait for a later slice.
"""

from __future__ import annotations

from typing import Iterator

import torch

from auron_tpu_torch.columnar.batch import (
    Batch, DeviceBatch, bucket_capacity, device_concat, device_take, prefix_slice,
)
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import Evaluator
from auron_tpu_torch.ops import bitonic
from auron_tpu_torch.ops.sortkeys import SortSpec, narrow_flags, sort_operands


class SortExec(ExecOperator):
    def __init__(self, child: ExecOperator, sort_exprs: list[ir.Expr], specs: list[SortSpec],
                 fetch: int | None = None):
        super().__init__([child], child.schema)
        self.sort_exprs = sort_exprs
        self.specs = specs
        self.fetch = fetch

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        pending = []
        for b in self.child_stream(0, partition, ctx):
            ctx.check_cancelled()
            pending.append(b)
        if not pending:
            return
        sorted_batch = self._sort_run(pending, ctx)
        if sorted_batch is not None:
            yield from self._emit(sorted_batch, ctx)

    def _sort_run(self, batches: list[Batch], ctx: ExecutionContext) -> Batch | None:
        big = device_concat(batches)
        n = big.num_rows()
        if n == 0:
            return None
        keys = Evaluator(self.schema).evaluate(big, self.sort_exprs)
        ops = sort_operands(keys, self.specs)
        cap = big.capacity
        live = torch.where(big.device.sel, 0, 1).to(torch.int64)
        iota = torch.arange(cap, dtype=torch.int32, device=live.device)
        with ctx.metrics.timer("sort_time"):
            sorted_ops = bitonic.ordered_sort(
                (live, *ops, iota), word_narrow=narrow_flags(len(self.specs)), conf=ctx.conf,
            )
            order = sorted_ops[-1].long()
        new_cap = bucket_capacity(max(n, 1))
        out = device_take(big.device, order[:new_cap])
        return Batch(self.schema, out, big.dicts)

    def _emit(self, sorted_batch: Batch, ctx: ExecutionContext) -> Iterator[Batch]:
        n = sorted_batch.num_rows()
        if self.fetch is not None and self.fetch < n:
            keep = torch.arange(sorted_batch.capacity, device=sorted_batch.torch_device) < self.fetch
            dev = sorted_batch.device
            sorted_batch = sorted_batch.with_device(
                DeviceBatch(dev.sel & keep, dev.values, dev.validity))
            sorted_batch = prefix_slice(sorted_batch, bucket_capacity(max(self.fetch, 1)))
            n = self.fetch
        chunk = bucket_capacity(ctx.batch_size())
        if n <= chunk:
            yield sorted_batch
            return
        dev = sorted_batch.device
        for start in range(0, n, chunk):
            sl = slice(start, start + chunk)
            yield Batch(self.schema, DeviceBatch(dev.sel[sl], tuple(v[sl] for v in dev.values),
                                                 tuple(m[sl] for m in dev.validity)),
                        sorted_batch.dicts)
