"""External sort + TakeOrdered (port of ``auron_tpu/exec/sort_exec.py``).

Input batches accumulate on the device as the pending run. Sort keys
encode into orderable uint64 words (ops/sortkeys.py) behind a leading
liveness word (dead rows last) and an int32 iota payload;
``bitonic.ordered_sort`` sorts the operand tuple — on a CUDA tensor,
through the hand-written bitonic kernels when ``exec.device.sort.impl``
resolves to them — and the payload permutes every column. ``fetch``
(TakeOrdered) keeps the first N rows.

Spill, as in the JAX package: the sorter registers with the memory
manager and ``acquire``s each batch's bytes, so memory pressure spills its
pending run; so does ``spill_threshold_rows`` (2^23 pending live rows). A
spill sorts the pending run and parks its live rows and key words in host
RAM. At the end the runs merge on the device — where the JAX package
merges on the host (a native loser tree or a stable ``np.lexsort``; the
port has no host sort, ROADMAP): each run's key words go back to the card
with a last, unique word, the row's global position (run base + row), and
the runs merge pairwise by ``bitonic.merge_runs`` (K4 on a CUDA tensor),
which keeps the reference's stable order: by key, then run, then row. The
columns then gather by the merged positions. Dictionary-encoded sort keys
rank per run, so with them every run comes back to the card and the whole
input re-sorts at once (the JAX package's branch).
"""

from __future__ import annotations

import threading
from typing import Iterator

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import (
    Batch, DeviceBatch, bucket_capacity, device_concat, device_take, prefix_slice,
)
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import Evaluator
from auron_tpu_torch.memory import memmgr
from auron_tpu_torch.ops import bitonic
from auron_tpu_torch.ops.sortkeys import SortSpec, narrow_flags, sort_operands


class SortExec(ExecOperator):
    def __init__(self, child: ExecOperator, sort_exprs: list[ir.Expr], specs: list[SortSpec],
                 fetch: int | None = None, spill_threshold_rows: int = 1 << 23):
        super().__init__([child], child.schema)
        self.sort_exprs = sort_exprs
        self.specs = specs
        self.fetch = fetch
        self.spill_threshold_rows = spill_threshold_rows
        # per-run dictionary ranks are not comparable across runs, so
        # dictionary-encoded sort keys force a global re-sort at merge time
        self._dict_keys = any(e.dtype_of(child.schema).is_dict_encoded for e in sort_exprs)

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        sorter = _SorterConsumer(self, ctx)
        mm = memmgr.register(ctx, sorter)
        try:
            for b in self.child_stream(0, partition, ctx):
                ctx.check_cancelled()
                n = b.num_rows()
                if n == 0:
                    continue
                mm.acquire(sorter, batch_nbytes(b))
                sorter.add(b, n)
                if sorter.pending_rows >= self.spill_threshold_rows:
                    sorter.spill()
        finally:
            mm.unregister(sorter)
        pending, runs = sorter.take()
        if not runs:
            if pending:
                yield from self._emit(self._sort_run(pending, ctx).batch, ctx)
            return
        device = runs[0].device
        if self._dict_keys:
            batches = pending + [_run_to_batch(r, self.schema) for r in runs]
            with ctx.metrics.timer("merge_time"):
                merged = self._sort_run(batches, ctx).batch
            yield from self._emit(merged, ctx)
            return
        if pending:
            runs.append(self._sort_run(pending, ctx).to_host())
        with ctx.metrics.timer("merge_time"):
            merged = _merge_runs(runs, self.schema, len(self.specs), device)
        yield from self._emit(merged, ctx)

    # ------------------------------------------------------------------

    def _sort_run(self, batches: list[Batch], ctx: ExecutionContext) -> "_SortedRun":
        big = device_concat(batches)
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
        n = big.num_rows()
        new_cap = bucket_capacity(max(n, 1))
        out = device_take(big.device, order[:new_cap])
        return _SortedRun(Batch(self.schema, out, big.dicts),
                          tuple(w[:new_cap] for w in sorted_ops[1:-1]), n)

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


def batch_nbytes(b: Batch) -> int:
    """Device-memory estimate of a batch (values + validity + sel)."""
    total = b.capacity  # sel bool
    for v in b.device.values:
        total += v.numel() * v.element_size()
    for m in b.device.validity:
        total += m.numel()
    return total


class _SorterConsumer:
    """MemConsumer over the sorter's pending batches on the device and its
    runs parked in host RAM. The manager may spill it from another task's
    thread; the lock order is manager, then this lock."""

    def __init__(self, exec_: SortExec, ctx: ExecutionContext):
        self.name = f"sort-{id(exec_):x}"
        self.exec = exec_
        self.ctx = ctx
        self.pending: list[Batch] = []
        self.runs: list[_HostRun] = []
        self.pending_rows = 0
        self._bytes = 0
        self._lock = threading.RLock()

    def add(self, b: Batch, n: int) -> None:
        with self._lock:
            self.pending.append(b)
            self.pending_rows += n
            self._bytes += batch_nbytes(b)

    def mem_used(self) -> int:
        with self._lock:
            return self._bytes

    def spill(self) -> int:
        with self._lock:
            if not self.pending:
                return 0
            freed = self._bytes
            with self.ctx.metrics.timer("spill_time"):
                self.runs.append(self.exec._sort_run(self.pending, self.ctx).to_host())
            self.ctx.metrics.add("spilled_runs", 1)
            self.pending, self.pending_rows, self._bytes = [], 0, 0
            return freed

    def take(self) -> tuple[list[Batch], list["_HostRun"]]:
        """Hand the pending batches and the parked runs to the output side."""
        with self._lock:
            out = self.pending, self.runs
            self.pending, self.runs, self.pending_rows, self._bytes = [], [], 0, 0
            return out

    def release(self) -> None:
        self.take()


class _SortedRun:
    def __init__(self, batch: Batch, key_words: tuple, n: int):
        self.batch = batch
        self.key_words = key_words
        self.n = n

    def to_host(self) -> "_HostRun":
        """The run's live rows (a prefix: the liveness word sorts them
        first) and key words, copied to host RAM."""
        dev, n = self.batch.device, self.n
        return _HostRun(
            values=[v[:n].cpu().numpy() for v in dev.values],
            validity=[m[:n].cpu().numpy() for m in dev.validity],
            key_words=[w[:n].cpu().numpy() for w in self.key_words],
            dicts=self.batch.dicts, n=n, device=self.batch.torch_device,
        )


class _HostRun:
    """A sorted run parked in host RAM (the device -> host spill tier)."""

    def __init__(self, values, validity, key_words, dicts, n: int, device: torch.device):
        self.values = values
        self.validity = validity
        self.key_words = key_words
        self.dicts = dicts
        self.n = n
        self.device = device


def _run_to_batch(r: _HostRun, schema: T.Schema) -> Batch:
    """Rehydrate a host-parked run on its device: exactly ``n`` live slots."""
    dev = r.device
    return Batch(schema, DeviceBatch(
        torch.ones(r.n, dtype=torch.bool, device=dev),
        tuple(torch.from_numpy(v).to(dev) for v in r.values),
        tuple(torch.from_numpy(m).to(dev) for m in r.validity),
    ), r.dicts)


def _merge_runs(runs: list[_HostRun], schema: T.Schema, n_keys: int,
                device: torch.device) -> Batch:
    """Merge sorted host runs on the device in the reference's stable
    order (key, run, row): their key words plus each row's global position
    merge pairwise through ``bitonic.merge_runs``; every column gathers by
    the merged positions from the runs' concatenation."""
    bases = np.cumsum([0] + [r.n for r in runs])
    n_words = len(runs[0].key_words)
    operands = [
        (*(torch.from_numpy(w).to(device) for w in r.key_words),
         torch.arange(int(base), int(base) + r.n, dtype=torch.int32, device=device))
        for r, base in zip(runs, bases)
    ]
    merged = bitonic.merge_runs(operands, narrow=(*narrow_flags(n_keys), False),
                                kinds=("u64",) * n_words + ("u32",))
    total = int(bases[-1])
    cap = bucket_capacity(max(total, 1))
    big = device_concat([_run_to_batch(r, schema) for r in runs])  # live rows [0, total)
    pos = torch.zeros(cap, dtype=torch.int64, device=device)
    pos[:total] = merged[-1].long()
    out = device_take(big.device, pos)
    sel = torch.arange(cap, device=device) < total
    return Batch(schema, DeviceBatch(sel, out.values, tuple(m & sel for m in out.validity)),
                 big.dicts)
