"""Hash-aggregate exec: partial / partial-merge / final modes.

Port of ``auron_tpu/exec/agg_exec.py`` for sum / count / count_star / avg /
min / max / first / collect_list / collect_set, with the two grouping
paths the slice runs:

- the DENSE direct-address table (``_DenseAggState``, agg_exec.py:2118;
  the fold of ``_dense_update_jit``, :1959): up to three small-range
  integer keys pack into one slot index (offset 0 of each key is its NULL
  lane) and every batch folds in with scatter reductions, no sort. Ranges
  anchor on the first batch with centred power-of-two headroom; a batch
  outside the table drains it into the generic path and re-anchors on the
  union range; a union beyond ``LIMIT`` slots falls back for good;
- the generic SORT-SEGMENTATION path (``_sort_flags``, :243-273): per
  batch, segment by the key words (fingerprint sort on CUDA tensors,
  full-word sort otherwise — ops/segments.py), reduce to an intermediate
  batch, stage, and merge staged intermediates by the same reduction.

Memory (reference ``agg_exec.py:381-689, 1451-1600``): the generic path's
state is ``_AggTableConsumer``, registered with the memory manager, which
``acquire``s each staged intermediate's bytes; under pressure it merges its
state and parks it as an encoded run in host RAM (demoted to disk when the
host ledger fills), and the end of the stream merges every parked run back
on the device. Partial-agg skipping never engages once a run is parked.
The dense table registers unspillable. Its spills note their spans
through the memory manager and the spill containers (``memory/memmgr.py``).

Host reads (reference ``agg_exec.py:559-660, 2247-2320``): a PARTIAL
generic path defers each batch's (live, group) counts through the transfer
window (``exec.agg.partial.defer``), compacting into the selectivity
predictor's bucket and recomputing a batch whose bucket proved too small;
the dense table checks each batch's key ranges on the device, folds all or
nothing, and harvests the flag ``runtime.transfer.window.depth`` batches
later (a false flag drains, re-anchors and folds the batch again). The
window's and the pending folds' device state stays accounted to the
memory manager.

Spark typing: sum(int*) -> long (wrapping), sum(float*) -> double,
avg -> double, count -> long (never null); sum(decimal(p,s)) ->
decimal(p+10, s), avg(decimal(p,s)) -> decimal(p+4, s+4) (reference
``agg_exec.py:86-100``). A decimal64 sum accumulates in int64 (wrapping,
as the reference's) and the FINAL stage checks its precision (overflow ->
NULL); an avg divides exactly by ``decimal_math.div``. A sum whose type is
wider than 18 digits accumulates as base-1e9 int64 limbs on the device
(``_reduce_wide_sum``; the input precision rides in the ``#sum0p{p}``
field name so that a merge or final stage recovers the input type) and
the FINAL stage rebuilds the exact sums on the host (``_final_wide``; past
38 digits -> NULL). min/max over a dictionary column (strings, wide
decimals) reduce in the vocabulary's rank space. ``first`` and
``first_ignores_null`` keep a ``#value`` and a ``#seen`` lane.
``collect_list`` and ``collect_set`` keep an ``#items`` LIST state: each
group's values as one vocabulary entry (``_reduce_collect``). ``host_udaf``
keeps a ``#state`` BINARY state: each group's accumulator (``bridge/udf.py``
``UdafSpec``) pickled into one vocabulary entry (``_reduce_udaf_state``,
``_final_udaf``; reference ``agg_exec.py:1145-1167, 1251-1263``). As in the
reference, an aggregate with either takes the generic path alone (no dense
table, probe, merge-path or deferred counts), and its state batches spill
like any other.

The incremental path (reference ``agg_exec.py:846-1090, 2810-3147``), on
for CUDA tensors (``exec.agg.incremental.probe`` / ``.mergepath``, auto):
every fingerprint-segmented reduce output carries ``_fp_order`` (its groups
are in fingerprint order), ``_inc_fp`` (each group's fingerprint, dead
slots ``segments.DEAD_FP``) and ``_fp_collision`` (a device flag, read once
into ``_fp_collision_host``). Once a compact() has made such a state,
``_ProbeScatter`` binary-searches every later batch into it and scatters
the hit rows into its accumulators; the miss rows go to the generic path
``depth`` batches later. ``_merge`` merges collision-free fingerprint-sorted
parts pairwise by merge rank (``segments.segment_merged``, no sort), and
re-sorts otherwise; a FINAL merge that saw a collision re-reduces by the
full-word sort. A partial aggregate prefused into a stage
(``plan/fusion.py``) gets its dense fold's planes from the stage program
(``dense_fold_planes``; ``_DenseAggState`` publishes its anchor geometry
as a tensor).
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import (
    Batch, _python_value, bucket_capacity, column_from_pylist, compact_batch, compaction_bucket,
    device_concat, empty_dict, object_array, prefix_slice, vocab_key,
)
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.basic import batch_from_columns
from auron_tpu_torch.exec.selectivity import SelectivityPredictor, predictor_enabled
from auron_tpu_torch.exec.sort_exec import batch_nbytes
from auron_tpu_torch.exprs import decimal_math as D
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import ColumnVal, Evaluator
from auron_tpu_torch.memory import memmgr
from auron_tpu_torch.ops import binsearch, bitonic, hashing
from auron_tpu_torch.ops import segments as S
from auron_tpu_torch.ops.sortkeys import dict_rank_maps
from auron_tpu_torch.runtime.transfer import (
    TransferWindow, WindowGuard, blocking_read, harvest, start_host_transfer,
)
from auron_tpu_torch.utils.config import (
    AGG_INCREMENTAL_ENABLE, AGG_INCREMENTAL_FINGERPRINT, AGG_INCREMENTAL_FP_BITS,
    AGG_INCREMENTAL_MERGEPATH, AGG_INCREMENTAL_PROBE, AGG_PARTIAL_DEFER,
    PARTIAL_AGG_SKIPPING_ENABLE, PARTIAL_AGG_SKIPPING_MIN_ROWS, PARTIAL_AGG_SKIPPING_RATIO,
    TRANSFER_WINDOW_DEPTH, active_conf, resolve_tri,
)

PARTIAL = "partial"
PARTIAL_MERGE = "partial_merge"
FINAL = "final"

#: the aggregates reduced on the host: each group's values become one entry
#: of a LIST vocabulary (reference ``_has_host_aggs``)
_HOST_FUNCS = ("collect_list", "collect_set", "host_udaf")
#: a PARTIAL aggregate with a host aggregate reduces its input batches
#: coalesced up to this many rows (or an eighth of the memory budget): each
#: reduce builds one Python list a group, so a group seen in several batches
#: costs one list instead of one a batch plus a merge
HOST_AGG_COALESCE_ROWS = 1 << 23
_FUNCS = ("sum", "count", "count_star", "avg", "min", "max", "first",
          "first_ignores_null") + _HOST_FUNCS
#: the aggregates the dense table folds
_DENSE_FUNCS = ("sum", "avg", "count", "count_star", "min", "max")


@dataclass(frozen=True)
class AggExpr:
    func: str
    expr: ir.Expr | None = None  # None only for count_star
    udaf: str | None = None


def sum_type(t: T.DataType) -> T.DataType:
    if t.kind == T.TypeKind.DECIMAL:
        return T.decimal(min(t.precision + 10, 38), t.scale)
    if t.is_float:
        return T.FLOAT64
    if t.is_integer:
        return T.INT64
    raise TypeError(f"sum over {t}")


def avg_type(t: T.DataType) -> T.DataType:
    if t.kind == T.TypeKind.DECIMAL:
        return T.decimal(min(t.precision + 4, 38), min(t.scale + 4, 37))
    return T.FLOAT64


def final_type(a: AggExpr, in_t: T.DataType | None) -> T.DataType:
    if a.func in ("count", "count_star"):
        return T.INT64
    if a.func == "sum":
        return sum_type(in_t)
    if a.func == "avg":
        return avg_type(in_t)
    if a.func == "host_udaf":
        from auron_tpu_torch.bridge.udf import lookup_udaf

        return lookup_udaf(a.udaf).out_dtype
    if a.func in _HOST_FUNCS:
        return T.DataType(T.TypeKind.LIST, inner=(in_t,))
    return in_t  # min/max/first


def is_wide_sum(in_t: T.DataType | None) -> bool:
    """A decimal sum wider than 18 digits would wrap int64: it accumulates
    as base-1e9 limbs instead (per-limb sums stay exact)."""
    if in_t is None or in_t.kind != T.TypeKind.DECIMAL:
        return False
    return sum_type(in_t).precision > 18


_LIMB_BASE = 1_000_000_000


def _n_limbs(sum_precision: int) -> int:
    """Base-1e9 limbs covering the sum's digits (<= 5 for p38)."""
    return -(-sum_precision // 9)


def _wide_sum_fields(in_t: T.DataType, prefix: str) -> list[T.Field]:
    """Limb 0 carries the scale and, in its name, the exact input precision,
    so merge and final stages rebuild the layout from the schema alone."""
    k = _n_limbs(sum_type(in_t).precision)
    return ([T.Field(f"{prefix}#sum0p{in_t.precision}", T.decimal(18, in_t.scale), True)]
            + [T.Field(f"{prefix}#sum{i}", T.INT64, True) for i in range(1, k)])


def intermediate_fields(a: AggExpr, in_t: T.DataType | None, prefix: str) -> list[T.Field]:
    if a.func in ("count", "count_star"):
        return [T.Field(f"{prefix}#count", T.INT64, False)]
    if a.func in ("sum", "avg"):
        if is_wide_sum(in_t):
            fields = _wide_sum_fields(in_t, prefix)
        else:
            fields = [T.Field(f"{prefix}#sum", sum_type(in_t), True)]
        if a.func == "avg":
            fields.append(T.Field(f"{prefix}#count", T.INT64, False))
        return fields
    if a.func in ("min", "max"):
        return [T.Field(f"{prefix}#{a.func}", in_t, True)]
    if a.func in ("first", "first_ignores_null"):
        return [T.Field(f"{prefix}#value", in_t, True), T.Field(f"{prefix}#seen", T.BOOL, False)]
    if a.func == "host_udaf":
        # the pickled accumulator of each group: bounded by the state's size
        return [T.Field(f"{prefix}#state", T.BINARY, True)]
    if a.func in _HOST_FUNCS:
        return [T.Field(f"{prefix}#items", T.DataType(T.TypeKind.LIST, inner=(in_t,)), True)]
    raise ValueError(a.func)


def _input_type_from_intermediate(a: AggExpr, first_field: T.Field) -> T.DataType | None:
    t = first_field.dtype
    if a.func in ("count", "count_star", "host_udaf"):
        return None  # a UDAF's state column carries no input type
    if a.func in _HOST_FUNCS:
        return t.inner[0]
    if a.func in ("sum", "avg"):
        if "#sum0p" in first_field.name:
            return T.decimal(int(first_field.name.rsplit("#sum0p", 1)[1]), t.scale)
        if t.kind == T.TypeKind.DECIMAL:
            return T.decimal(max(t.precision - 10, 1), t.scale)
        return T.INT64 if t.kind == T.TypeKind.INT64 else T.FLOAT64
    return t  # min/max/first carry the input type


class HashAggExec(ExecOperator):
    def __init__(self, child: ExecOperator, groupings: list[tuple[ir.Expr, str]],
                 aggs: list[tuple[AggExpr, str]], mode: str):
        assert mode in (PARTIAL, PARTIAL_MERGE, FINAL)
        for a, _ in aggs:
            if a.func not in _FUNCS:
                raise NotImplementedError(f"aggregate {a.func} is not in this slice of the port")
        self.mode = mode
        self.groupings = groupings
        self.aggs = aggs
        in_schema = child.schema
        key_fields = []
        for e, name in groupings:
            if mode == PARTIAL:
                key_fields.append(T.Field(name, e.dtype_of(in_schema), True))
            else:
                key_fields.append(in_schema[len(key_fields)])
        self._agg_input_types: list[T.DataType | None] = []
        inter_fields: list[T.Field] = []
        ofs = len(key_fields)
        for a, name in aggs:
            if mode == PARTIAL:
                in_t = a.expr.dtype_of(in_schema) if a.expr is not None else None
            else:
                in_t = _input_type_from_intermediate(a, in_schema[ofs])
                ofs += len(intermediate_fields(a, in_t or T.INT64, name))
            self._agg_input_types.append(in_t)
            inter_fields += intermediate_fields(a, in_t, name)
        if mode == FINAL:
            out_fields = key_fields + [
                T.Field(name, final_type(a, t), True)
                for (a, name), t in zip(aggs, self._agg_input_types)
            ]
        else:
            out_fields = key_fields + inter_fields
        super().__init__([child], T.Schema(tuple(out_fields)))
        self.n_keys = len(key_fields)
        self.inter_schema = T.Schema(tuple(key_fields + inter_fields))
        self._has_host_aggs = any(a.func in _HOST_FUNCS for a, _ in aggs)

    # ------------------------------------------------------------------
    # policy

    def _sort_flags(self, device, force_full_sort: bool = False, conf=None,
                    cap: int = 0) -> tuple:
        """(device_impl, fingerprint, fp_bits) from config."""
        conf = conf if conf is not None else active_conf()
        fingerprint = not force_full_sort and self.n_keys >= 1 and \
            self._fingerprint_on(conf, device)
        fp_bits = conf.get(AGG_INCREMENTAL_FP_BITS) if fingerprint else 64
        if fingerprint:
            return ("lax", True, fp_bits)
        n_words = self.n_keys + (1 if self.n_keys else 0)
        n_narrow = 1 if 0 < self.n_keys <= 32 else 0
        impl = bitonic.sort_impl_for(n_words, cap, n_narrow, conf=conf, device=device)
        return (impl, False, 64)

    @staticmethod
    def _tri(opt, conf, device) -> bool:
        """An on|off|auto incremental knob: auto = the task's tensors are on
        CUDA (the reference's accelerators-only default). ``conf`` is the
        task's, never ``active_conf()``: a spill can merge this state from
        another task's thread."""
        return resolve_tri(conf.get(opt), torch.device(device).type == "cuda")

    def _fingerprint_on(self, conf, device) -> bool:
        return bool(conf.get(AGG_INCREMENTAL_ENABLE)
                    and self._tri(AGG_INCREMENTAL_FINGERPRINT, conf, device))

    def _keys_dict_free(self) -> bool:
        """No group key is dictionary-encoded: key fingerprints are then
        stable across batches (codes index per-batch vocabularies), the
        precondition for probing the sorted state and for merge-path."""
        return all(not self.inter_schema[i].dtype.is_dict_encoded
                   for i in range(self.n_keys))

    def _mergepath_eligible(self, conf, device) -> bool:
        return (self.n_keys >= 1 and self._keys_dict_free() and not self._has_host_aggs
                and self._fingerprint_on(conf, device)
                and self._tri(AGG_INCREMENTAL_MERGEPATH, conf, device))

    def _probe_eligible(self, conf, device) -> bool:
        """Sorted-state probe/scatter (reference ``agg_exec.py:319-340``):
        every aggregate has a scatter-update form and no column it touches
        is dictionary-encoded (a narrow decimal input with a wide SUM type
        keeps the limb path)."""
        if self.n_keys < 1 or self._has_host_aggs or not self._keys_dict_free():
            return False
        if not (self._fingerprint_on(conf, device)
                and self._tri(AGG_INCREMENTAL_PROBE, conf, device)):
            return False
        return all(a.func in _FUNCS and (in_t is None or not in_t.is_dict_encoded)
                   for (a, _), in_t in zip(self.aggs, self._agg_input_types))

    def _dense_eligible(self) -> bool:
        if not (1 <= self.n_keys <= 3):
            return False
        for i in range(self.n_keys):
            kt = self.inter_schema[i].dtype
            if kt.is_dict_encoded or kt.kind not in (
                T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32, T.TypeKind.INT64,
                T.TypeKind.DATE32, T.TypeKind.TIMESTAMP, T.TypeKind.BOOL,
            ):
                return False
        for (a, _), in_t in zip(self.aggs, self._agg_input_types):
            if a.func not in _DENSE_FUNCS or (a.func in ("sum", "avg") and is_wide_sum(in_t)):
                return False
            if in_t is not None and in_t.is_dict_encoded:
                return False
        return True

    # ------------------------------------------------------------------

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        conf = ctx.conf
        metrics = ctx.metrics
        skipping_enabled = self.mode == PARTIAL and conf.get(PARTIAL_AGG_SKIPPING_ENABLE)
        skip_ratio = conf.get(PARTIAL_AGG_SKIPPING_RATIO)
        skip_min_rows = conf.get(PARTIAL_AGG_SKIPPING_MIN_ROWS)
        merge_threshold = max(ctx.batch_size() * 4, 1 << 15)
        seen_rows = seen_groups = 0
        skipping = False
        table = _AggTableConsumer(self, ctx)
        mm = memmgr.register(ctx, table)
        # the dense table has a fixed footprint: registered unspillable, its
        # bytes shrink the pool the spillable consumers share
        dense = _DenseAggState(self, ctx) if self._dense_eligible() else None
        if dense is not None:
            memmgr.register(ctx, dense, spillable=False)
        # deferred PARTIAL counts (exec.agg.partial.defer, reference
        # agg_exec.py:559-660): the generic path's (live, group) read rides
        # the transfer window, compaction buckets come from the selectivity
        # predictor, and a truncating mispredict recomputes the reduce from
        # the still-held batch
        probe = defer_win = defer_pred = win_guard = None
        coalesce = self.mode == PARTIAL and self._has_host_aggs
        pending: list = []
        pending_rows = pending_bytes = 0

        def flush_pending():
            """Reduce the coalesced raw batches as one (input order kept)."""
            nonlocal pending, pending_rows, pending_bytes
            if pending:
                big = device_concat(pending)
                pending, pending_rows, pending_bytes = [], 0, 0
                yield from feed_generic(big)

        def arm(device):
            """At the first batch, on its device: the sorted-state
            probe/scatter (it engages once a compact() produced a
            fingerprint-sorted state, the dense table out of the picture),
            else the deferred PARTIAL counts. The two exclude each other:
            the probe's direct state folds must not overtake window-pending
            batches (first's stream order)."""
            nonlocal probe, defer_win, defer_pred, win_guard
            if self._probe_eligible(conf, device):
                probe = _ProbeScatter(self, ctx, table)
                memmgr.register(ctx, probe, spillable=False)
            elif (self.mode == PARTIAL and not self._has_host_aggs
                  and resolve_tri(conf.get(AGG_PARTIAL_DEFER), True)):
                defer_win = TransferWindow(conf.get(TRANSFER_WINDOW_DEPTH), metrics)
                defer_pred = SelectivityPredictor(conf) if predictor_enabled(conf) else None
                win_guard = WindowGuard(f"agg-window-{id(self):x}", defer_win)
                memmgr.register(ctx, win_guard, spillable=False)

        def stage(inter: Batch, g: int) -> Iterator[Batch]:
            """Stage one exact-bucket intermediate of ``g`` groups (or pass
            it through once partial skipping engaged)."""
            nonlocal skipping
            if skipping:
                yield inter
                return
            # a parked run holds groups the stream has not seen again:
            # skipping never engages once the table spilled
            if skipping_enabled and seen_rows >= skip_min_rows and \
                    seen_groups >= skip_ratio * seen_rows and not table.parked:
                metrics.add("partial_agg_skipped", 1)
                skipping = True
                yield from table.drain()
                yield inter
                return
            mm.acquire(table, batch_nbytes(inter))
            table.add(inter, g)
            if table.staged_rows >= max(merge_threshold, table.state_capacity()):
                with metrics.timer("merge_time"):
                    table.compact()
                metrics.add("num_merges", 1)

        def process_generic(b):
            """The blocking protocol: the live count, then the group count."""
            nonlocal seen_rows, seen_groups
            metrics.add("generic_batches", 1)
            (n,) = blocking_read(metrics, b.device.num_rows())
            n = int(n)
            if n == 0:
                return
            if self.mode == PARTIAL and 4 * n <= b.capacity:
                b = compact_batch(b, bucket_capacity(n))
            with metrics.timer("elapsed_compute"):
                inter = self._to_intermediate(b, conf)
            (g,) = blocking_read(metrics, inter.device.num_rows())
            g = int(g)
            seen_rows += n
            seen_groups += g
            yield from stage(_prefix_slice_meta(inter, bucket_capacity(max(g, 1))), g)

        def dispatch_deferred(b):
            """Device work only: predicted compaction and the grouped reduce;
            the (live, group) counts ride the window."""
            metrics.add("generic_batches", 1)
            pred_cap = defer_pred.predict(b.capacity) if defer_pred is not None else None
            used_cap = None
            bb = b
            if pred_cap is not None:
                out_cap = compaction_bucket(pred_cap, b.capacity)
                if out_cap is not None:
                    # may drop live rows on a mispredict: resolve_deferred
                    # sees n > used_cap and recomputes from ``b``
                    bb = compact_batch(b, out_cap)
                    used_cap = out_cap
            with metrics.timer("elapsed_compute"):
                inter = self._to_intermediate(bb, conf)
            return ((b.device.num_rows(), inter.device.num_rows()), (b, inter, used_cap),
                    batch_nbytes(b) + batch_nbytes(inter))

        def resolve_deferred(resolved, state):
            """Harvest half, k batches behind the dispatch."""
            nonlocal seen_rows, seen_groups
            b, inter, used_cap = state
            n, g = int(resolved[0]), int(resolved[1])
            if defer_pred is not None:
                defer_pred.observe(n, predicted=used_cap)
            if n == 0:
                return
            if used_cap is not None and n > used_cap:
                metrics.add("sel_mispredicts", 1)
                bb = compact_batch(b, bucket_capacity(n)) if 4 * n <= b.capacity else b
                with metrics.timer("elapsed_compute"):
                    inter = self._to_intermediate(bb, conf)
                (g,) = blocking_read(metrics, inter.device.num_rows())
                g = int(g)
            seen_rows += n
            seen_groups += g
            yield from stage(_prefix_slice_meta(inter, bucket_capacity(max(g, 1))), g)

        def feed_generic(b):
            if defer_win is None:
                yield from process_generic(b)
                return
            arrays, state, nbytes = dispatch_deferred(b)
            for resolved, st in defer_win.push(arrays, state, nbytes):
                yield from resolve_deferred(resolved, st)

        def drain_dense():
            sb = dense.state_batch()
            if sb is not None:
                mm.acquire(table, batch_nbytes(sb))
                table.add(sb, 0)

        def fold_dense(nb, defer: bool = True) -> list | None:
            """Fold one batch through the dense table, driving the drain /
            re-anchor protocol: None when folded (or its fold is in flight),
            else — after the permanent fallback — the batches the generic
            path must take instead."""
            nonlocal dense, skipping_enabled
            todo = [nb]
            while todo:
                cur = todo.pop(0)
                r = dense.update(cur, defer=defer)
                if r == "restart":
                    # ranges outgrew the anchored table: drain it into the
                    # generic state, re-anchor on the failed batches' union
                    drain_dense()
                    todo = dense.reset_with_retry() + [cur] + todo
                elif r is False:
                    # the union range can never fit: generic path from here on
                    drain_dense()
                    left = dense.take_retry() + [cur] + todo
                    mm.unregister(dense)
                    dense.release()
                    dense = None
                    skipping_enabled = False
                    return left
            return None

        try:
            armed = False
            for b in self.child_stream(0, partition, ctx):
                ctx.check_cancelled()
                if not armed:
                    arm(b.torch_device)
                    armed = True
                if dense is not None:
                    with metrics.timer("elapsed_compute", count=True):
                        leftovers = fold_dense(b)
                    if leftovers is None:
                        metrics.add("dense_batches", 1)
                    for gb in leftovers or ():
                        yield from feed_generic(gb)
                    continue
                if coalesce:
                    pending.append(b)
                    pending_rows += b.capacity
                    pending_bytes += batch_nbytes(b)
                    if pending_rows >= HOST_AGG_COALESCE_ROWS or \
                            8 * pending_bytes >= mm.budget:
                        yield from flush_pending()
                    continue
                if probe is not None and not skipping:
                    with metrics.timer("elapsed_compute", count=True):
                        folded, misses, hit_rows = probe.fold(b)
                    # probed hits are rows with no new group: they keep
                    # pulling the skip heuristic's cardinality ratio down
                    seen_rows += hit_rows
                    for mb in misses:
                        yield from process_generic(mb)
                    if folded:
                        metrics.add("probe_batches", 1)
                        continue
                    yield from process_generic(b)
                    continue
                yield from feed_generic(b)
            # end of stream: the coalesced batches, the dense folds still in
            # flight, then the deferred counts, in order
            yield from flush_pending()
            if dense is not None:
                for nb in dense.finish_pending():
                    if dense is None:  # an earlier retry fell back for good
                        yield from feed_generic(nb)
                        continue
                    with metrics.timer("elapsed_compute"):
                        leftovers = fold_dense(nb, defer=False)
                    for gb in leftovers or ():
                        yield from feed_generic(gb)
            if dense is not None:
                drain_dense()
            if probe is not None:
                for mb in probe.finish():
                    yield from process_generic(mb)
            if defer_win is not None:
                for resolved, st in defer_win.drain():
                    yield from resolve_deferred(resolved, st)
        finally:
            if win_guard is not None:
                defer_win.clear()
                mm.unregister(win_guard)
            if probe is not None:
                mm.unregister(probe)
                probe.release()
            if dense is not None:
                mm.unregister(dense)
                dense.release()
            mm.unregister(table)
        if skipping:
            return
        with metrics.timer("merge_time"):
            out = table.collect_state()
        if out is None:
            if self.n_keys == 0:
                yield self._empty_global_agg(ctx.device)
            return
        yield self._finalize(out) if self.mode == FINAL else out

    # ------------------------------------------------------------------
    # column extraction (shared by the dense table and the generic path)

    def _raw_inputs(self, b: Batch):
        ev = Evaluator(self.children[0].schema)
        keys = ev.evaluate(b, [g for g, _ in self.groupings])
        inputs: list[list[ColumnVal]] = []
        for (a, _), in_t in zip(self.aggs, self._agg_input_types):
            if a.expr is None:
                inputs.append([])
                continue
            cv = ev.evaluate(b, [a.expr])[0]
            if a.func in ("sum", "avg") and not is_wide_sum(in_t):
                # a wide sum takes its input as it is (the limb machinery)
                cv = ev._cast(cv, sum_type(in_t))
            inputs.append([cv])
        return keys, inputs

    def _state_keys(self, b: Batch) -> list[ColumnVal]:
        return [ColumnVal(b.col_values(i), b.col_validity(i), self.inter_schema[i].dtype,
                          b.dicts[i]) for i in range(self.n_keys)]

    def _intermediate_groups(self, b: Batch) -> list[list[ColumnVal]]:
        ofs = self.n_keys
        groups = []
        for (a, name), in_t in zip(self.aggs, self._agg_input_types):
            k = len(intermediate_fields(a, in_t or T.INT64, name))
            groups.append([
                ColumnVal(b.col_values(ofs + j), b.col_validity(ofs + j),
                          self.inter_schema[ofs + j].dtype, b.dicts[ofs + j])
                for j in range(k)
            ])
            ofs += k
        return groups

    def _keys_and_inputs(self, b: Batch):
        if self.mode == PARTIAL:
            return self._raw_inputs(b)
        return self._state_keys(b), self._intermediate_groups(b)

    def _to_intermediate(self, b: Batch, conf) -> Batch:
        keys, inputs = self._keys_and_inputs(b)
        return self._group_reduce(b.device.sel, keys, inputs, raw=self.mode == PARTIAL,
                                  conf=conf)

    # ------------------------------------------------------------------
    # sort-segmentation reduce

    def _group_reduce(self, sel, keys, agg_cols, raw: bool, force_full_sort: bool = False,
                      conf=None, merge_cap_a: int | None = None, fp=None) -> Batch:
        """Group and reduce one batch. ``merge_cap_a`` segments two
        back-to-back fingerprint-sorted runs by merge rank instead of a sort
        (the merge-path form of ``_merge``; ``fp`` their cached
        fingerprints); ``force_full_sort`` pins the full-word sort."""
        cap = int(sel.shape[0])
        dev = sel.device
        flags = self._sort_flags(dev, force_full_sort, conf, cap)
        if self.n_keys == 0:
            seg = S.Segmentation(
                order=torch.arange(cap, device=dev),
                seg_ids=torch.where(sel, 0, cap).to(torch.int64),
                boundary=torch.zeros(cap, dtype=torch.bool, device=dev),
                group_of_slot=torch.zeros(cap, dtype=torch.int64, device=dev),
                num_groups=sel.sum().clamp(max=1),
                sel_sorted=sel,
            )
        elif merge_cap_a is not None:
            seg = S.segment_merged(S.key_words(keys), sel, merge_cap_a,
                                   (conf or active_conf()).get(AGG_INCREMENTAL_FP_BITS), fp)
        else:
            seg = S.segment_by_keys(
                S.key_words(keys), sel, device_impl=flags[0], n_key_cols=self.n_keys,
                fingerprint=flags[1], fp_bits=flags[2],
            )
        order = seg.order
        slot = seg.group_of_slot.clamp(0, cap - 1)
        group_valid = torch.arange(cap, device=dev) < seg.num_groups
        if self.n_keys == 0:
            group_valid = torch.zeros(cap, dtype=torch.bool, device=dev)
            group_valid[0] = True
        out: list[ColumnVal] = []
        for kv in keys:
            sv, sm = kv.values[order], kv.validity[order]
            out.append(ColumnVal(sv[slot], sm[slot] & group_valid, kv.dtype, kv.dict))
        for (a, _), in_t, cols in zip(self.aggs, self._agg_input_types, agg_cols):
            out.extend(_reduce_one(a, in_t, cols, seg, cap, raw, group_valid))
        b = batch_from_columns(out, self.inter_schema.names, group_valid)
        res = Batch(self.inter_schema, b.device, b.dicts)
        res._fp_collision = seg.collision
        if seg.fp_sorted is not None:
            # fingerprint provenance (reference ``_attach_fp_meta``): the
            # groups came out in fingerprint order, and each group's
            # fingerprint (dead slots DEAD_FP) is cached, so a probe or a
            # pair merge never re-hashes the state's keys
            res._fp_order = True
            res._inc_fp = torch.where(group_valid, seg.fp_sorted[slot],
                                      torch.full_like(seg.fp_sorted, S.DEAD_FP))
        return res

    def _merge(self, parts: list[Batch], final: bool = False, conf=None,
               metrics=None) -> Batch | None:
        """Merge prefix-packed group batches into one state batch. Three
        forms (reference ``agg_exec.py:846-1000``), picked from host
        evidence: merge-path (every part a collision-free fingerprint-sorted
        run: pairwise merge-rank merges, no sort); concat and re-sort (a
        part without fingerprint order, e.g. a dense drain or a spilled run,
        or a collision); and a FINAL merge that saw a collision re-reduces
        with the full-word sort, so split groups never reach the output."""
        parts = [p for p in parts if p is not None]
        if not parts:
            return None
        conf = conf if conf is not None else active_conf()
        collided = _resolve_fp_flags(parts, metrics)
        if len(parts) == 1 and not (final and collided):
            return parts[0]
        dev = parts[0].torch_device
        if (not collided and self._mergepath_eligible(conf, dev)
                and all(getattr(p, "_fp_order", False) for p in parts)):
            with metrics.timer("merge_path_s") if metrics is not None else nullcontext():
                acc = self._merge_path(parts, metrics, conf)
            if metrics is not None:
                metrics.add("merge_path_merges", 1)
            if final and acc._fp_collision_host:
                acc = self._dedup_full_sort(acc, conf)
            return acc
        big = device_concat(parts)
        merged = self._group_reduce(big.device.sel, self._state_keys(big),
                                    self._intermediate_groups(big), raw=False,
                                    force_full_sort=final and collided, conf=conf)
        coll = merged._fp_collision
        if coll is None:
            return _prefix_slice_meta(merged, bucket_capacity(max(merged.num_rows(), 1)))
        g, c = (int(x) for x in blocking_read(None, merged.device.num_rows(), coll))
        _note_collision(merged, c, metrics)
        out = _prefix_slice_meta(merged, bucket_capacity(max(g, 1)))
        if final and c:
            # the collision arose in this very merge: its output is the
            # operator's answer, so dedup with the full-word sort now
            out = self._dedup_full_sort(out, conf)
        return out

    def _dedup_full_sort(self, b: Batch, conf) -> Batch:
        """Re-reduce a merged state with the full-word sort (the exactness
        backstop of a FINAL merge whose layout holds a collision)."""
        merged = self._group_reduce(b.device.sel, self._state_keys(b),
                                    self._intermediate_groups(b), raw=False,
                                    force_full_sort=True, conf=conf)
        return prefix_slice(merged, bucket_capacity(max(merged.num_rows(), 1)))

    def _merge_path(self, parts: list[Batch], metrics, conf) -> Batch:
        """Sequential pairwise merge-rank merges (reference ``agg_exec.py:
        921-972``): acc + part laid back to back, permuted by two binary
        searches over their cached fingerprints and segment-reduced; one
        read per pair merge (the group count and the collision flag)."""
        acc = parts[0]
        for p in parts[1:]:
            big = device_concat([acc, p])
            fp_a, fp_b = getattr(acc, "_inc_fp", None), getattr(p, "_inc_fp", None)
            fp_cat = None
            if fp_a is not None and fp_b is not None:
                fp_cat = torch.cat([fp_a, fp_b])
                pad = big.capacity - fp_cat.shape[0]
                if pad:
                    fp_cat = torch.cat([fp_cat, torch.full((pad,), S.DEAD_FP, dtype=fp_cat.dtype,
                                                           device=fp_cat.device)])
            merged = self._group_reduce(big.device.sel, self._state_keys(big),
                                        self._intermediate_groups(big), raw=False, conf=conf,
                                        merge_cap_a=acc.capacity, fp=fp_cat)
            g, c = (int(x) for x in blocking_read(None, merged.device.num_rows(),
                                                  merged._fp_collision))
            _note_collision(merged, c, metrics)
            acc = _prefix_slice_meta(merged, bucket_capacity(max(g, 1)))
        return acc

    # ------------------------------------------------------------------

    def _finalize(self, state: Batch) -> Batch:
        vals = self._state_keys(state)
        names = [self.schema[i].name for i in range(self.n_keys)]
        for ((a, name), in_t), cols in zip(zip(self.aggs, self._agg_input_types),
                                           self._intermediate_groups(state)):
            vals.append(_final_one(a, in_t, cols))
            names.append(name)
        out = batch_from_columns(vals, names, state.device.sel)
        return Batch(self.schema, out.device, out.dicts)

    def _empty_global_agg(self, device) -> Batch:
        """Global aggregation over empty input: one row (count=0, else NULL)."""
        cap = 128
        schema = self.schema if self.mode == FINAL else self.inter_schema
        vals = []
        for f in schema:
            is_count = f.name.endswith("#count") or (
                self.mode == FINAL
                and any(n == f.name and a.func in ("count", "count_star") for a, n in self.aggs)
            )
            valid = torch.zeros(cap, dtype=torch.bool, device=device)
            valid[0] = is_count
            vals.append(ColumnVal(torch.zeros(cap, dtype=f.dtype.physical_dtype(), device=device),
                                  valid, f.dtype,
                                  empty_dict(f.dtype) if f.dtype.is_dict_encoded else None))
        sel = torch.zeros(cap, dtype=torch.bool, device=device)
        sel[0] = True
        out = batch_from_columns(vals, schema.names, sel)
        return Batch(schema, out.device, out.dicts)


class _AggTableConsumer:
    """The generic path's spillable state (reference ``agg_exec.py:1451``):
    ``staged`` intermediates and the merged ``state`` on the device, and
    ``parked`` runs the spills wrote to host RAM (demoted to disk under
    ledger pressure), merged back at the end. The manager may spill it from
    another task's thread; the lock order is manager, then this lock."""

    def __init__(self, exec_: HashAggExec, ctx: ExecutionContext):
        self.name = f"agg-{id(exec_):x}"
        self.exec = exec_
        self.ctx = ctx
        self.state: Batch | None = None
        self.staged: list[Batch] = []
        self.staged_rows = 0
        self._staged_bytes = 0
        self._state_bytes = 0
        #: (spill container, device, fingerprint-collision flag or None)
        self.parked: list[tuple] = []
        self._lock = threading.RLock()

    def add(self, inter: Batch, groups: int) -> None:
        with self._lock:
            self.staged.append(inter)
            self.staged_rows += groups
            self._staged_bytes += batch_nbytes(inter)

    def state_capacity(self) -> int:
        with self._lock:
            return self.state.capacity if self.state is not None else 0

    def compact(self) -> None:
        with self._lock:
            parts = ([self.state] if self.state is not None else []) + self.staged
            self.state = self.exec._merge(parts, conf=self.ctx.conf, metrics=self.ctx.metrics)
            self.staged, self.staged_rows, self._staged_bytes = [], 0, 0
            self._state_bytes = batch_nbytes(self.state) if self.state is not None else 0

    def mem_used(self) -> int:
        # kept incrementally: the manager polls every consumer on each acquire
        with self._lock:
            return self._staged_bytes + self._state_bytes

    def spill(self) -> int:
        """Merge everything into the state and park it as an encoded run."""
        with self._lock:
            freed = self.mem_used()
            if freed == 0:
                return 0
            with self.ctx.metrics.timer("spill_time"):
                self.compact()
                if self.state is not None:
                    ds = memmgr.make_spill(conf=self.ctx.conf)
                    try:
                        ds.write_batch(self.state)
                    except BaseException:
                        ds.release()  # a failed park must not strand ledger bytes
                        raise
                    self.parked.append((ds, self.state.torch_device,
                                        getattr(self.state, "_fp_collision", None)))
            self.ctx.metrics.add("spilled_aggs", 1)
            self.state, self._state_bytes = None, 0
            return freed

    def _read_parked(self, parked: list[tuple]) -> Iterator[Batch]:
        for ds, device, collided in parked:
            for b in ds.read_batches(self.exec.inter_schema, device):
                b._fp_collision = collided
                yield b
            ds.release()

    def _take(self) -> tuple[list[Batch], list[tuple]]:
        """State first (compact()'s part order), then staged; and the parked runs."""
        with self._lock:
            parts = ([self.state] if self.state is not None else []) + self.staged
            parked = self.parked
            self.staged, self.staged_rows, self.state, self.parked = [], 0, None, []
            self._staged_bytes = self._state_bytes = 0
        return parts, parked

    def drain(self) -> Iterator[Batch]:
        """Every part unmerged (the partial-skip path), parked runs read back."""
        parts, parked = self._take()
        yield from parts
        yield from self._read_parked(parked)

    def collect_state(self) -> Batch | None:
        """State, staged and parked runs merged into the final state (a
        FINAL merge dedups fingerprint collisions by the full-word sort)."""
        parts, parked = self._take()
        parts.extend(self._read_parked(parked))
        if not parts:
            return None
        return self.exec._merge(parts, final=self.exec.mode == FINAL, conf=self.ctx.conf,
                               metrics=self.ctx.metrics)

    def release(self) -> None:
        """Drop the state and release the parked runs (every path out)."""
        _, parked = self._take()
        for ds, _, _ in parked:
            ds.release()


# ---------------------------------------------------------------------------
# incremental sorted-state probe/scatter (exec.agg.incremental.probe)
# ---------------------------------------------------------------------------


def _state_fp(ex: HashAggExec, st: Batch, fp_bits: int) -> torch.Tensor:
    """A state batch's per-row fingerprints (dead slots DEAD_FP): for a
    state without the cached ``_inc_fp`` (a spilled run read back)."""
    fp = hashing.fingerprint64(S.key_words(ex._state_keys(st)), fp_bits)
    return torch.where(st.device.sel, fp, torch.full_like(fp, S.DEAD_FP))


def _probe_scatter(ex: HashAggExec, st: Batch, state_fp, keys, sel, per_agg, raw: bool,
                   fp_bits: int):
    """Binary-search every row into the fingerprint-sorted state, verify the
    key words at the found slot (a colliding fingerprint is a miss, never a
    wrong fold) and scatter the hit rows into the state's accumulators
    (reference ``_probe_scatter_jit``, ``agg_exec.py:2845-2995``). Returns
    (new accumulator ColumnVals, miss mask, miss count, hit count)."""
    s_cap = st.capacity
    ssel = st.device.sel
    swords = S.key_words(ex._state_keys(st))
    bwords = S.key_words(keys)
    fp = hashing.fingerprint64(bwords, fp_bits)
    slot = binsearch.lower_bound_dyn([state_fp], [fp], s_cap).clamp(0, s_cap - 1)
    hit = sel & ssel[slot] & (state_fp[slot] == fp)
    for sw, bw in zip(swords, bwords):
        hit = hit & (sw[slot] == bw)
    idx = torch.where(hit, slot, torch.full_like(slot, s_cap))
    acc = ex._intermediate_groups(st)

    def ssum(v):
        return S.seg_sum(v, hit, idx, s_cap)[0]

    def sany(flags):
        return S.seg_any(flags, idx, s_cap)

    out: list[ColumnVal] = []
    for (a, _), in_t, ins, cols in zip(ex.aggs, ex._agg_input_types, per_agg, acc):
        f = a.func

        def upd(i, contrib, valid=None):
            c = cols[i]
            out.append(ColumnVal(c.values + contrib.to(c.values.dtype),
                                 c.validity if valid is None else c.validity | valid,
                                 c.dtype, c.dict))

        if f in ("count", "count_star"):
            if not raw:
                upd(0, ssum(ins[0].values.to(torch.int64)))
            elif f == "count_star":
                upd(0, ssum(torch.ones_like(idx)))
            else:
                upd(0, ssum(ins[0].validity.to(torch.int64)))
            continue
        if f in ("sum", "avg"):
            if is_wide_sum(in_t):
                k = _n_limbs(sum_type(in_t).precision)
                if raw:
                    ok = hit & ins[0].validity
                    limbs = limb_rows(ins[0], ok, in_t, k)
                    oks = [ok] * k
                else:
                    oks = [hit & ins[i].validity for i in range(k)]
                    limbs = [ins[i].values.to(torch.int64) for i in range(k)]
                for i, (lv, ok) in enumerate(zip(limbs, oks)):
                    upd(i, ssum(torch.where(ok, lv, torch.zeros_like(lv))), sany(ok))
            else:
                k = 1
                ok = hit & ins[0].validity
                v = ins[0].values
                upd(0, ssum(torch.where(ok, v, torch.zeros_like(v))), sany(ok))
            if f == "avg":
                c = (hit & ins[0].validity).to(torch.int64) if raw else \
                    torch.where(hit, ins[k].values, torch.zeros_like(ins[k].values))
                upd(k, ssum(c.to(torch.int64)))
            continue
        if f in ("min", "max"):
            v = ins[0].values
            ok = hit & ins[0].validity
            fn = S.seg_min if f == "min" else S.seg_max
            contrib, cv_valid = fn(v, ok, idx, s_cap)
            old = cols[0]
            both = (torch.minimum if f == "min" else torch.maximum)(old.values, contrib)
            new_v = torch.where(old.validity & cv_valid, both,
                                torch.where(cv_valid, contrib, old.values))
            out.append(ColumnVal(new_v, old.validity | cv_valid, old.dtype, old.dict))
            continue
        # first / first_ignores_null
        v, m = ins[0].values, ins[0].validity
        if raw:
            elig = hit & (m if f == "first_ignores_null" else torch.ones_like(m))
        else:
            elig = hit & ins[1].values.to(torch.bool)
        n = v.shape[0]
        pos = torch.arange(n, dtype=torch.int64, device=v.device)
        first_pos = torch.full((s_cap + 1,), n, dtype=torch.int64, device=v.device)
        first_pos.scatter_reduce_(0, idx, torch.where(elig, pos, torch.full_like(pos, n)),
                                  "amin", include_self=True)
        first_pos = first_pos[:s_cap]
        has = first_pos < n
        safe = first_pos.clamp(0, n - 1)
        val, seen = cols
        seen_old = seen.values.to(torch.bool)
        take = has & ~seen_old
        out.append(ColumnVal(torch.where(take, v[safe].to(val.values.dtype), val.values),
                             torch.where(take, m[safe] & has, val.validity), val.dtype, val.dict))
        out.append(ColumnVal(seen_old | has, seen.validity, seen.dtype))
    miss = sel & ~hit
    return out, miss, miss.sum(), hit.sum()


class _ProbeScatter:
    """Sorted-state probe/scatter driver (reference ``agg_exec.py:3003``).

    Folds each batch into the table's fingerprint-sorted state under the
    table lock (a cross-thread spill serialises against the in-place state
    swap); a batch's miss and hit counts ride the transfer window and are
    harvested ``runtime.transfer.window.depth`` batches later, when its miss
    rows (if any) go to the generic path with their selection narrowed.
    Registered unspillable for the in-flight batches it holds."""

    def __init__(self, exec_: HashAggExec, ctx: ExecutionContext, table: "_AggTableConsumer"):
        self.name = f"agg-probe-{id(exec_):x}"
        self.exec = exec_
        self.ctx = ctx
        self.table = table
        self._pending: deque = deque()
        self._pending_lock = threading.Lock()
        self._depth = max(1, ctx.conf.get(TRANSFER_WINDOW_DEPTH))
        self._raw = exec_.mode == PARTIAL
        self._fp_bits = ctx.conf.get(AGG_INCREMENTAL_FP_BITS)
        self._harvested_hits = 0

    def _ready(self) -> bool:
        st = self.table.state
        return st is not None and getattr(st, "_fp_order", False)

    def fold(self, b: Batch) -> tuple[bool, list[Batch], int]:
        """Probe one batch into the state: (folded, earlier batches whose
        harvested miss count was nonzero — to the generic path with their
        selection narrowed to the misses —, rows those earlier folds hit,
        which the caller feeds to the partial-skip row counter)."""
        self._harvested_hits = 0
        out: list[Batch] = []
        if len(self._pending) >= self._depth:
            out += self._harvest_one()
        with self.table._lock:
            ready = self._ready()
        if not ready:
            # a spill parked the state: this batch goes generic at once, so
            # every older batch's misses must stage first (stream order for
            # first / first_ignores_null)
            out += self.finish()
            return False, out, self._harvested_hits
        keys, per_agg = self.exec._keys_and_inputs(b)
        ex = self.exec
        with self.table._lock:
            st = self.table.state
            if st is None or not getattr(st, "_fp_order", False):
                st = None
            else:
                state_fp = getattr(st, "_inc_fp", None)
                if state_fp is None:
                    state_fp = st._inc_fp = _state_fp(ex, st, self._fp_bits)
                acc, miss, miss_n, hit_n = _probe_scatter(
                    ex, st, state_fp, keys, b.device.sel, per_agg, self._raw, self._fp_bits)
                cols = ex._state_keys(st) + acc
                dev = st.device._replace(values=tuple(c.values for c in cols),
                                         validity=tuple(c.validity for c in cols))
                ns = Batch(st.schema, dev, st.dicts)
                ns._inc_fp = state_fp
                for attr in _FP_META:
                    if hasattr(st, attr):
                        setattr(ns, attr, getattr(st, attr))
                # keys, sel, capacity and bytes unchanged: the table's
                # memory accounting stands
                self.table.state = ns
        if st is None:
            out += self.finish()
            return False, out, self._harvested_hits
        tr = start_host_transfer(miss_n, hit_n)
        with self._pending_lock:
            self._pending.append((b, miss, tr))
        return True, out, self._harvested_hits

    def _harvest_one(self) -> list[Batch]:
        with self._pending_lock:
            b, miss, tr = self._pending.popleft()
        mn, hn = (int(x) for x in harvest(tr, self.ctx.metrics))
        self.ctx.metrics.add("probe_hit_rows", hn)
        self._harvested_hits += hn
        if mn == 0:
            return []
        self.ctx.metrics.add("probe_miss_batches", 1)
        return [b.with_device(b.device._replace(sel=miss))]

    def finish(self) -> list[Batch]:
        """Resolve every fold in flight (in order)."""
        out: list[Batch] = []
        while self._pending:
            out += self._harvest_one()
        return out

    def mem_used(self) -> int:
        with self._pending_lock:
            return sum(batch_nbytes(pb) for pb, _, _ in self._pending)

    def spill(self) -> int:
        return 0  # in-flight batches only; resolved within the window depth

    def release(self) -> None:
        with self._pending_lock:
            self._pending.clear()


_FP_META = ("_fp_order", "_fp_collision", "_fp_collision_host")

#: check-and-set guard of a batch's ``_fp_collision_host``: the operator's
#: thread and a cross-thread spill's merge may resolve the same staged part
_FP_FLAG_LOCK = threading.Lock()


def _prefix_slice_meta(b: Batch, cap: int) -> Batch:
    """prefix_slice carrying the fingerprint provenance (groups live in the
    prefix, so the fingerprint order survives)."""
    out = prefix_slice(b, cap)
    if out is not b:
        for attr in _FP_META:
            if hasattr(b, attr):
                setattr(out, attr, getattr(b, attr))
        if getattr(b, "_inc_fp", None) is not None:
            out._inc_fp = b._inc_fp[:cap]
    return out


def _note_collision(ref: Batch, coll: int, metrics) -> None:
    """Record a read collision flag once per reduce output."""
    with _FP_FLAG_LOCK:
        if hasattr(ref, "_fp_collision_host"):
            return
        ref._fp_collision_host = bool(coll)
    if coll and metrics is not None:
        metrics.add("fp_collision_batches", 1)


def _resolve_fp_flags(parts: list[Batch], metrics) -> bool:
    """Read (once, in one batched read) the collision flags not read yet;
    whether ANY part holds a collision. A part without a flag (a dense
    drain, a full-word reduce) counts as clean."""
    unread = [p for p in parts if getattr(p, "_fp_collision", None) is not None
              and not hasattr(p, "_fp_collision_host")]
    if unread:
        (flags,) = blocking_read(None, torch.stack([p._fp_collision for p in unread]))
        for p, f in zip(unread, flags):
            _note_collision(p, int(f), metrics)
    return any(getattr(p, "_fp_collision_host", False) for p in parts)


def _reduce_one(a: AggExpr, in_t, cols, seg: S.Segmentation, cap: int, raw: bool,
                group_valid) -> list[ColumnVal]:
    ids = seg.seg_ids

    def sortg(cv):
        return cv.values[seg.order], cv.validity[seg.order] & seg.sel_sorted

    if a.func == "count_star":
        if raw:
            cnt = S.seg_count(seg.sel_sorted, ids, cap)
        else:
            v, m = sortg(cols[0])
            cnt, _ = S.seg_sum(v, m, ids, cap)
        return [ColumnVal(cnt, group_valid, T.INT64)]
    if a.func == "count":
        v, m = sortg(cols[0])
        cnt = S.seg_count(m, ids, cap) if raw else S.seg_sum(v, m, ids, cap)[0]
        return [ColumnVal(cnt, group_valid, T.INT64)]
    if a.func in ("sum", "avg"):
        if is_wide_sum(in_t):
            out = _reduce_wide_sum(in_t, cols, sortg, ids, cap, raw, group_valid)
            m = sortg(cols[0])[1]
        else:
            v, m = sortg(cols[0])
            sm, any_valid = S.seg_sum(v, m, ids, cap)
            out = [ColumnVal(sm, any_valid & group_valid, sum_type(in_t))]
        if a.func == "avg":
            if raw:
                cnt = S.seg_count(m, ids, cap)
            else:
                cv, cm = sortg(cols[len(out)])  # the count rides after the sum
                cnt, _ = S.seg_sum(cv, cm, ids, cap)
            out.append(ColumnVal(cnt, group_valid, T.INT64))
        return out
    if a.func in ("min", "max"):
        v, m = sortg(cols[0])
        fn = S.seg_min if a.func == "min" else S.seg_max
        d = cols[0].dict
        if d is not None and len(d) > 0:
            # codes are in first-occurrence order: reduce in the
            # vocabulary's rank space, then invert the winning rank
            rank, inv = (torch.from_numpy(t).to(v.device) for t in dict_rank_maps(d))
            mr, any_valid = fn(rank[v.long().clamp(0, len(rank) - 1)], m, ids, cap)
            mv = inv[mr.clamp(0, len(inv) - 1)].to(v.dtype)
        else:
            mv, any_valid = fn(v, m, ids, cap)
        return [ColumnVal(mv, any_valid & group_valid, in_t, d)]
    if a.func == "host_udaf":
        return [_reduce_udaf_state(a.udaf, in_t, cols[0], seg, cap, raw, group_valid)]
    if a.func in _HOST_FUNCS:
        return [_reduce_collect(a.func, in_t, cols[0], seg, cap, raw, group_valid)]
    if a.func in ("first", "first_ignores_null"):
        v, m = sortg(cols[0])
        if raw:
            eligible = seg.sel_sorted & (m if a.func == "first_ignores_null"
                                         else torch.ones_like(m))
        else:
            sv, _ = sortg(cols[1])
            eligible = seg.sel_sorted & sv.to(torch.bool)
        n = v.shape[0]
        pos = torch.arange(n, dtype=torch.int64, device=v.device)
        first_pos = torch.full((cap + 1,), n, dtype=torch.int64, device=v.device)
        first_pos.scatter_reduce_(0, ids, torch.where(eligible, pos, torch.full_like(pos, n)),
                                  "amin", include_self=True)
        first_pos = first_pos[:cap]
        hit = first_pos < n
        safe = first_pos.clamp(0, n - 1)
        return [ColumnVal(v[safe], m[safe] & hit & group_valid, in_t, cols[0].dict),
                ColumnVal(hit & group_valid, group_valid, T.BOOL)]
    raise ValueError(a.func)


def _reduce_collect(func: str, in_t: T.DataType, cv: ColumnVal, seg: S.Segmentation, cap: int,
                    raw: bool, group_valid) -> ColumnVal:
    """collect_list / collect_set (reference ``agg_exec.py:1204-1253``): each
    group's values as one entry of a LIST vocabulary, the codes
    ``arange(cap) % groups`` over it. A raw batch collects its non-NULL
    values; a merge input's groups extend the lists of their partial states,
    laid end to end in row order (``_merge_input``).

    Each row's group goes back to the row's input position, so one stable
    sort by group keeps the input order within a group: the reference's
    segment order, whatever order the segmentation left equal keys in.
    collect_set orders on the device too (``_set_order``): the repeats of a
    value within a group dropped, the first kept, and each set ordered by
    the text of its values, the reference's ``sorted(set(l), key=str)``.
    One read brings the grouped values to the host, where numpy splits them
    at the group boundaries."""
    dev = cv.values.device
    pos_gid = torch.full((cap,), cap, dtype=torch.int64, device=dev)
    pos_gid[seg.order] = seg.seg_ids  # each input row's group; dead rows cap
    if raw:
        gid, vals, keep, d = pos_gid, cv.values, cv.validity & (pos_gid < cap), cv.dict
        n_groups = seg.num_groups
    else:
        gid, vals, keep, d, n_groups = _merge_input(cv, pos_gid, seg.num_groups, cap, in_t)
    key = torch.where(keep, gid, torch.full_like(gid, cap))
    if func == "collect_set":
        order, kept = _set_order(key, vals, d, in_t, cap)
    else:
        order = torch.sort(key, stable=True).indices
        kept = key[order] < cap
    g, v, k, ng = harvest(start_host_transfer(key[order], vals[order], kept,
                                              torch.as_tensor(n_groups)))
    ng = int(ng)
    g, flat = g[k], _py_values(v[k], in_t, d).tolist()
    bounds = np.concatenate(([0], np.cumsum(np.bincount(g, minlength=ng)[:ng]))).tolist()
    lists = list(map(flat.__getitem__, map(slice, bounds[:-1], bounds[1:]))) or [[]]
    codes = torch.remainder(torch.arange(cap, dtype=torch.int32, device=dev), max(ng, 1))
    return ColumnVal(codes, group_valid, T.DataType(T.TypeKind.LIST, inner=(in_t,)),
                     object_array(lists))


def _reduce_udaf_state(udaf: str, in_t, cv: ColumnVal, seg: S.Segmentation, cap: int,
                       raw: bool, group_valid) -> ColumnVal:
    """A host UDAF's accumulation (reference ``agg_exec.py:1152-1202``): a
    raw batch folds each group's values into a fresh state (``update``), a
    merge input merges the partial states of its groups (``merge``). One
    batched read brings the group ids and the values to the host; each
    group's state goes back pickled, one BINARY vocabulary entry a group,
    the codes ``arange(cap) % groups`` over it."""
    import pickle

    from auron_tpu_torch.bridge.udf import lookup_udaf

    spec = lookup_udaf(udaf)
    dev = cv.values.device
    g, v, k, ng = harvest(start_host_transfer(
        seg.seg_ids, cv.values[seg.order], cv.validity[seg.order] & seg.sel_sorted,
        torch.as_tensor(seg.num_groups)))
    n_groups = int(ng)
    states: list = [None] * max(n_groups, 1)
    rows = np.flatnonzero(k & (g >= 0) & (g < n_groups))
    if raw:
        for gid, val in zip(g[rows].tolist(), _py_values(v[rows], in_t, cv.dict).tolist()):
            st = states[gid]
            states[gid] = spec.update(spec.init() if st is None else st, val)
    else:
        d = cv.dict
        for gid, code in zip(g[rows].tolist(), v[rows].tolist()):
            blob = d[code] if 0 <= code < len(d) else None
            if not blob:
                continue
            other = pickle.loads(blob)
            states[gid] = other if states[gid] is None else spec.merge(states[gid], other)
    blobs = object_array([pickle.dumps(st if st is not None else spec.init()) for st in states])
    codes = torch.remainder(torch.arange(cap, dtype=torch.int32, device=dev), max(n_groups, 1))
    return ColumnVal(codes, group_valid, T.BINARY, blobs)


def _final_udaf(udaf: str, state: ColumnVal) -> ColumnVal:
    """``finish`` of each group's state (reference ``agg_exec.py:1251-1263``):
    one batched read of the codes, the results back as one column."""
    import pickle

    from auron_tpu_torch.bridge.udf import lookup_udaf

    spec = lookup_udaf(udaf)
    cap = int(state.values.shape[0])
    codes, valid = harvest(start_host_transfer(state.values, state.validity))
    d = state.dict
    out = []
    for code, ok in zip(codes.tolist(), valid.tolist()):
        blob = d[code] if ok and 0 <= code < len(d) else None
        out.append(spec.finish(pickle.loads(blob)) if blob else None)
    v, m, vocab = column_from_pylist(out, spec.out_dtype, cap, state.values.device)
    return ColumnVal(v, m & state.validity, spec.out_dtype, vocab)


def _merge_input(cv: ColumnVal, pos_gid, n_groups, cap: int, in_t: T.DataType):
    """A merge input's partial lists as flat values on its device, in row
    order then list order: (group of each value, values, keep, vocabulary
    of dictionary values or None, the group count read)."""
    gid_h, codes, ok, ng = harvest(start_host_transfer(
        pos_gid, cv.values, cv.validity & (pos_gid < cap), torch.as_tensor(n_groups)))
    rows = np.flatnonzero(ok)
    sub = cv.dict[np.clip(codes[rows], 0, len(cv.dict) - 1)]
    lens = np.fromiter(map(len, sub), dtype=np.int64, count=len(sub))
    total = int(lens.sum())
    items = itertools.chain.from_iterable(sub)
    dev = cv.values.device
    if in_t.is_integer or in_t.is_float or in_t.kind == T.TypeKind.BOOL:
        vals, d = torch.from_numpy(np.fromiter(items, dtype=in_t.numpy_dtype(), count=total)), None
    else:
        vals, _, d = column_from_pylist(list(items), in_t, total, "cpu")
    gid = torch.from_numpy(np.repeat(gid_h[rows], lens))
    return (gid.to(dev), vals.to(dev), torch.ones(total, dtype=torch.bool, device=dev), d,
            int(ng))


def _set_order(key, vals, d, in_t: T.DataType, cap: int):
    """(order, kept) of collect_set: the repeats of a value within a group
    dropped, the first kept (stable sorts by value, then by group: a row is
    kept where its (group, value) differs from the row before), then each
    group's values ordered by the text of their Python values (a rank table
    over the distinct values, made on the host). Values compare as the
    reference's Python set compares them: -0.0 equals 0.0, a NaN equals no
    NaN, dictionary entries by value. ``key`` is each row's group, ``cap``
    for the rows left out."""
    dev = vals.device
    if d is not None:
        first: dict = {}
        canon = np.array([first.setdefault(vocab_key(e), i) for i, e in enumerate(d)] or [0],
                         dtype=np.int64)
        eq = torch.from_numpy(canon).to(dev)[vals.long().clamp(0, len(canon) - 1)]
    elif in_t.is_float:
        eq = vals + 0.0  # -0.0 and 0.0 one value
    else:
        eq = vals.to(torch.int64)
    by_value = torch.sort(eq, stable=True).indices
    order = by_value[torch.sort(key[by_value], stable=True).indices]
    g, e = key[order], eq[order]
    kept = g < cap
    kept[1:] &= (g[1:] != g[:-1]) | (e[1:] != e[:-1])  # NaN != NaN: every NaN kept
    # floats ranked by their bits (-0.0 and 0.0 print apart), codes by entry
    v = vals[order]
    bits = v.view(torch.int32 if v.element_size() == 4 else torch.int64) if in_t.is_float \
        else v.to(torch.int64)
    uniq = torch.unique(bits[kept])
    if not len(uniq):
        return order, kept
    u = uniq.cpu().numpy()
    pv = _py_values(u.view(in_t.numpy_dtype()) if in_t.is_float else u, in_t, d)
    texts = [str(x) for x in pv]
    rank = np.empty(len(texts), dtype=np.int64)
    rank[sorted(range(len(texts)), key=texts.__getitem__)] = np.arange(len(texts))
    r = torch.from_numpy(rank).to(dev)[torch.searchsorted(uniq, bits).clamp(max=len(uniq) - 1)]
    by_text = torch.sort(torch.where(kept, g * len(uniq) + r,
                                     torch.full_like(g, torch.iinfo(torch.int64).max)),
                         stable=True).indices
    return order[by_text], kept[by_text]


def _py_values(v: np.ndarray, in_t: T.DataType, d) -> np.ndarray:
    """Host values (a physical plane, or codes into ``d``) as the Python
    values Arrow's ``to_pylist`` gives, in an object array."""
    if d is not None:
        return d[np.clip(v, 0, len(d) - 1)]
    if in_t.is_integer or in_t.is_float or in_t.kind == T.TypeKind.BOOL:
        return v.astype(object)
    uniq, inv = np.unique(v, return_inverse=True)
    return object_array([_python_value(u, in_t, None) for u in uniq])[inv.reshape(-1)]


def decimal_limb_tables(d, scale: int, k: int) -> list[np.ndarray]:
    """k base-1e9 limb tables of a wide-decimal vocabulary (reference
    ``agg_exec.py:1826``): entry e is sum(limb_i * 1e9^i) of its unscaled
    value, floored (the top limb carries the sign)."""
    tabs = [np.zeros(max(len(d), 1), dtype=np.int64) for _ in range(k)]
    for i, e in enumerate(d):
        if e is None:
            continue
        u = T.unscaled_int(e, scale)
        for j in range(k - 1):
            u, r = divmod(u, _LIMB_BASE)
            tabs[j][i] = r
        tabs[k - 1][i] = u
    return tabs


def limb_rows(cv: ColumnVal, valid: torch.Tensor, in_t: T.DataType, k: int) -> list:
    """Per-row base-1e9 limbs of a decimal column: a wide vocabulary's from
    host tables gathered by code, a decimal64's by floored div/mod on the
    device (0 where not ``valid``)."""
    if in_t.is_wide_decimal:
        idx = cv.values.long().clamp(0, max(len(cv.dict), 1) - 1)
        return [torch.from_numpy(t).to(idx.device)[idx]
                for t in decimal_limb_tables(cv.dict, in_t.scale, k)]
    v = cv.values.to(torch.int64)
    cur = torch.where(valid, v, torch.zeros_like(v))
    out = []
    for _ in range(k - 1):
        out.append(torch.remainder(cur, _LIMB_BASE))
        cur = torch.div(cur, _LIMB_BASE, rounding_mode="floor")
    out.append(cur)
    return out


def _reduce_wide_sum(in_t, cols, sortg, ids, cap, raw, group_valid) -> list[ColumnVal]:
    """Base-1e9 limb sums of a wide decimal sum (reference ``agg_exec.py:
    1853``): exact below ~9.2e9 rows a group."""
    k = _n_limbs(sum_type(in_t).precision)
    if raw:
        v, m = sortg(cols[0])
        limbs = limb_rows(ColumnVal(v, m, in_t, cols[0].dict), m, in_t, k)
        masks = [m] * k
    else:
        limbs, masks = [], []
        for i in range(k):
            v, m = sortg(cols[i])
            limbs.append(v.to(torch.int64))
            masks.append(m)
    out = []
    any_valid = None
    for i, (lv, m) in enumerate(zip(limbs, masks)):
        sm, av = S.seg_sum(torch.where(m, lv, torch.zeros_like(lv)), m, ids, cap)
        any_valid = av if any_valid is None else any_valid
        out.append(ColumnVal(sm, any_valid & group_valid,
                             T.decimal(18, in_t.scale) if i == 0 else T.INT64))
    return out


def _final_one(a: AggExpr, in_t, cols: list[ColumnVal]) -> ColumnVal:
    if a.func == "host_udaf":
        return _final_udaf(a.udaf, cols[0])
    if a.func in ("count", "count_star"):
        return ColumnVal(cols[0].values, torch.ones_like(cols[0].validity), T.INT64)
    if a.func in ("sum", "avg") and is_wide_sum(in_t):
        return _final_wide(a, in_t, cols)
    if a.func == "sum":
        st = sum_type(in_t)
        if st.kind == T.TypeKind.DECIMAL:
            ok = D.precision_ok(cols[0].values, st.precision)
            return ColumnVal(cols[0].values, cols[0].validity & ok, st)
        return cols[0]
    if a.func == "avg":
        sm, cnt = cols
        nz = cnt.values > 0
        at = avg_type(in_t)
        if at.kind == T.TypeKind.DECIMAL:
            v, ok = D.div(sm.values, sum_type(in_t).scale, cnt.values, 0, at.precision, at.scale)
            return ColumnVal(v, sm.validity & nz & ok, at)
        v = sm.values.to(torch.float64) / torch.where(nz, cnt.values, torch.ones_like(cnt.values))
        return ColumnVal(v, sm.validity & nz, T.FLOAT64)
    return cols[0]  # min, max, first


def rebuild_wide(limbs: list, ok: np.ndarray, cnt: np.ndarray | None, in_t: T.DataType,
                 avg: bool) -> tuple[T.DataType, list]:
    """Exact sums (or HALF_UP averages) from host limb sums: (result type,
    per row the unscaled result or None). The host half of ``_final_wide``
    and of the window's wide sums."""
    import decimal as pydec

    st = sum_type(in_t)
    total = np.zeros(len(ok), dtype=object)
    base = 1
    for limb in limbs:
        total = total + limb.astype(object) * base
        base *= _LIMB_BASE
    if not avg:
        emit_t, unscaled = st, [int(u) for u in total]
    else:
        emit_t = avg_type(in_t)
        ok = ok & (cnt > 0)
        diff = emit_t.scale - st.scale
        num_shift, den_shift = 10 ** max(diff, 0), 10 ** max(-diff, 0)
        unscaled = [0] * len(ok)
        with pydec.localcontext() as hp:
            hp.prec = 100
            for i in np.flatnonzero(ok):
                unscaled[i] = int((pydec.Decimal(int(total[i]) * num_shift)
                                   / pydec.Decimal(int(cnt[i]) * den_shift)).quantize(
                                       pydec.Decimal(1), rounding=pydec.ROUND_HALF_UP))
    bound = 10 ** (emit_t.precision if emit_t.is_wide_decimal else min(emit_t.precision, 18))
    return emit_t, [u if o and -bound < u < bound else None for u, o in zip(unscaled, ok)]


def emit_decimal(emit_t: T.DataType, unscaled: list, valid: torch.Tensor) -> ColumnVal:
    """Host results as a column on ``valid``'s device: a wide type as a
    vocabulary with identity codes, a decimal64 as int64 values."""
    dev = valid.device
    ok = torch.from_numpy(np.array([u is not None for u in unscaled], dtype=bool)).to(dev)
    if emit_t.is_wide_decimal:
        d = np.empty(max(len(unscaled), 1), dtype=object)
        d[:] = [T.decimal_from_unscaled(u if u is not None else 0, emit_t.scale)
                for u in unscaled] or [T.decimal_from_unscaled(0, emit_t.scale)]
        codes = torch.arange(len(unscaled), dtype=torch.int32, device=dev)
        return ColumnVal(codes, ok & valid, emit_t, d)
    vals = np.array([u if u is not None else 0 for u in unscaled], dtype=np.int64)
    return ColumnVal(torch.from_numpy(vals).to(dev), ok & valid, emit_t)


def _final_wide(a: AggExpr, in_t, cols: list[ColumnVal]) -> ColumnVal:
    """Exact wide sums (or averages) from the limb sums (reference
    ``agg_exec.py:1346``): one host read of the limbs, Python ints there;
    a wide result is a vocabulary with identity codes, a narrow one an
    int64 plane, and a total past the result's precision is NULL."""
    k = _n_limbs(sum_type(in_t).precision)
    limbs = [c.values.cpu().numpy() for c in cols[:k]]
    ok = cols[0].validity.cpu().numpy()
    cnt = cols[k].values.cpu().numpy() if a.func == "avg" else None
    emit_t, unscaled = rebuild_wide(limbs, ok, cnt, in_t, a.func == "avg")
    return emit_decimal(emit_t, unscaled, cols[0].validity)


# ---------------------------------------------------------------------------
# dense direct-address aggregation (integer keys, small range)
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def dense_fold_planes(funcs: tuple, raw: bool, keys, per_agg, sel, geom, n_keys: int,
                      guard: bool):
    """The dense fold's per-batch arithmetic, before its scatters: (flag,
    slot index, present plane, per-aggregate planes). ``geom`` is the
    anchor's geometry tensor (``_DenseAggState._publish``). With ``guard``
    a live key outside the table clears the 0-d ``flag`` and every row's
    slot goes to the dead slot. A fused stage runs this same function in its
    program (``plan/fusion.py``)."""
    dev = sel.device
    flag = torch.ones((), dtype=torch.bool, device=dev)
    if guard:
        for i, k in enumerate(keys):
            v = k.values.to(torch.int64)
            outside = sel & k.validity & ((v < geom[4 * i]) | (v > geom[4 * i + 1]))
            flag = flag & ~outside.any()
        sel = sel & flag
    idx = torch.zeros(sel.shape, dtype=torch.int64, device=dev)
    for i, k in enumerate(keys):
        off = torch.minimum((k.values.to(torch.int64) - geom[4 * i] + 1).clamp(min=1),
                            geom[4 * i + 2])
        idx = idx + torch.where(k.validity, off, torch.zeros_like(off)) * geom[4 * i + 3]
    size = geom[4 * n_keys]
    idx = torch.where(sel, torch.minimum(idx.clamp(min=0), size - 1), size)
    planes = []
    for f, ins in zip(funcs, per_agg):
        if f in ("count", "count_star"):
            if not raw:
                c = ins[0].values.to(torch.int64)
            elif f == "count_star":
                c = torch.ones_like(idx)
            else:
                c = ins[0].validity.to(torch.int64)
            planes.append(torch.where(sel, c, torch.zeros_like(c)))
            continue
        v, m = ins[0].values, ins[0].validity
        ok = m & sel
        if f in ("sum", "avg"):
            planes.append(torch.where(ok, v, torch.zeros_like(v)))
        else:
            ident = (S.max_identity if f == "min" else S.min_identity)(v.dtype)
            planes.append(torch.where(ok, v, torch.full_like(v, ident)))
        planes.append(ok.to(torch.int32))
        if f == "avg":
            c = ok.to(torch.int64) if raw else ins[1].values.to(torch.int64)
            planes.append(torch.where(sel, c, torch.zeros_like(c)))
    return flag, idx, sel.to(torch.int32), planes


class _DenseAggState:
    """Dense table for 1-3 packed integer keys. Slot layout: per key,
    offset 0 is its NULL lane and 1..dim-1 its values (base .. base+dim-2);
    slot = sum(offset_i * stride_i). One trailing slot swallows dead rows.

    The anchored fold checks the batch's key ranges on the device and folds
    all or nothing (reference ``agg_exec.py:2247-2320``): its in-range flag
    rides the transfer window and is harvested ``depth`` batches later, so
    the steady state makes no blocking read. A fold that turns out to have
    been a no-op sends its batch back ("restart": drain, re-anchor on the
    union range, fold again). The anchor reads the batch's ranges (the
    first batch and each re-anchor)."""

    LIMIT = 1 << 21  # max slots (product of per-key dims)

    def __init__(self, exec_: HashAggExec, ctx: ExecutionContext):
        self.name = f"dense-agg-{id(exec_):x}"
        self.exec = exec_
        self.metrics = ctx.metrics
        self.bases: list[int] | None = None
        self.dims: tuple[int, ...] | None = None
        self.size = 0
        self.vals: list | None = None
        self.valids: list | None = None
        self.present = None
        self._hint: list | None = None
        self._raw = exec_.mode == PARTIAL
        self._depth = max(1, ctx.conf.get(TRANSFER_WINDOW_DEPTH))
        #: (batch, transfer of its fold flag), oldest first
        self._pending: deque = deque()
        self._pending_bytes = 0
        #: batches whose deferred fold was a no-op, to fold again
        self._retry: list = []
        self.geom = None
        #: anchors published so far; a stage-prepped batch carries the
        #: epoch its planes were computed under
        self.epoch = 0
        self._link = getattr(exec_, "_dense_prep_link", None)

    def mem_used(self) -> int:
        # the manager polls from other tasks' threads while this one resets
        # or allocates the table: one read of each attribute
        held = self._pending_bytes
        vals, valids, present = self.vals, self.valids, self.present
        if vals is None or valids is None or present is None:
            return held
        return (held + present.numel() * 4
                + sum(v.numel() * v.element_size() for v in list(vals))
                + sum(m.numel() * 4 for m in list(valids) if m is not None))

    def spill(self) -> int:
        return 0  # unspillable (fixed footprint); drained at stream end

    def release(self) -> None:
        self.vals = self.valids = self.present = None
        if self._link is not None:
            self._link.clear()
        self._pending.clear()
        self._pending_bytes = 0
        self._retry = []

    def reset(self) -> None:
        """Forget the table after a drain; its covered range survives as a
        hint so the re-anchor pads the union of old and new ranges."""
        if self.bases is not None:
            self._hint = [((b, b + d - 2) if d > 1 else None)
                          for b, d in zip(self.bases, self.dims)]
        self.bases = self.dims = self.geom = None
        self.size = 0
        self.vals = self.valids = self.present = None
        if self._link is not None:
            self._link.clear()

    def _pop_pending(self):
        b, tr = self._pending.popleft()
        self._pending_bytes -= batch_nbytes(b)
        (ok,) = harvest(tr, self.metrics)
        return b, bool(ok)

    def finish_pending(self) -> list:
        """Resolve every fold in flight; the batches that did not fold."""
        failed = []
        while self._pending:
            b, ok = self._pop_pending()
            if not ok:
                failed.append(b)
        return failed

    def take_retry(self) -> list:
        """The batches to fold again (after a drain and reset) or to route
        to the generic path, the folds still in flight resolved first."""
        self._retry.extend(self.finish_pending())
        r, self._retry = self._retry, []
        return r

    def reset_with_retry(self) -> list:
        r = self.take_retry()
        self.reset()
        return r

    def _anchor(self, mins, maxs) -> bool:
        """Verbatim policy of auron_tpu _DenseAggState._anchor_from_stats."""
        spans = []
        for i, (mn, mx) in enumerate(zip(mins, maxs)):
            hint = self._hint[i] if self._hint is not None else None
            if mn > mx:
                if hint is None:
                    spans.append((0, 0))
                    continue
                mn, mx = hint
            elif hint is not None:
                mn, mx = min(mn, hint[0]), max(mx, hint[1])
            spans.append((mn, mx - mn + 1))
        pads = [(1 if s == 0 else max(_next_pow2(2 * (s + 1)), 4)) for _, s in spans]
        exact = [s + 1 for _, s in spans]

        def product(ds):
            t = 1
            for d in ds:
                t *= d
            return t

        while product(pads) > self.LIMIT and pads != exact:
            i = max(range(len(pads)), key=lambda i: pads[i] / exact[i])
            pads[i] = exact[i] if pads[i] // 2 < exact[i] else pads[i] // 2
        if product(pads) > self.LIMIT:
            return False
        self.bases = [max(mn - (d - (s + 1)) // 2, -(1 << 63)) for (mn, s), d in zip(spans, pads)]
        self.dims = tuple(pads)
        self.size = bucket_capacity(product(pads))
        return True

    def _publish(self, device) -> None:
        """The anchor's geometry as one int64 tensor (per key: base, highest
        value, last offset, stride; then the table size), published to the
        fused stage feeding this aggregate (``plan/fusion.DensePrepLink``):
        its program takes the geometry as an input, so a re-anchor needs no
        new capture."""
        geom, stride = [], 1
        for base, d in zip(self.bases, self.dims):
            geom += [base, min(base + d - 2, (1 << 63) - 1), max(d - 1, 1), stride]
            stride *= d
        self.geom = torch.tensor(geom + [self.size], dtype=torch.int64, device=device)
        self.epoch += 1
        if self._link is not None:
            self._link.publish(epoch=self.epoch, geom=self.geom)

    def _alloc(self, device) -> None:
        ex = self.exec
        self.vals, self.valids = [], []
        for (a, _), in_t in zip(ex.aggs, ex._agg_input_types):
            for f in intermediate_fields(a, in_t or T.INT64, "x"):
                dt = f.dtype.physical_dtype()
                if f.name.endswith("#min"):
                    fill = S.max_identity(dt)
                elif f.name.endswith("#max"):
                    fill = S.min_identity(dt)
                else:
                    fill = 0
                self.vals.append(torch.full((self.size + 1,), fill, dtype=dt, device=device))
                self.valids.append(
                    torch.zeros(self.size + 1, dtype=torch.int32, device=device)
                    if f.nullable else None)
        self.present = torch.zeros(self.size + 1, dtype=torch.int32, device=device)

    def update(self, b: Batch, defer: bool = True):
        """Fold one batch: True (folded, or its fold in flight), "restart"
        (a fold fell outside the anchored table: the caller drains, resets
        and folds ``take_retry()`` and this batch again) or False (the
        union range can never fit: fall back for good)."""
        if defer and len(self._pending) >= self._depth:
            b0, ok0 = self._pop_pending()
            if not ok0:
                self._retry.append(b0)
                return "restart"
        elif not defer:
            failed = self.finish_pending()
            if failed:
                self._retry.extend(failed)
                return "restart"
        sel = b.device.sel
        prep = getattr(b, "_dense_prep", None)
        if self.bases is not None and prep is not None and prep.epoch == self.epoch:
            # the stage program computed this fold's planes under the
            # current anchor: only the scatters are left
            self._scatter(prep.idx, prep.present, prep.planes)
            flag = prep.flag
        elif self.bases is not None:
            keys, per_agg = self.exec._keys_and_inputs(b)
            flag = self._fold(keys, per_agg, sel, guard=True)
        if self.bases is not None:
            if defer:
                self._pending.append((b, start_host_transfer(flag)))
                self._pending_bytes += batch_nbytes(b)
                return True
            (ok,) = blocking_read(self.metrics, flag)
            # a no-op fold: the caller folds this batch again after the reset
            return True if bool(ok) else "restart"
        keys, per_agg = self.exec._keys_and_inputs(b)
        imax, imin = torch.iinfo(torch.int64).max, torch.iinfo(torch.int64).min
        parts = [sel.sum()]
        for k in keys:
            ok = sel & k.validity
            v = k.values.to(torch.int64)
            parts += [torch.where(ok, v, torch.full_like(v, imax)).min(),
                      torch.where(ok, v, torch.full_like(v, imin)).max()]
        (stats,) = blocking_read(self.metrics, torch.stack(parts))
        stats = stats.tolist()
        if stats[0] == 0:
            return True
        if not self._anchor(stats[1::2], stats[2::2]):
            return False
        self._alloc(sel.device)
        self._publish(sel.device)
        self._fold(keys, per_agg, sel)
        return True

    def _fold(self, keys, per_agg, sel, guard: bool = False):
        """Scatter one batch into the table. With ``guard`` the fold is all
        or nothing: a live key outside the table makes it a no-op, and the
        returned device flag says whether it folded."""
        flag, idx, present, planes = dense_fold_planes(
            tuple(a.func for a, _ in self.exec.aggs), self._raw, keys, per_agg, sel, self.geom,
            self.exec.n_keys, guard)
        self._scatter(idx, present, planes)
        return flag

    def _scatter(self, idx, present, planes) -> None:
        """The fold's scatter reductions of ``dense_fold_planes``' planes."""
        self.present.scatter_reduce_(0, idx, present, "amax")
        fi = pi = 0
        for a, _ in self.exec.aggs:
            f = a.func
            if f in ("count", "count_star"):
                S.add_at_(self.vals[fi], idx, planes[pi])
                fi, pi = fi + 1, pi + 1
                continue
            if f in ("sum", "avg"):
                S.add_at_(self.vals[fi], idx, planes[pi])
            else:
                self.vals[fi].scatter_reduce_(0, idx, planes[pi], "amin" if f == "min" else "amax")
            self.valids[fi].scatter_reduce_(0, idx, planes[pi + 1], "amax")
            fi, pi = fi + 1, pi + 2
            if f == "avg":
                S.add_at_(self.vals[fi], idx, planes[pi])
                fi, pi = fi + 1, pi + 1

    def state_batch(self) -> Batch | None:
        """The table as an intermediate batch compacted to its group bucket."""
        if self.bases is None:
            return None
        ex = self.exec
        size = self.size
        present = self.present[:size] > 0
        (g,) = blocking_read(self.metrics, present.sum())
        g = int(g)
        if g == 0:
            return None
        slot = torch.arange(size, dtype=torch.int64, device=present.device)
        cols = []
        stride = 1
        for i in range(ex.n_keys):
            f = ex.inter_schema[i]
            coord = (slot // stride) % self.dims[i]
            vals = (coord - 1 + self.bases[i]).to(f.dtype.physical_dtype())
            cols.append(ColumnVal(vals, present & (coord > 0), f.dtype))
            stride *= self.dims[i]
        for fi, f in enumerate(ex.inter_schema.fields[ex.n_keys:]):
            m = self.valids[fi]
            valid = present & (m[:size] > 0) if m is not None else present
            cols.append(ColumnVal(self.vals[fi][:size], valid, f.dtype))
        out = batch_from_columns(cols, ex.inter_schema.names, present)
        return compact_batch(Batch(ex.inter_schema, out.device, out.dicts), bucket_capacity(g))
