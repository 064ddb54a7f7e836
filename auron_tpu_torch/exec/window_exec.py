"""Window exec (port of ``auron_tpu/exec/window_exec.py``).

One global sort of the partition's rows by (liveness, partition words,
order words, iota) — on a CUDA tensor the bitonic kernels K3/K4 through
``bitonic.ordered_sort``, under the policy SortExec uses — then every
function is O(n) segment arithmetic over the sorted rows:

- partition and peer boundaries are adjacent-word compares;
- row_number/rank/dense_rank/percent_rank/cume_dist/ntile come from
  cumulative sums rebased at the partition start;
- lead/lag/nth_value are shifted or based gathers guarded by the partition
  bounds;
- running aggregates (the default RANGE UNBOUNDED PRECEDING .. CURRENT ROW
  frame: peers share a value) are prefix sums rebased at the partition
  start, read at the peer group's end; running min/max is a segmented scan
  (``segments.seg_running_extreme``); whole-partition aggregates are
  segment reductions gathered back.

Output keeps the sorted row order and leaves in ``bucket_capacity(batch
size)`` chunks. A decimal64 sum is an int64 prefix sum (an average divides
by ``decimal_math.div``, HALF_UP); a sum wider than 18 digits runs the
aggregate's base-1e9 limbs through the same frames and rebuilds each row's
exact value on the host (reference ``window_exec.py:346-456``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch, DeviceBatch, bucket_capacity, device_concat
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.basic import batch_from_columns
from auron_tpu_torch.exprs import decimal_math as D
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import ColumnVal, Evaluator
from auron_tpu_torch.ops import bitonic
from auron_tpu_torch.ops import segments as S
from auron_tpu_torch.ops.sortkeys import SortSpec, dict_rank_maps, narrow_flags, sort_operands

RANK_FUNCS = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile")
SHIFT_FUNCS = ("lead", "lag", "nth_value")
AGG_FUNCS = ("sum", "count", "min", "max", "avg")

_I32_MAX = 2**31 - 1


@dataclass(frozen=True)
class WindowFunc:
    kind: str  # one of RANK_FUNCS | SHIFT_FUNCS | "agg"
    agg: str | None = None  # for kind == "agg"
    expr: ir.Expr | None = None
    offset: int = 1  # lead/lag distance, nth_value n, ntile buckets
    frame_whole: bool = False  # agg over the whole partition vs running

    def out_dtype(self, in_dtype: T.DataType | None) -> T.DataType:
        if self.kind in ("row_number", "rank", "dense_rank", "ntile"):
            return T.INT32
        if self.kind in ("percent_rank", "cume_dist"):
            return T.FLOAT64
        if self.kind in SHIFT_FUNCS:
            return in_dtype
        if self.kind == "agg":
            from auron_tpu_torch.exec.agg_exec import avg_type, sum_type

            if self.agg == "count":
                return T.INT64
            if self.agg == "sum":
                return sum_type(in_dtype)
            if self.agg == "avg":
                return avg_type(in_dtype)
            return in_dtype
        raise ValueError(self.kind)


class WindowGroupLimitExec(ExecOperator):
    """Rows whose rank within (partition_by, order_by) is <= ``limit``: one
    window sort and rank, then a selection-mask refinement."""

    def __init__(self, child: ExecOperator, partition_by: list[ir.Expr],
                 order_by: list[tuple[ir.Expr, SortSpec]], limit: int,
                 rank_like: str = "row_number"):
        assert rank_like in ("row_number", "rank", "dense_rank")
        super().__init__([child], child.schema)
        self._win = WindowExec(child, partition_by, order_by, [(WindowFunc(rank_like), "__rk")])
        self.limit = limit

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        for b in self._win.execute(partition, ctx):
            rk_i = len(b.schema) - 1
            keep = b.device.sel & (b.col_values(rk_i) <= self.limit)
            dev = DeviceBatch(keep, b.device.values[:rk_i], b.device.validity[:rk_i])
            yield Batch(self.schema, dev, b.dicts[:rk_i])


class _Frame:
    """Partition and peer-group geometry of the sorted rows (all int64)."""

    def __init__(self, sel: torch.Tensor, pw_sorted: list, ow_sorted: list):
        cap = sel.shape[0]
        dev = sel.device
        self.cap, self.sel = cap, sel
        self.iota = torch.arange(cap, dtype=torch.int64, device=dev)
        part_diff = torch.zeros(cap, dtype=torch.bool, device=dev)
        part_diff[0] = True
        for w in pw_sorted:
            part_diff[1:] |= w[1:] != w[:-1]
        peer_diff = part_diff.clone()
        for w in ow_sorted:
            peer_diff[1:] |= w[1:] != w[:-1]
        self.seg_ids = self._ids(part_diff & sel)
        seg_start, seg_len = self._starts_and_lengths(self.seg_ids)
        sid = self.clip(self.seg_ids)
        self.seg_start = seg_start[sid]  # my partition's first sorted row
        self.n_part = seg_len[sid]
        self.pos = self.iota - self.seg_start  # 0-based position in the partition
        peer_ids = self._ids(peer_diff & sel)
        peer_start, peer_len = self._starts_and_lengths(peer_ids)
        pid = self.clip(peer_ids)
        self.peer_start = peer_start[pid]
        self.peer_end = self.peer_start + peer_len[pid]  # exclusive

    def clip(self, idx: torch.Tensor) -> torch.Tensor:
        return idx.clamp(0, self.cap - 1)

    def _ids(self, boundary: torch.Tensor) -> torch.Tensor:
        ids = torch.cumsum(boundary.to(torch.int64), 0) - 1
        return torch.where(self.sel, ids, torch.full_like(ids, self.cap))

    def _starts_and_lengths(self, ids: torch.Tensor):
        """First sorted row (INT32_MAX for an empty segment, as
        ``jax.ops.segment_min``'s identity) and live rows of segments
        0..cap-1; the overflow slot ``cap`` takes the dead rows."""
        start = torch.full((self.cap + 1,), _I32_MAX, dtype=torch.int64, device=ids.device)
        start.scatter_reduce_(0, ids, self.iota, "amin", include_self=True)
        length = S.seg_count(self.sel, ids, self.cap)
        return start[:self.cap], length

    def prefix_at_peer_end(self, vals: torch.Tensor) -> torch.Tensor:
        """Running sum of ``vals`` from the partition start to the end of
        the row's peer group: a global cumsum rebased at the partition
        start (the reference's algorithm)."""
        cum = torch.cumsum(vals, 0)
        base = torch.where(self.seg_start > 0, cum[self.clip(self.seg_start - 1)],
                           torch.zeros_like(cum))
        return cum[self.clip(self.peer_end - 1)] - base

    def whole(self, vals: torch.Tensor) -> torch.Tensor:
        """Sum of ``vals`` over the row's partition."""
        tot = torch.zeros(self.cap + 1, dtype=vals.dtype, device=vals.device)
        S.add_at_(tot, self.seg_ids, vals)
        return tot[self.clip(self.seg_ids)]


class WindowExec(ExecOperator):
    def __init__(self, child: ExecOperator, partition_by: list[ir.Expr],
                 order_by: list[tuple[ir.Expr, SortSpec]], funcs: list[tuple[WindowFunc, str]]):
        self.partition_by = partition_by
        self.order_by = order_by
        self.funcs = funcs
        fields = list(child.schema.fields)
        for wf, name in funcs:
            in_t = wf.expr.dtype_of(child.schema) if wf.expr is not None else None
            fields.append(T.Field(name, wf.out_dtype(in_t), True))
        super().__init__([child], T.Schema(tuple(fields)))

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        batches = list(self.child_stream(0, partition, ctx))
        if not batches:
            return
        big = device_concat(batches)
        del batches
        if big.num_rows() == 0:
            return
        ev = Evaluator(self.children[0].schema, partition_id=ctx.partition_id,
                       resources=ctx.resources)
        with ctx.metrics.timer("sort_time"):
            order, sel, pw_sorted, ow_sorted = self._sort(big, ev, ctx)
        with ctx.metrics.timer("elapsed_compute"):
            fr = _Frame(sel, pw_sorted, ow_sorted)
            del pw_sorted, ow_sorted
            dev = big.device
            cols = [ColumnVal(dev.values[i][order], dev.validity[i][order], f.dtype, big.dicts[i])
                    for i, f in enumerate(big.schema)]
            for wf, _ in self.funcs:
                cv = None
                if wf.expr is not None:
                    c0 = ev.evaluate(big, [wf.expr])[0]
                    cv = ColumnVal(c0.values[order], c0.validity[order] & sel, c0.dtype, c0.dict)
                cols.append(self._compute(wf, cv, fr))
            out = batch_from_columns(cols, self.schema.names, sel)
        whole = Batch(self.schema, out.device, out.dicts)
        n = int(sel.sum())  # one host read: the live count, for chunked emission
        chunk = bucket_capacity(ctx.batch_size())
        if n <= chunk:
            yield whole
            return
        d = whole.device
        for start in range(0, n, chunk):
            sl = slice(start, start + chunk)
            yield Batch(self.schema, DeviceBatch(_padded(d.sel[sl], chunk),
                                                 tuple(_padded(v[sl], chunk) for v in d.values),
                                                 tuple(_padded(m[sl], chunk) for m in d.validity)),
                        whole.dicts)

    def _sort(self, big: Batch, ev: Evaluator, ctx: ExecutionContext):
        """(order, sel, partition words, order words), all in sorted order."""
        pvals = ev.evaluate(big, self.partition_by) if self.partition_by else []
        pwords = S.key_words(pvals) if pvals else []
        ovals = [ev.evaluate(big, [e])[0] for e, _ in self.order_by]
        owords = sort_operands(ovals, [s for _, s in self.order_by]) if ovals else []
        cap = big.capacity
        live = torch.where(big.device.sel, 0, 1).to(torch.int64)
        iota = torch.arange(cap, dtype=torch.int32, device=live.device)
        # key_words: one equality word per partition column, then a
        # null-bits word whose hi half is zero for <= 32 columns
        p_narrow = ((False,) * (len(pwords) - 1) + (len(pvals) <= 32,)) if pwords else ()
        sorted_ops = bitonic.ordered_sort((live, *pwords, *owords, iota),
                                          word_narrow=p_narrow + narrow_flags(len(owords) // 2),
                                          conf=ctx.conf)
        n_pw = len(pwords)
        return (sorted_ops[-1].long(), sorted_ops[0] == 0, list(sorted_ops[1:1 + n_pw]),
                list(sorted_ops[1 + n_pw:-1]))

    # ------------------------------------------------------------------

    def _compute(self, wf: WindowFunc, cv: ColumnVal | None, fr: _Frame) -> ColumnVal:
        sel = fr.sel
        if wf.kind == "row_number":
            return ColumnVal((fr.pos + 1).to(torch.int32), sel, T.INT32)
        if wf.kind == "rank":
            return ColumnVal((fr.peer_start - fr.seg_start + 1).to(torch.int32), sel, T.INT32)
        if wf.kind == "dense_rank":
            # peer groups at or before mine within my partition
            peer_cum = torch.cumsum((fr.peer_start == fr.iota).to(torch.int64), 0)
            dense = peer_cum - peer_cum[fr.clip(fr.seg_start)] + 1
            return ColumnVal(dense.to(torch.int32), sel, T.INT32)
        if wf.kind == "percent_rank":
            rank0 = (fr.peer_start - fr.seg_start).to(torch.float64)
            denom = (fr.n_part - 1).clamp(min=1).to(torch.float64)
            v = torch.where(fr.n_part > 1, rank0 / denom, torch.zeros_like(rank0))
            return ColumnVal(v, sel, T.FLOAT64)
        if wf.kind == "cume_dist":
            covered = (fr.peer_end - fr.seg_start).to(torch.float64)
            return ColumnVal(covered / fr.n_part.clamp(min=1), sel, T.FLOAT64)
        if wf.kind == "ntile":
            # Spark ntile(n): the first (n_part % n) buckets get one extra
            # row; with fewer rows than buckets every row is its own bucket
            size = torch.div(fr.n_part, wf.offset, rounding_mode="floor")
            big = fr.n_part - size * wf.offset
            cut = big * (size + 1)
            p = fr.pos
            tile = torch.where(p < cut, torch.div(p, size + 1, rounding_mode="floor"),
                               big + torch.div(p - cut, size.clamp(min=1), rounding_mode="floor"))
            return ColumnVal((tile + 1).to(torch.int32), sel, T.INT32)
        if wf.kind in ("lead", "lag"):
            k = wf.offset if wf.kind == "lead" else -wf.offset
            in_bounds = (fr.pos + k >= 0) & (fr.pos + k < fr.n_part)
            src = fr.clip(fr.iota + k)
            return ColumnVal(cv.values[src], cv.validity[src] & in_bounds & sel, cv.dtype,
                             cv.dict)
        if wf.kind == "nth_value":
            src = fr.clip(fr.seg_start + (wf.offset - 1))
            in_bounds = (wf.offset - 1) < fr.n_part
            # default RANGE frame: the nth row is visible once the row's
            # peer group's frame end covers it (peers share visibility)
            visible = (fr.peer_end - fr.seg_start) >= wf.offset
            return ColumnVal(cv.values[src], cv.validity[src] & in_bounds & visible & sel,
                             cv.dtype, cv.dict)
        assert wf.kind == "agg", wf.kind
        if wf.agg in ("min", "max"):
            return self._agg_minmax(wf, cv, fr)
        return self._agg_sum(wf, cv, fr)

    def _agg_sum(self, wf: WindowFunc, cv: ColumnVal, fr: _Frame) -> ColumnVal:
        from auron_tpu_torch.exec.agg_exec import avg_type, is_wide_sum, sum_type

        sel = fr.sel
        valid = cv.validity & sel
        frame = fr.whole if wf.frame_whole else fr.prefix_at_peer_end
        cnt = frame(valid.to(torch.int64))
        if wf.agg == "count":
            return ColumnVal(cnt, sel, T.INT64)
        if is_wide_sum(cv.dtype):
            return self._agg_wide(wf, cv, valid, cnt, frame, fr)
        in_sum_t = sum_type(cv.dtype)
        cvs = Evaluator(T.Schema())._cast(cv, in_sum_t)
        s = frame(torch.where(valid, cvs.values, torch.zeros_like(cvs.values)))
        any_valid = cnt > 0
        if wf.agg == "sum":
            return ColumnVal(s, any_valid & sel, in_sum_t)
        at = avg_type(cv.dtype)
        if at.kind == T.TypeKind.DECIMAL:
            v, ok = D.div(s, in_sum_t.scale, cnt, 0, at.precision, at.scale)
            return ColumnVal(v, any_valid & ok & sel, at)
        v = s.to(torch.float64) / torch.where(any_valid, cnt, torch.ones_like(cnt))
        return ColumnVal(v, any_valid & sel, at)

    def _agg_wide(self, wf: WindowFunc, cv: ColumnVal, valid, cnt, frame, fr: _Frame):
        """Exact windowed sum/avg of a wide decimal sum: the limbs' frame
        sums on the device, one host read, each row's value rebuilt there
        (windows emit a value per row)."""
        from auron_tpu_torch.exec.agg_exec import (
            _n_limbs, emit_decimal, limb_rows, rebuild_wide, sum_type,
        )

        k = _n_limbs(sum_type(cv.dtype).precision)
        sums = [frame(torch.where(valid, lr, torch.zeros_like(lr)))
                for lr in limb_rows(cv, valid, cv.dtype, k)]
        host = torch.stack(sums + [cnt, fr.sel.to(torch.int64)]).cpu().numpy()
        cnt_h = host[k]
        ok = (cnt_h > 0) & (host[k + 1] > 0)
        emit_t, unscaled = rebuild_wide(list(host[:k]), ok, cnt_h, cv.dtype, wf.agg == "avg")
        return emit_decimal(emit_t, unscaled, fr.sel)

    def _agg_minmax(self, wf: WindowFunc, cv: ColumnVal, fr: _Frame) -> ColumnVal:
        """min/max in an order key of the value (``segments.extreme_key``:
        dictionary codes by their string's rank, floats by their total
        order with -0.0 below 0.0), so that ties and signed zeros resolve
        as ``jnp.minimum``/``jnp.maximum`` do; a NaN in the frame makes
        the result NaN, as they propagate it; a running float result of
        zero is +0.0, as the reference's scan returns it."""
        sel = fr.sel
        valid = cv.validity & sel
        inv = None
        if cv.dtype.is_dict_encoded:
            rank, inv = (torch.from_numpy(t).to(cv.values.device)
                         for t in dict_rank_maps(cv.dict))
            key = rank[cv.values.long().clamp(0, len(rank) - 1)]
        else:
            key = S.extreme_key(cv.values)
        reduce = "amin" if wf.agg == "min" else "amax"
        ident = torch.iinfo(torch.int64).max if wf.agg == "min" else torch.iinfo(torch.int64).min
        masked = torch.where(valid, key, torch.full_like(key, ident))
        nan = valid & torch.isnan(cv.values) if cv.dtype.is_float else None
        if wf.frame_whole:
            red = torch.full((fr.cap + 1,), ident, dtype=torch.int64, device=key.device)
            red.scatter_reduce_(0, fr.seg_ids, masked, reduce, include_self=True)
            got = red[fr.clip(fr.seg_ids)]
            any_valid = fr.whole(valid.to(torch.int64)) > 0
            any_nan = fr.whole(nan.to(torch.int64)) > 0 if nan is not None else None
        else:
            scanned = S.seg_running_extreme(masked, fr.seg_start, reduce)
            got = scanned[fr.clip(fr.peer_end - 1)]
            any_valid = fr.prefix_at_peer_end(valid.to(torch.int64)) > 0
            any_nan = fr.prefix_at_peer_end(nan.to(torch.int64)) > 0 if nan is not None else None
        if inv is not None:
            values = inv[got.clamp(0, len(inv) - 1)].to(cv.values.dtype)
        else:
            values = S.from_extreme_key(got, cv.values.dtype)
        if any_nan is not None:
            values = torch.where(any_nan, torch.full_like(values, float("nan")), values)
            if not wf.frame_whole:
                # the reference's associative scan interleaves its halves by
                # adding zero-padded arrays, so a running zero leaves it as
                # +0.0; adding 0.0 does the same here
                values = values + 0.0
        return ColumnVal(values, any_valid & sel, cv.dtype, cv.dict)


def _padded(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.shape[0] == n:
        return t
    return torch.cat([t, torch.zeros(n - t.shape[0], dtype=t.dtype, device=t.device)])
