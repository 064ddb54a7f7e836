"""Equi-join driver (port of ``auron_tpu/exec/joins/driver.py``): runs one
prepared build side against a stream of probe batches, for every join type
(inner, left, right, full, left_semi, left_anti, existence) with the build
on either side. Output columns are (left ++ right), the left side's alone
for semi/anti, and the left side's plus a non-null bool ``exists_col`` for
existence, subset by the optional column-pruning ``projection``.

The type x side matrix (reference ``driver.py:105-120``): pairs are emitted
for inner/left/right/full; the probe side keeps its unmatched rows
(``probe_outer``) for full, for left with the probe on the left and for
right with the probe on the right; the build side keeps them
(``build_outer``) in the mirrored cases; semi/anti/existence mark the probe
rows when the probe is the left input (``probe_mark``), else the build rows
(``build_mark``). Build-side completions come from ``finish(build)`` after
the probe stream, from ``PreparedBuild.matched``.

A unique build emits one batch per probe batch. With compaction on
(``join.compact.output``) and no residual condition, the output is
compacted into a capacity bucket before the build columns are gathered:
``UniqueProbePipeline`` (one per probe stream) predicts the bucket from an
EWMA of earlier live counts (``exec/selectivity.py``) and compacts on the
device (``compaction_index``); each batch's live count rides the transfer
window (``runtime/transfer.py``) and is harvested k batches later, before
the batch is emitted; a bucket that proves too small is re-taken from the
still-held device state (``sel_mispredicts``). The first batch of a stream
takes the one blocking seed read. Emissions lag dispatch by the window
depth; the exec drains them with ``finish_probe``. A duplicate-keyed build
expands pair chunks with one count read per probe batch.

A residual ``condition`` (over the combined left ++ right schema) is
evaluated over only the columns it references (``_reduced_condition``): on
the unique path over the probe rows and their one build match, otherwise
over each chunk of expanded pairs (``core.condition_pairs``). A pair whose
condition is false or NULL does not match, for the probe-side flags and
for the build-side marks alike.

Dictionary-encoded keys: every probe batch re-keys the build's and its own
key codes onto one joint vocabulary (``core.unify_key_dicts``) and probes
the sorted map by range, as the reference does (``driver.py:281-304``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch, compaction_bucket
from auron_tpu_torch.exec.basic import batch_from_columns
from auron_tpu_torch.exec.joins import core
from auron_tpu_torch.exec.joins.core import (
    EXISTENCE, FULL, INNER, LEFT, LEFT_ANTI, LEFT_SEMI, RIGHT,
)
from auron_tpu_torch.exec.selectivity import SelectivityPredictor, predictor_enabled
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import ColumnVal, Evaluator
from auron_tpu_torch.runtime.transfer import TransferWindow, blocking_read, tensor_bytes
from auron_tpu_torch.utils.config import JOIN_COMPACT_OUTPUT, TRANSFER_WINDOW_DEPTH, resolve_tri


def compact_join_output(conf) -> bool:
    """``join.compact.output``: auto = on (with the predictor, compaction
    costs no host read per batch on the card either)."""
    return resolve_tri(conf.get(JOIN_COMPACT_OUTPUT), True)


class UniqueProbePipeline:
    """Per-probe-stream state of the sync-free unique-join compaction
    boundary: the selectivity predictor and the k-deep transfer window
    (reference ``driver.py:42-64``). Owned by the exec (one per partition
    stream), passed into ``probe_batch``; the exec calls ``finish_probe``
    after the last probe batch and ``close`` on every path out. Reads are
    counted in ``metrics``: ``unique_streams`` (streams that reached the
    compaction boundary), ``blocking_reads`` (the seed read and repair
    reads), ``async_reads``, ``waited_reads`` (harvests that had to wait
    for the card), ``drain_waits`` and ``sel_mispredicts``."""

    def __init__(self, conf, metrics=None):
        self.pred = SelectivityPredictor(conf) if predictor_enabled(conf) else None
        self.window = TransferWindow(conf.get(TRANSFER_WINDOW_DEPTH), metrics)
        self.metrics = metrics
        self.started = False

    def close(self) -> None:
        """Drop every entry still in the window (a consumer stopped early)."""
        self.window.clear()


class EquiJoinDriver:
    def __init__(self, left_schema: T.Schema, right_schema: T.Schema,
                 left_keys: list[ir.Expr], right_keys: list[ir.Expr], join_type: str,
                 build_side: str, condition: ir.Expr | None = None,
                 exists_col: str = "exists", projection: list[int] | None = None):
        if join_type not in core.JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type!r}")
        if build_side not in ("left", "right"):
            raise ValueError(f"unknown build side {build_side!r}")
        self.left_schema, self.right_schema = left_schema, right_schema
        self.left_keys, self.right_keys = left_keys, right_keys
        self.join_type = join_type
        self.build_side = build_side
        self.condition = condition
        self.exists_col = exists_col
        full = core.join_output_schema(left_schema, right_schema, join_type, exists_col)
        self.projection = list(projection) if projection is not None else None
        proj = self.projection if self.projection is not None else range(len(full))
        self.out_schema = T.Schema(tuple(full[i] for i in proj))
        self.probe_is_left = build_side == "right"
        jt, pl = join_type, self.probe_is_left
        self.wants_pairs = jt in (INNER, LEFT, RIGHT, FULL)
        self.probe_outer = jt == FULL or (jt == LEFT and pl) or (jt == RIGHT and not pl)
        self.build_outer = jt == FULL or (jt == LEFT and not pl) or (jt == RIGHT and pl)
        # semi/anti/existence are defined on the LEFT input
        self.probe_mark = jt in (LEFT_SEMI, LEFT_ANTI, EXISTENCE) and pl
        self.build_mark = jt in (LEFT_SEMI, LEFT_ANTI, EXISTENCE) and not pl
        self._cond = self._reduced_condition(condition) if condition is not None else None

    def prepare(self, build_batches: list[Batch], device) -> core.PreparedBuild:
        schema = self.left_schema if self.build_side == "left" else self.right_schema
        keys = self.left_keys if self.build_side == "left" else self.right_keys
        # existence-only probes (probe-side semi/anti/existence with no
        # condition) never enumerate pairs: a duplicate-keyed build may stay
        # unsorted behind an existence table (reference driver.py:214-228)
        need_pairs = (self.wants_pairs or self._cond is not None or self.build_mark
                      or self.build_outer)
        return core.prepare_build(build_batches, keys, schema, device, need_pairs=need_pairs)

    @staticmethod
    def fresh(build: core.PreparedBuild) -> core.PreparedBuild:
        """The same prepared map with its own build-row marks (a cached
        build shared by several tasks)."""
        return dataclasses.replace(build, matched=torch.zeros_like(build.matched))

    def _reduced_condition(self, condition: ir.Expr):
        """(schema, expr, (on probe side, side column) per column) of the
        condition re-bound to only the columns it references."""
        comb = core.join_output_schema(self.left_schema, self.right_schema, core.INNER)
        refs = sorted({c.index for c in ir.walk(condition) if isinstance(c, ir.Column)})
        expr = ir.remap_columns(condition, {old: new for new, old in enumerate(refs)})
        nl = len(self.left_schema)
        side_col = [((r < nl) == self.probe_is_left, r if r < nl else r - nl) for r in refs]
        return T.Schema(tuple(comb.fields[r] for r in refs)), expr, side_col

    def _condition_holds(self, pb: Batch, bb: Batch, li, ri, ok):
        """``ok`` narrowed to the pairs (probe row ``li`` — None: in place —,
        build row ``ri``) whose condition is true."""
        schema, expr, side_col = self._cond
        cols = []
        for (on_probe, ci), f in zip(side_col, schema):
            src, idx = (pb, li) if on_probe else (bb, ri)
            v, m = src.col_values(ci), src.col_validity(ci)
            if idx is not None:
                v, m = v[idx], m[idx]
            cols.append(ColumnVal(v, m & ok, f.dtype, src.dicts[ci]))
        pair = batch_from_columns(cols, schema.names, ok)
        cv = Evaluator(schema).evaluate(Batch(schema, pair.device, pair.dicts), [expr])[0]
        return ok & cv.validity & cv.values.to(torch.bool)

    def _out_cols(self):
        """(on probe side, side column index) per output column of a pair."""
        nl = len(self.left_schema)
        full_n = nl + len(self.right_schema)
        for oi in (self.projection if self.projection is not None else range(full_n)):
            on_left = oi < nl
            yield on_left == self.probe_is_left, (oi if on_left else oi - nl)

    # ------------------------------------------------------------------
    # probe

    def _probe_view(self, build: core.PreparedBuild, pb: Batch):
        """(build to probe, probe words, all-keys-valid): with dictionary
        keys, the build's words re-keyed with this batch onto one joint
        vocabulary, as a general (range-probed) view sharing ``matched``."""
        probe_keys = self.left_keys if self.probe_is_left else self.right_keys
        pvals = core.key_columns(pb, probe_keys)
        if any(v.dtype.is_dict_encoded for v in pvals):
            build_keys = self.right_keys if self.probe_is_left else self.left_keys
            bvals, pvals = core.unify_key_dicts(core.key_columns(build.batch, build_keys),
                                                pvals)
            bwords, _ = core.canon_words(bvals)
            build = core.PreparedBuild(build.batch, bwords, build.n_live,
                                       matched=build.matched)
        pwords, pvalid = core.probe_words(build, pvals)
        return build, pwords, pvalid

    def publish_probe_prep(self, link, build: core.PreparedBuild, pipe, conf) -> bool:
        """Publish the probe anchor to a fused stage's ``ProbePrepLink``
        (``plan/fusion.py``; reference ``driver.py:153-200``). False, with
        the link cleared, when this build's shape cannot run off
        stage-prepped probes (dictionary keys, a residual condition, a
        duplicate-keyed build probed for pairs): the stage then runs its
        plain program and the eager prologue runs here."""
        probe_keys = self.left_keys if self.probe_is_left else self.right_keys
        key_schema = self.left_schema if self.probe_is_left else self.right_schema
        if self._cond is not None or any(k.dtype_of(key_schema).is_dict_encoded
                                         for k in probe_keys):
            link.clear()
            return False
        if build.unique:
            link.publish(build=build, kind="unique", pipe=pipe,
                         compact=self.wants_pairs and compact_join_output(conf))
            return True
        if build.exists_lut is not None and not (self.wants_pairs or self.build_mark
                                                 or self.build_outer):
            link.publish(build=build, kind="exists", pipe=pipe, compact=False)
            return True
        link.clear()
        return False

    def probe_batch(self, build: core.PreparedBuild, pb: Batch, conf,
                    pipe: UniqueProbePipeline | None = None) -> Iterator[Batch]:
        """Probe one batch; updates ``build.matched`` in place. With a
        ``pipe`` the unique-build compaction runs predicted and sync-free,
        and its emissions lag by the window depth (``finish_probe``). A
        batch from a fused probe stage carries a ``_probe_prep`` payload:
        its prologue already ran in the stage program under THIS build (a
        payload of any other build is ignored)."""
        prep = getattr(pb, "_probe_prep", None)
        if prep is not None and prep.build is not build:
            prep = None
        if prep is not None and pipe is not None and pipe.metrics is not None:
            pipe.metrics.add("probe_prep_batches", 1)
        marks = self.build_mark or self.build_outer
        if prep is not None and prep.kind == "exists":
            if self.probe_mark:
                yield self._emit_probe_marked(pb, prep.probe_matched)
            return
        if prep is not None:
            bi, ok = prep.bi, prep.ok
            bb = build.batch
        else:
            build, pwords, pvalid = self._probe_view(build, pb)
            ok_base = pb.device.sel & pvalid
            bb = build.batch
        if build.unique:
            if prep is None:
                bi, ok = core.probe_unique(build, pwords, ok_base)
            if self._cond is not None:
                ok = self._condition_holds(pb, bb, None, bi, ok)
            if marks:
                core.fold_rows(build.matched, bi, ok)
            if self.wants_pairs:
                if self._cond is None and compact_join_output(conf):
                    yield from self._emit_unique_compacted(pb, bb, bi, ok, pipe, prep)
                else:
                    yield self._emit(pb, bb, None, bi, ok, self._unique_sel(pb, ok),
                                     bcols=prep.bcols if prep is not None else None)
            elif self.probe_mark:
                yield self._emit_probe_marked(pb, ok)
            return
        if not self.wants_pairs and self._cond is None:
            # existence only: no pairs to enumerate
            matched = core.probe_mark(build, pwords, ok_base, fold=marks)
            if self.probe_mark:
                yield self._emit_probe_marked(pb, matched)
            return
        if build.n_live == 0:
            if self.probe_mark:
                yield self._emit_probe_marked(pb, torch.zeros_like(ok_base))
            elif self.probe_outer:
                yield self._emit_unmatched(pb, bb, pb.device.sel)
            return
        lo, counts = core.probe_ranges(build, pwords, ok_base)
        chunks = core.expand_pairs(pb.capacity, bb.capacity, lo, counts)
        matched = counts > 0
        if self._cond is not None:
            chunks, matched = core.condition_pairs(
                chunks, lambda li, ri, ok: self._condition_holds(pb, bb, li, ri, ok), counts)
        if marks:
            for _, ri, ok in chunks:
                core.fold_rows(build.matched, ri, ok)
        if self.probe_mark:
            yield self._emit_probe_marked(pb, matched)
            return
        if not self.wants_pairs:
            return
        for li, ri, ok in chunks:
            yield self._emit(pb, bb, li, ri, ok)
        if self.probe_outer:
            yield self._emit_unmatched(pb, bb, pb.device.sel & ~matched)

    def _unique_sel(self, pb: Batch, ok):
        """Live output rows of a unique probe: every probe row when the
        probe side is outer, else the matched ones (``ok`` includes sel)."""
        return pb.device.sel if self.probe_outer else ok

    # ------------------------------------------------------------------
    # the unique-join compaction boundary

    @staticmethod
    def _cols(b: Batch, ids):
        return [(b.col_values(c), b.col_validity(c)) for c in ids]

    def _side_ids(self):
        """(probe column ids, build column ids) the output needs."""
        pids, bids = [], []
        for on_probe, ci in self._out_cols():
            (pids if on_probe else bids).append(ci)
        return sorted(set(pids)), sorted(set(bids))

    def _emit_unique_compacted(self, pb: Batch, bb: Batch, bi, ok,
                               pipe: UniqueProbePipeline | None, prep=None) -> Iterator[Batch]:
        sel_out = self._unique_sel(pb, ok)
        metrics = pipe.metrics if pipe is not None else None
        if pipe is not None and not pipe.started:
            pipe.started = True
            if metrics is not None:
                metrics.add("unique_streams", 1)
        pred = pipe.pred if pipe is not None else None
        if prep is not None and prep.take != "probe":
            pred_cap = prep.pred_cap  # the stage made this same predict call
        else:
            pred_cap = pred.predict(pb.capacity) if pred is not None else None
        if pred_cap is None:
            # seed (first batch of a stream) or predictor off: one blocking
            # read of the live count, then an exact bucket
            (n_live,) = blocking_read(metrics, sel_out.sum())
            n_live = int(n_live)
            if pred is not None:
                pred.observe(n_live)
            yield self._take_at(pb, bb, bi, ok, sel_out, compaction_bucket(n_live, pb.capacity))
            return
        # predicted: compaction index on the device at the predicted bucket
        # (or dense where compaction would not pay), no host read; the live
        # count rides the window and a too-small bucket is re-taken
        out_cap = compaction_bucket(pred_cap, pb.capacity)
        if prep is not None and prep.take == "compact" and prep.out_cap == out_cap:
            taken = self._assemble_taken(pb, bb, *prep.taken)
        elif prep is not None and prep.take == "gather" and out_cap is None:
            taken = self._emit(pb, bb, None, bi, ok, sel_out, bcols=prep.bcols)
        else:
            taken = self._take_at(pb, bb, bi, ok, sel_out, out_cap)
        state = (pb, bb, bi, ok, sel_out, out_cap, taken)
        for resolved, st in pipe.window.push((sel_out.sum(),), state,
                                             tensor_bytes(bi, ok, taken.device)):
            yield self._finish_unique_compacted(resolved, st, pipe)

    def _take_at(self, pb: Batch, bb: Batch, bi, ok, sel_out, out_cap: int | None) -> Batch:
        """The unique join's output batch: dense (probe columns in place,
        build columns gathered at probe width) when ``out_cap`` is None, else
        compacted into ``out_cap`` slots on the device."""
        if out_cap is None:
            return self._emit(pb, bb, None, bi, ok, sel_out)
        pids, bids = self._side_ids()
        return self._assemble_taken(pb, bb, *core.predicted_take(
            self._cols(pb, pids), bi, ok, self._cols(bb, bids), sel_out, out_cap))

    def _assemble_taken(self, pb: Batch, bb: Batch, pc, bc, new_sel) -> Batch:
        """The compacted output batch from ``core.predicted_take``'s columns."""
        pids, bids = self._side_ids()
        p_at = dict(zip(pids, pc))
        b_at = dict(zip(bids, bc))
        cols = []
        for on_probe, ci in self._out_cols():
            src, (v, m) = (pb, p_at[ci]) if on_probe else (bb, b_at[ci])
            cols.append(ColumnVal(v, m, src.schema[ci].dtype, src.dicts[ci]))
        out = batch_from_columns(cols, self.out_schema.names, new_sel)
        return Batch(self.out_schema, out.device, out.dicts)

    def finish_probe(self, pipe: UniqueProbePipeline | None) -> Iterator[Batch]:
        """Drain the compaction window at the end of the probe stream."""
        if pipe is None:
            return
        for resolved, st in pipe.window.drain():
            yield self._finish_unique_compacted(resolved, st, pipe)

    def _finish_unique_compacted(self, resolved, state, pipe: UniqueProbePipeline) -> Batch:
        """Harvest half: observe the live count, re-take a too-small bucket
        from the still-held device state (no extra read)."""
        pb, bb, bi, ok, sel_out, out_cap, taken = state
        n_live = int(resolved[0])
        pipe.pred.observe(n_live, predicted=out_cap)
        if out_cap is not None and n_live > out_cap:
            if pipe.metrics is not None:
                pipe.metrics.add("sel_mispredicts", 1)
            taken = self._take_at(pb, bb, bi, ok, sel_out, compaction_bucket(n_live, pb.capacity))
        return taken

    # ------------------------------------------------------------------
    # build-side completions

    def finish(self, build: core.PreparedBuild) -> Iterator[Batch]:
        """After the probe stream: the unmatched build rows (build-outer)
        or the marked ones (build-side semi/anti/existence)."""
        bb = build.batch
        sel = bb.device.sel
        if self.build_outer:
            yield self._emit_build_extended(bb, sel & ~build.matched)
        elif self.build_mark:
            if self.join_type == LEFT_SEMI:
                yield self._finish_batch(self._side_cols(bb), sel & build.matched)
            elif self.join_type == LEFT_ANTI:
                yield self._finish_batch(self._side_cols(bb), sel & ~build.matched)
            else:  # existence: every build row and its flag
                cols = self._side_cols(bb) + [self._flag(build.matched)]
                yield self._finish_batch(cols, sel)

    # ------------------------------------------------------------------
    # emits

    @staticmethod
    def _side_cols(b: Batch) -> list[ColumnVal]:
        return [ColumnVal(b.col_values(i), b.col_validity(i), f.dtype, b.dicts[i])
                for i, f in enumerate(b.schema)]

    @staticmethod
    def _flag(matched) -> ColumnVal:
        return ColumnVal(matched, torch.ones_like(matched), T.BOOL)

    def _finish_batch(self, cols: list[ColumnVal], sel) -> Batch:
        """``cols`` in full-output-schema order; the projection subsets them."""
        if self.projection is not None:
            cols = [cols[i] for i in self.projection]
        out = batch_from_columns(cols, self.out_schema.names, sel)
        return Batch(self.out_schema, out.device, out.dicts)

    def _emit_probe_marked(self, pb: Batch, matched) -> Batch:
        """Semi: the matched probe rows; anti: the others; existence: every
        probe row and its flag."""
        sel = pb.device.sel
        if self.join_type == EXISTENCE:
            return self._finish_batch(self._side_cols(pb) + [self._flag(matched & sel)], sel)
        keep = matched if self.join_type == LEFT_SEMI else ~matched
        return self._finish_batch(self._side_cols(pb), sel & keep)

    def _emit_build_extended(self, bb: Batch, sel) -> Batch:
        """Build rows ``sel`` with NULL probe-side columns (build-outer)."""
        build_cols = [ColumnVal(c.values, c.validity & sel, c.dtype, c.dict)
                      for c in self._side_cols(bb)]
        other = self.left_schema if self.probe_is_left else self.right_schema
        nulls = core.null_columns(other, bb.capacity, sel.device)
        cols = nulls + build_cols if self.probe_is_left else build_cols + nulls
        return self._finish_batch(cols, sel)

    def _emit_unmatched(self, pb: Batch, bb: Batch, sel) -> Batch:
        """Probe rows ``sel`` with NULL build columns (probe-outer)."""
        ri = torch.zeros(pb.capacity, dtype=torch.int64, device=sel.device)
        return self._emit(pb, bb, None, ri, torch.zeros_like(sel), sel)

    def _emit(self, pb: Batch, bb: Batch, li, ri, ok, sel=None, bcols=None) -> Batch:
        """Gather output columns: probe rows at ``li`` (None = in place),
        build rows at ``ri`` (or taken from ``bcols``, build column ->
        (values, validity) already gathered at ``ri``); rows ``sel``
        (default ``ok``) are live, build columns are valid only where ``ok``
        (matched)."""
        sel = ok if sel is None else sel
        cols = []
        for on_probe, ci in self._out_cols():
            src = pb if on_probe else bb
            idx = li if on_probe else ri
            v, m = src.col_values(ci), src.col_validity(ci)
            if bcols is not None and not on_probe:
                v, m = bcols[ci]
            elif idx is not None:
                v, m = v[idx], m[idx]
            cols.append(ColumnVal(v, m & (sel if on_probe else ok), src.schema[ci].dtype,
                                  src.dicts[ci]))
        out = batch_from_columns(cols, self.out_schema.names, sel)
        return Batch(self.out_schema, out.device, out.dicts)
