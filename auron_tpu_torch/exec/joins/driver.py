"""Equi-join driver (port of the inner, left-outer, left-semi and
left-anti paths of ``auron_tpu/exec/joins/driver.py``): runs one prepared
build side against a stream of probe batches. Output columns are (left ++
right), or the left side's alone for semi/anti, subset by the optional
column-pruning ``projection``.

A unique build emits one batch per probe batch with exact compaction: the
live count is read once per batch, and when the output would fill less than
a quarter of the probe capacity (``compaction_bucket``) the live rows are
gathered into a smaller batch before the build columns are gathered
(predicted compaction is a later slice). A duplicate-keyed build expands
pair chunks. A LEFT join with the build on the right keeps every probe row
(``probe_outer``, ``core.py:604-615``, ``:666-691``): NULL-keyed and
unmatched rows stay live with NULL build columns.

A residual ``condition`` (over the combined left ++ right schema) is
evaluated over only the columns it references (``_reduced_condition``,
driver.py:665): on the unique path over the probe rows and their one build
match, otherwise over each chunk of expanded pairs (``core.condition_pairs``,
core.py:809-823). A pair whose condition is false or NULL does not match:
``probe_matched`` is recomputed from the filtered pairs, so a left join
emits such probe rows with NULL build columns, a semi join drops and an
anti join keeps them. A condition makes semi and anti joins enumerate
pairs, so their build never hides behind an existence table.
"""

from __future__ import annotations

from typing import Iterator

import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch, compaction_bucket
from auron_tpu_torch.exec.basic import batch_from_columns
from auron_tpu_torch.exec.joins import core
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import ColumnVal, Evaluator
from auron_tpu_torch.utils.config import JOIN_COMPACT_OUTPUT, resolve_tri


class EquiJoinDriver:
    def __init__(self, left_schema: T.Schema, right_schema: T.Schema,
                 left_keys: list[ir.Expr], right_keys: list[ir.Expr], join_type: str,
                 build_side: str, condition: ir.Expr | None = None,
                 projection: list[int] | None = None):
        assert build_side in ("left", "right")
        if not (join_type == core.INNER
                or (join_type in (core.LEFT, core.LEFT_SEMI, core.LEFT_ANTI)
                    and build_side == "right")):
            raise NotImplementedError(
                f"{join_type} join with the build on the {build_side}: only inner "
                "equi-joins, and left, left_semi and left_anti joins with the build on the "
                "right, are in this slice")
        self.left_schema, self.right_schema = left_schema, right_schema
        self.left_keys, self.right_keys = left_keys, right_keys
        self.join_type = join_type
        self.build_side = build_side
        full = core.join_output_schema(left_schema, right_schema, join_type)
        self.projection = list(projection) if projection is not None else None
        proj = self.projection if self.projection is not None else range(len(full))
        self.out_schema = T.Schema(tuple(full[i] for i in proj))
        self.probe_is_left = build_side == "right"
        self.probe_outer = join_type == core.LEFT
        self.probe_mark = join_type in (core.LEFT_SEMI, core.LEFT_ANTI)
        self._cond = self._reduced_condition(condition) if condition is not None else None

    def prepare(self, build_batches: list[Batch], device) -> core.PreparedBuild:
        schema = self.left_schema if self.build_side == "left" else self.right_schema
        keys = self.left_keys if self.build_side == "left" else self.right_keys
        # semi/anti probes without a condition only test existence: no
        # pairs to enumerate
        return core.prepare_build(build_batches, keys, schema, device,
                                  need_pairs=not self.probe_mark or self._cond is not None)

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
        """(output index, on probe side, side column index) per output column."""
        nl = len(self.left_schema)
        full_n = nl + len(self.right_schema)
        for oi in (self.projection if self.projection is not None else range(full_n)):
            on_left = oi < nl
            yield on_left == self.probe_is_left, (oi if on_left else oi - nl)

    def probe_batch(self, build: core.PreparedBuild, pb: Batch, conf) -> Iterator[Batch]:
        probe_keys = self.left_keys if self.probe_is_left else self.right_keys
        pwords, pvalid = core.probe_words(build, core.key_columns(pb, probe_keys))
        ok_base = pb.device.sel & pvalid
        bb = build.batch
        if build.unique:
            bi, ok = core.probe_unique(build, pwords, ok_base)
            if self._cond is not None:
                ok = self._condition_holds(pb, bb, None, bi, ok)
            if self.probe_mark:
                yield self._emit_probe_marked(pb, ok)
            else:
                yield self._emit_unique(pb, bb, bi, ok, conf)
            return
        if self.probe_mark and self._cond is None:
            yield self._emit_probe_marked(pb, core.probe_mark(build, pwords, ok_base))
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
        if self.probe_mark:
            yield self._emit_probe_marked(pb, matched)
            return
        for li, ri, ok in chunks:
            yield self._emit(pb, bb, li, ri, ok)
        if self.probe_outer:
            yield self._emit_unmatched(pb, bb, pb.device.sel & ~matched)

    def _emit_unique(self, pb: Batch, bb: Batch, bi, ok, conf) -> Batch:
        pidx = None
        sel = pb.device.sel if self.probe_outer else ok
        if resolve_tri(conf.get(JOIN_COMPACT_OUTPUT), True):
            n_live = int(sel.sum().item())
            out_cap = compaction_bucket(n_live, pb.capacity)
            if out_cap is not None:
                idx = torch.nonzero(sel).flatten()
                pidx = torch.zeros(out_cap, dtype=torch.int64, device=ok.device)
                pidx[:n_live] = idx
                new_sel = torch.arange(out_cap, device=ok.device) < n_live
                bi, ok, sel = bi[pidx], ok[pidx] & new_sel, new_sel
        return self._emit(pb, bb, pidx, bi, ok, sel)

    def _emit_probe_marked(self, pb: Batch, matched) -> Batch:
        """Semi: the matched probe rows; anti: the others."""
        sel = pb.device.sel & (matched if self.join_type == core.LEFT_SEMI else ~matched)
        return self._emit_probe_only(pb, sel)

    def _emit_probe_only(self, pb: Batch, sel) -> Batch:
        """The probe batch's columns (projected) with the selection ``sel``."""
        cols = [ColumnVal(pb.col_values(i), pb.col_validity(i), f.dtype, pb.dicts[i])
                for i, f in enumerate(pb.schema)]
        if self.projection is not None:
            cols = [cols[i] for i in self.projection]
        out = batch_from_columns(cols, self.out_schema.names, sel)
        return Batch(self.out_schema, out.device, out.dicts)

    def _emit_unmatched(self, pb: Batch, bb: Batch, sel) -> Batch:
        """Probe rows ``sel`` with NULL build columns (left join)."""
        ri = torch.zeros(pb.capacity, dtype=torch.int64, device=sel.device)
        return self._emit(pb, bb, None, ri, torch.zeros_like(sel), sel)

    def _emit(self, pb: Batch, bb: Batch, li, ri, ok, sel=None) -> Batch:
        """Gather output columns: probe rows at ``li`` (None = in place),
        build rows at ``ri``; rows ``sel`` (default ``ok``) are live, build
        columns are valid only where ``ok`` (matched)."""
        sel = ok if sel is None else sel
        cols = []
        for on_probe, ci in self._out_cols():
            src = pb if on_probe else bb
            idx = li if on_probe else ri
            v, m = src.col_values(ci), src.col_validity(ci)
            if idx is not None:
                v, m = v[idx], m[idx]
            cols.append(ColumnVal(v, m & (sel if on_probe else ok), src.schema[ci].dtype,
                                  src.dicts[ci]))
        out = batch_from_columns(cols, self.out_schema.names, sel)
        return Batch(self.out_schema, out.device, out.dicts)
