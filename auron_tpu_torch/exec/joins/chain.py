"""Fused star-schema join chains (port of ``auron_tpu/exec/joins/chain.py``).

A stack of inner broadcast hash joins over unique (PK-like) build sides —
the classic fact-to-dimensions shape — refines the selection at every
level: each probe row either survives with exactly one match per dimension
or dies. Run one operator at a time, the stack materializes an
intermediate batch per level; fused, a probe batch costs

    one probe per level (key words + LUT or binary search, no gathers)
    one combined selection and ONE compaction of the bottom probe stream
    one gather of every projected column at the compacted width (probe
    columns at idx, each level's build columns at bi_level[idx])

Fusion requirements per link (checked at run time, falling back to the
plain per-operator path): inner join, no residual condition, unique build
without multi-key packing, no dictionary-encoded key, and the parent's
probe keys resolving to pass-through probe columns of the child join.

The compaction bucket comes from the selectivity predictor and each
batch's live count rides the transfer window, as in the driver's unique
probe: the first batch of a stream takes the one blocking seed read, a
too-small bucket is re-taken from the still-held device state
(``sel_mispredicts``). With the predictor off the live count still rides
the window; with compaction off the chain emits dense batches at once.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from auron_tpu_torch.columnar.batch import Batch, compaction_bucket, compaction_index
from auron_tpu_torch.exec.basic import batch_from_columns
from auron_tpu_torch.exec.joins import core
from auron_tpu_torch.exec.joins.driver import compact_join_output
from auron_tpu_torch.exec.selectivity import SelectivityPredictor, predictor_enabled
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import ColumnVal
from auron_tpu_torch.memory import memmgr
from auron_tpu_torch.runtime.transfer import TransferWindow, blocking_read, tensor_bytes
from auron_tpu_torch.utils.config import TRANSFER_WINDOW_DEPTH


def clear_chain_memos(top, partition: int, ctx) -> None:
    """Drop any fallback build memos this chain stashed but never consumed
    (an operator that raised before its _build ran leaves its entry behind).
    Called by the chain top's per-operator path on completion."""
    keys = ctx.resources.pop(("fusion_build_memo_keys", id(top), partition), None)
    for k in keys or ():
        ctx.resources.pop(k, None)


def _full_index(d, oi: int) -> tuple[bool, int]:
    """(on the probe side, side column) of output column ``oi`` of a link."""
    nl = len(d.left_schema)
    full_i = d.projection[oi] if d.projection is not None else oi
    on_left = full_i < nl
    return on_left == d.probe_is_left, (full_i if on_left else full_i - nl)


def try_fused_chain(top, partition: int, ctx) -> Iterator[Batch] | None:
    """Run ``top`` (a BroadcastHashJoinExec) as a fused chain, or None when
    the shape does not qualify (the caller then runs the per-operator path)."""
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec

    links = []  # (exec, probe child index), top-down
    node = top
    while isinstance(node, BroadcastHashJoinExec):
        d = node.driver
        if d.join_type != core.INNER or d.condition is not None:
            break
        probe_child = 1 if node.build_side == "left" else 0
        links.append((node, probe_child))
        node = node.children[probe_child]
    if len(links) < 2:
        return None  # a single join takes the driver's path
    links.reverse()  # bottom-up
    bottom = node

    # dictionary keys need per-batch vocabulary unification: per-operator path
    for ex, _ in links:
        d = ex.driver
        probe_schema = d.left_schema if d.probe_is_left else d.right_schema
        build_schema = d.right_schema if d.probe_is_left else d.left_schema
        pkeys = d.left_keys if d.probe_is_left else d.right_keys
        bkeys = d.right_keys if d.probe_is_left else d.left_keys
        for k, schema in [(x, probe_schema) for x in pkeys] + [(x, build_schema) for x in bkeys]:
            if not isinstance(k, ir.Column) or schema[k.index].dtype.is_dict_encoded:
                return None

    def resolve_to_bottom(level: int, col_idx: int) -> int | None:
        """A probe-input column of ``level`` as a bottom column (None when
        it comes from a lower level's build side)."""
        i = col_idx
        for lv in range(level - 1, -1, -1):
            on_probe, i = _full_index(links[lv][0].driver, i)
            if not on_probe:
                return None
        return i

    key_cols_per_level = []
    for level, (ex, _) in enumerate(links):
        d = ex.driver
        cols = [resolve_to_bottom(level, k.index)
                for k in (d.left_keys if d.probe_is_left else d.right_keys)]
        if any(c is None for c in cols):
            return None
        key_cols_per_level.append(cols)

    def resolve_out(level: int, oi: int) -> tuple[int, int]:
        """(source, column) of an output column: source -1 = bottom probe
        column, source l >= 0 = build column of level l."""
        on_probe, ci = _full_index(links[level][0].driver, oi)
        if not on_probe:
            return (level, ci)
        return (-1, ci) if level == 0 else resolve_out(level - 1, ci)

    d_top = links[-1][0].driver
    out_map = [resolve_out(len(links) - 1, oi) for oi in range(len(d_top.out_schema))]

    # every structural check passed: prepare the builds now. Uniqueness is
    # known only after building; when a build forces the fallback, the
    # prepared builds wait in the task resources for the per-operator path
    builds = []
    for ex, _ in links:
        b = ex._build(partition, ctx)
        builds.append(b)
        if not b.unique or b.pack is not None:
            keys = []
            for (ex2, _), b2 in zip(links, builds):
                k = ("fusion_build_memo", id(ex2), partition)
                ctx.resources[k] = b2
                keys.append(k)
            ctx.resources[("fusion_build_memo_keys", id(top), partition)] = keys
            return None
    return _run_chain(top, bottom, links, builds, key_cols_per_level, out_map, partition, ctx)


def _run_chain(top, bottom, links, builds, key_cols_per_level, out_map, partition,
               ctx) -> Iterator[Batch]:
    from auron_tpu_torch.exec.joins.bhj import _BuildMemGuard

    out_schema = links[-1][0].driver.out_schema
    bottom_schema = bottom.schema
    compact_mode = compact_join_output(ctx.conf)
    pred = (SelectivityPredictor(ctx.conf)
            if compact_mode and predictor_enabled(ctx.conf) else None)
    metrics = ctx.metrics
    window = TransferWindow(ctx.conf.get(TRANSFER_WINDOW_DEPTH), metrics)

    def probe_all(pb: Batch):
        """Every level's probe and the combined selection."""
        sel = pb.device.sel
        bis = []
        for build, key_cols in zip(builds, key_cols_per_level):
            vals = [ColumnVal(pb.col_values(c), pb.col_validity(c), bottom_schema[c].dtype)
                    for c in key_cols]
            words, valid = core.canon_words(vals)
            bi, ok = core.probe_unique(build, words, pb.device.sel & valid)
            bis.append(bi)
            sel = sel & ok
        return sel, bis

    def assemble(pb: Batch, sel, bis, out_cap: int | None) -> Batch:
        """Output batch: dense (probe columns in place, build columns at
        probe width) when ``out_cap`` is None, else compacted into it."""
        if out_cap is None:
            idx, new_sel = None, sel
        else:
            idx, new_sel = compaction_index(sel, out_cap)
        cols = []
        for (src, ci), f in zip(out_map, out_schema):
            if src == -1:
                v, m = pb.col_values(ci), pb.col_validity(ci)
                if idx is not None:
                    v, m = v[idx], m[idx] & new_sel
                cols.append(ColumnVal(v, m, f.dtype, pb.dicts[ci]))
            else:
                bb = builds[src].batch
                at = bis[src] if idx is None else bis[src][idx]
                cols.append(ColumnVal(bb.col_values(ci)[at], bb.col_validity(ci)[at] & new_sel,
                                      f.dtype, bb.dicts[ci]))
        out = batch_from_columns(cols, out_schema.names, new_sel)
        return Batch(out_schema, out.device, out.dicts)

    def finish(resolved, state) -> Batch:
        """Harvest half: observe the live count, re-take a too-small bucket."""
        pb, sel, bis, out_cap, taken = state
        n_live = int(resolved[0])
        if pred is None:  # predictor off: exact bucket from the windowed count
            return assemble(pb, sel, bis, compaction_bucket(n_live, pb.capacity))
        pred.observe(n_live, predicted=out_cap)
        if out_cap is not None and n_live > out_cap:
            metrics.add("sel_mispredicts", 1)
            taken = assemble(pb, sel, bis, compaction_bucket(n_live, pb.capacity))
        return taken

    guard = _BuildMemGuard(top, builds, (window,))
    mm = memmgr.register(ctx, guard, spillable=False)
    seeded = False
    try:
        for pb in bottom.execute(partition, _bottom_context(links, ctx)):
            ctx.check_cancelled()
            with metrics.timer("probe_time", count=True):
                sel, bis = probe_all(pb)
                if not compact_mode:
                    ready = [assemble(pb, sel, bis, None)]
                else:
                    if not seeded:
                        seeded = True
                        metrics.add("unique_streams", 1)
                    pred_cap = pred.predict(pb.capacity) if pred is not None else None
                    if pred is not None and pred_cap is None:
                        # no history yet: one blocking seed read, finished at once
                        (n_live,) = blocking_read(metrics, sel.sum())
                        pred.observe(int(n_live))
                        ready = [assemble(pb, sel, bis,
                                          compaction_bucket(int(n_live), pb.capacity))]
                    else:
                        out_cap = taken = None
                        if pred is not None:
                            out_cap = compaction_bucket(pred_cap, pb.capacity)
                            taken = assemble(pb, sel, bis, out_cap)
                        state = (pb, sel, bis, out_cap, taken)
                        ready = [finish(r, st) for r, st in window.push(
                            (sel.sum(),), state, tensor_bytes(sel, bis, taken and taken.device))]
            yield from ready
        for resolved, state in window.drain():
            with metrics.timer("probe_time"):
                ready = finish(resolved, state)
            yield ready
        if pred is not None and pred.predictions:
            metrics.add("sel_pred_batches", pred.predictions)
    finally:
        window.clear()
        mm.unregister(guard)


def _bottom_context(links, ctx):
    """The bottom probe source's context: the metric node the per-operator
    path would give it (each link's probe child, top-down)."""
    m = ctx.metrics
    for ex, probe_child in reversed(links):
        m = m.child(probe_child)
        m.name = ex.children[probe_child].name
    return dataclasses.replace(ctx, metrics=m)
