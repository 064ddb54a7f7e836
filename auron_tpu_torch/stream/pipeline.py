"""The continuous-query pipeline: poll → fused Calc → window fold →
watermark emission → sink, with barrier checkpoints.

One ``step()`` is one micro-batch: poll the source, deserialize, run
the whole-stage-fused Calc chain (exec/streaming.py ``build_chain`` —
on the card the predicates and the projections that feed windowing are
captured into one CUDA graph per key, so a long-running stream costs
one replay per batch), assign event-time windows, fold into the
host WindowStore, advance the watermark, and emit every window it
closed. Every ``stream.checkpoint.interval.batches`` steps a barrier
captures (source offsets, window state, watermark, emission sequence)
**synchronously** and hands the bytes to the checkpoint coordinator.

Exactly-once: all state that determines output lives in the snapshot,
every input is replayable from offsets, and emission order is a pure
sorted function of state — so resume = load newest checkpoint, seek
the source, truncate the sink to the checkpointed emission sequence,
and re-run; the resumed stream reproduces the killed stream's output
byte-for-byte (fuzzed at every instrumented kill point in
tests/test_torch_stream_exactly_once.py).

Port of ``auron_tpu/stream/pipeline.py``. The Calc chain runs on the
pipeline's ``device`` (default ``cuda``; a CUDA request without a card
raises); each micro-batch reaches it through ``Batch.from_arrow`` (its
strings dictionary-encoded by pyarrow first: ``upload_batch``) and its
output comes back as host planes (``_host_columns``,
counted by ``utils/profiling.EngineCounters`` as every transfer-window
read is).
The window fold, the watermark and the checkpoints stay on the host, as
in the reference, so emissions and checkpoint bytes equal the
reference's for the same input. pyarrow is imported inside the functions
that read or build record batches.

Fault injection: ``fault(point)`` is called at each named point below;
tests raise :class:`StreamKilled` from it to simulate a crash at that
exact seam.
"""

from __future__ import annotations

import json
from typing import Callable

import numpy as np

from auron_tpu_torch import obs
from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.device import resolve_device
from auron_tpu_torch.exec.base import ExecutionContext
from auron_tpu_torch.exec.streaming import OFFSETS, StreamingCalcExec, upload_batch
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.stream.checkpoint import CheckpointCoordinator
from auron_tpu_torch.stream.lowering import StreamingPlan
from auron_tpu_torch.stream.sink import Emission, StreamSink
from auron_tpu_torch.stream.state import WindowStore
from auron_tpu_torch.stream.windows import WatermarkTracker
from auron_tpu_torch.utils.config import (
    STREAM_CHECKPOINT_INTERVAL,
    STREAM_CHECKPOINT_KEEP,
    STREAM_POLL_MAX_RECORDS,
    active_conf,
)

#: instrumented kill points, in step order
FAULT_POINTS = ("poll", "post-calc", "post-fold", "pre-emit", "mid-emit",
                "post-emit", "pre-barrier", "mid-barrier", "post-barrier")


class StreamKilled(RuntimeError):
    """Raised by a fault hook to simulate a crash at an exact seam."""


#: output kinds read straight from the chain's host planes (a BOOL goes
#: through Arrow, where a NULL among its values raises, as in the reference)
_PLANE_KINDS = frozenset((T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32,
                          T.TypeKind.INT64, T.TypeKind.FLOAT32, T.TypeKind.FLOAT64,
                          T.TypeKind.STRING))


def _host_columns(out: Batch, metrics) -> tuple[list, list]:
    """(columns, codes). ``columns``: the (values, valid) host views of the
    output's live rows, one a column, as ``_host_column`` gives them from
    ``Batch.to_arrow``: null lanes carry a type zero ("" for a string).
    ``codes``: for a string column whose vocabulary's entries are distinct,
    its codes (a NULL's the code of "", or -1), which are equal exactly
    where the strings are; else None. The planes come back through
    ``live_host_planes`` (a small output's in one pinned copy) and the
    strings are the vocabulary's, gathered by code. An output with a
    column of another kind goes through ``to_arrow``."""
    if not all(f.dtype.kind in _PLANE_KINDS for f in out.schema):
        rb = out.to_arrow(metrics)
        return [_host_column(rb.column(i)) for i in range(rb.num_columns)], \
            [None] * rb.num_columns
    _, planes = out.live_host_planes(metrics)
    cols, codes = [], []
    for f, vocab, (v, m) in zip(out.schema, out.dicts, planes):
        nulls = not m.all()
        c = None
        if f.dtype.kind == T.TypeKind.STRING:
            entries = vocab.tolist()
            if len(set(entries)) == len(entries):
                c = v.astype(np.int64)
                if nulls:
                    c[~m] = entries.index("") if "" in entries else -1
            v = vocab[np.where(m, v, 0) if nulls else v] if len(vocab) \
                else np.full(len(v), "", dtype=object)
            if nulls:
                v[~m] = ""
        elif nulls:
            v = np.where(m, v, np.zeros((), v.dtype))
        cols.append((v, m))
        codes.append(c)
    return cols, codes


def _host_column(arr) -> tuple[np.ndarray, np.ndarray]:
    """(values, valid) host view of one output column (a pyarrow Array);
    null lanes carry a type-zero so downstream masking is branch-free."""
    from auron_tpu_torch.utils.arrowlib import pyarrow

    pa = pyarrow()
    import pyarrow.compute as pc

    valid = np.asarray(pc.is_valid(arr))
    if arr.null_count:
        zero = "" if pa.types.is_string(arr.type) else 0
        arr = arr.fill_null(zero)
    return np.asarray(arr), valid


class StreamPipeline:
    """One continuous query on ``device``, driven by one thread at a time:
    the pump owns it while alive, and a control thread (cancel, restore)
    touches it only after joining the pump."""

    def __init__(self, plan: StreamingPlan, source, deserializer,
                 sink: StreamSink, conf=None, checkpoint_dir: str | None = None,
                 fault: Callable[[str], None] | None = None,
                 sync_checkpoints: bool = True, device: str = "cuda"):
        self.device = str(resolve_device(device))
        self.plan = plan
        self.source = source
        self.sink = sink
        self.conf = conf if conf is not None else active_conf().copy()
        self.fault = fault or (lambda point: None)
        self.poll_max = self.conf.get(STREAM_POLL_MAX_RECORDS)
        self.barrier_interval = max(1, self.conf.get(STREAM_CHECKPOINT_INTERVAL))
        self.coordinator = None
        if checkpoint_dir is not None:
            self.coordinator = CheckpointCoordinator(
                checkpoint_dir, keep=self.conf.get(STREAM_CHECKPOINT_KEEP),
                sync=sync_checkpoints)

        # the Calc chain projects exactly what windowing consumes:
        # event time (+ watermark column when distinct), keys, agg args
        projections: list[tuple[ir.Expr, str]] = [
            (ir.Column(plan.ts_index, "ts"), "__ts")]
        self._wm_slot = 0
        if plan.watermark_index != plan.ts_index:
            self._wm_slot = len(projections)
            projections.append(
                (ir.Column(plan.watermark_index, "wm"), "__wm"))
        self._key_base = len(projections)
        projections += [(kb.e, f"__k{i}") for i, kb in enumerate(plan.keys)]
        self._val_slots: list[int | None] = []
        for a in plan.aggs:
            if a.arg is None:
                self._val_slots.append(None)
            else:
                self._val_slots.append(len(projections))
                projections.append(
                    (a.arg.e, f"__a{len(self._val_slots) - 1}"))
        self.calc = StreamingCalcExec(
            source=source, deserializer=deserializer, in_schema=plan.schema,
            predicates=list(plan.predicates), projections=projections,
            max_batch_records=self.poll_max, device=self.device)
        self.ctx = ExecutionContext(conf=self.conf, device=self.device)
        self._chain_src, self._chain = self.calc.build_chain(self.conf)

        self.store = WindowStore(plan.agg_funcs)
        self.tracker = WatermarkTracker(plan.watermark_delay_ms)
        self.emit_seq = 0
        self.steps = 0
        self.ckpt_seq = 0
        self.metrics = {"events_in": 0, "rows_folded": 0, "groups_touched": 0,
                        "emissions": 0, "checkpoints": 0, "null_ts_rows": 0}

    # -- one micro-batch ----------------------------------------------------

    def step(self) -> bool:
        """Process one poll. Returns False when the source is exhausted
        (a real Kafka source never is; the mock one ends for tests)."""
        self.fault("poll")
        payloads = self.source.poll(self.poll_max)
        if payloads is None:
            return False
        self.metrics["events_in"] += len(payloads)
        rb = self.calc.deserializer.deserialize(payloads)
        if rb.num_rows:
            self._chain_src.slot = upload_batch(rb, self.device, self.conf)
            for out in self._chain.execute(0, self.ctx):
                self.fault("post-calc")
                self._fold(out)
        self.fault("post-fold")
        self._emit_closed()
        self.steps += 1
        if self.coordinator is not None \
                and self.steps % self.barrier_interval == 0:
            self.barrier()
        return True

    def _fold(self, out: Batch) -> None:
        cols, codes = _host_columns(out, self.ctx.metrics)
        if len(cols[0][0]) == 0:
            return
        ts_vals, ts_valid = cols[0]
        wm_vals, wm_valid = cols[self._wm_slot]
        # NULL event time has no window; dropped and counted, never folded
        if not ts_valid.all():
            self.metrics["null_ts_rows"] += int((~ts_valid).sum())
        ts_ms = ts_vals.astype(np.int64) // self.plan.ts_scale_to_ms
        self.tracker.observe(
            (wm_vals.astype(np.int64) // self.plan.ts_scale_to_ms)[wm_valid])
        rows, wins = self.plan.window.assign(ts_ms[ts_valid])
        if len(rows) == 0:
            return
        sel = np.flatnonzero(ts_valid)[rows]
        keys = [cols[self._key_base + i][0][sel]
                for i in range(len(self.plan.keys))]
        # what the store sorts on: a string key's codes, a numeric key itself
        group_keys = [k if c is None else c[sel] for k, c in
                      zip(keys, codes[self._key_base:self._key_base + len(keys)])]
        if any(k.dtype == object for k in group_keys):
            group_keys = None
        vals = []
        for slot in self._val_slots:
            if slot is None:
                vals.append(None)
            else:
                v, ok = cols[slot]
                vals.append((v[sel], ok[sel]))
        self.metrics["rows_folded"] += len(sel)
        self.metrics["groups_touched"] += self.store.update(wins, keys, vals, group_keys)

    # -- emission -----------------------------------------------------------

    def _emit_closed(self, watermark_ms: int | None = None) -> None:
        wm = watermark_ms if watermark_ms is not None \
            else self.tracker.watermark_ms
        if wm is None:
            return
        closed = self.store.emit_closed(wm, self.plan.window.size_ms)
        if not closed:
            return
        self.fault("pre-emit")
        nk = len(self.plan.keys)
        # the watermark span: /queries shows what the stream believes
        # about event-time completeness and how far emission lags it
        with obs.span("stream.emit", cat="stream", arg={
                "watermark_ms": wm, "windows": len(closed),
                "lag_windows": len(self.store),
                "first_seq": self.emit_seq}):
            for i, (win, rows) in enumerate(closed):
                if i:
                    self.fault("mid-emit")
                out_rows = tuple(
                    tuple(self._out_value(oc, win, r, nk)
                          for oc in self.plan.output)
                    for r in rows)
                self.sink.emit(Emission(
                    seq=self.emit_seq, window_start=win,
                    window_end=win + self.plan.window.size_ms,
                    columns=tuple(oc.name for oc in self.plan.output),
                    rows=out_rows))
                self.emit_seq += 1
                self.metrics["emissions"] += 1
        self.fault("post-emit")

    def _out_value(self, oc, win: int, row: tuple, nk: int):
        if oc.kind == "window_start":
            return win
        if oc.kind == "window_end":
            return win + self.plan.window.size_ms
        if oc.kind == "key":
            return row[oc.index]
        return row[nk + oc.index]

    # -- barriers / recovery ------------------------------------------------

    def barrier(self) -> None:
        """Synchronously capture (offsets, state, watermark, emit_seq)
        and commit them as one checkpoint."""
        self.fault("pre-barrier")
        sections = {
            "meta": json.dumps({
                "view": self.plan.name,
                "emit_seq": self.emit_seq, "steps": self.steps,
                "watermark_ms": self.tracker.watermark_ms,
                "poll_max_records": self.poll_max,
            }, separators=(",", ":")).encode(),
            "offsets": json.dumps(
                {str(k): v for k, v in sorted(self.source.offsets().items())},
                separators=(",", ":")).encode(),
            "state": self.store.snapshot(),
        }
        # capture is complete; a kill between here and the write means
        # this barrier never committed — resume replays from the last
        # one that did, which is the whole point
        self.fault("mid-barrier")
        with obs.span("stream.checkpoint", cat="stream", arg={
                "ckpt": self.ckpt_seq, "emit_seq": self.emit_seq,
                "watermark_ms": self.tracker.watermark_ms,
                "open_groups": len(self.store)}):
            self.coordinator.write(self.ckpt_seq, sections)
        self.ckpt_seq += 1
        self.metrics["checkpoints"] += 1
        self.fault("post-barrier")

    @classmethod
    def restore(cls, plan: StreamingPlan, source_factory, deserializer,
                sink: StreamSink, checkpoint_dir: str, conf=None,
                fault: Callable[[str], None] | None = None,
                sync_checkpoints: bool = True, device: str = "cuda") -> "StreamPipeline":
        """Resume from the newest committed checkpoint (or start fresh).
        ``source_factory(startup_mode, offsets)`` builds the source —
        the KafkaScanExec resource convention."""
        conf = conf if conf is not None else active_conf().copy()
        coord = CheckpointCoordinator(
            checkpoint_dir, keep=conf.get(STREAM_CHECKPOINT_KEEP),
            sync=sync_checkpoints)
        latest = coord.latest()
        if latest is None:
            source = source_factory("earliest", {})
            return cls(plan, source, deserializer, sink, conf=conf,
                       checkpoint_dir=checkpoint_dir, fault=fault,
                       sync_checkpoints=sync_checkpoints, device=device)
        seq, sections = latest
        meta = json.loads(sections["meta"])
        if meta["poll_max_records"] != conf.get(STREAM_POLL_MAX_RECORDS):
            raise ValueError(
                f"checkpoint was taken with stream.poll.max.records="
                f"{meta['poll_max_records']}, conf now says "
                f"{conf.get(STREAM_POLL_MAX_RECORDS)}: micro-batch "
                "boundaries would shift and break bit-identical replay")
        if meta["view"] != plan.name:
            raise ValueError(
                f"checkpoint belongs to view {meta['view']!r}, "
                f"not {plan.name!r}")
        offsets = {int(k): v for k, v in
                   json.loads(sections["offsets"]).items()}
        source = source_factory(OFFSETS, offsets)
        p = cls(plan, source, deserializer, sink, conf=conf,
                checkpoint_dir=checkpoint_dir, fault=fault,
                sync_checkpoints=sync_checkpoints, device=device)
        p.store.restore(sections["state"])
        p.tracker = WatermarkTracker(plan.watermark_delay_ms,
                                     meta["watermark_ms"])
        p.emit_seq = meta["emit_seq"]
        p.steps = meta["steps"]
        p.ckpt_seq = seq + 1
        # rewind the sink: emissions past the barrier are the crashed
        # run's uncommitted suffix; replay re-produces them identically
        sink.truncate(p.emit_seq)
        return p

    # -- drive --------------------------------------------------------------

    def run(self, max_steps: int | None = None, drain: bool = False) -> int:
        """Drive steps until the source is exhausted (or ``max_steps``).
        ``drain=True`` then closes every remaining window — the finite-
        source ending tests and gates use for a complete, comparable
        output."""
        n = 0
        while (max_steps is None or n < max_steps) and self.step():
            n += 1
        if drain:
            self.drain()
        return n

    def drain(self) -> None:
        """Force-close all windows (watermark -> +inf). Finite sources
        only — a live stream drains at shutdown, not mid-flight."""
        self._emit_closed(watermark_ms=np.iinfo(np.int64).max)

    def close(self) -> None:
        if self.coordinator is not None:
            self.coordinator.close()
        self.sink.close()
