"""Query-scoped structured tracing + always-on flight recorder (port of
``auron_tpu/obs/__init__.py``; only the imports differ).

The engine's aggregate halves (per-operator MetricNode trees, process
EngineCounters) say *how much* a cost was; this package records *when*
and *under which query* it occurred.

Public surface:

- ``span`` / ``use_span`` / ``current_span`` / ``query_trace`` — the
  span model (obs/span.py); spans cross thread hops EXPLICITLY, like
  conf.
- ``note_op`` / ``note_sync`` / ``note_compile`` / ``note_spill`` /
  ``note_harvest`` / ``note_transfer_start`` / ``note_pump_batch`` —
  the instrumentation facade the engine calls (MetricNode.timer and the
  fused stages' split, EngineCounters, memmgr, transfer window, task
  pump). Each
  checks ``core._mode`` first; in mode off a call is one flag test.
- exporters in ``auron_tpu_torch.obs.export`` (Chrome/Perfetto JSON,
  Prometheus text), served by utils/httpsvc at ``/trace``,
  ``/metrics.prom``, ``/queries``.

``AURON_TPU_OBS_KILL=1`` rebinds the whole facade to no-ops at import —
the no-obs baseline of an overhead measurement.
"""

from __future__ import annotations

from auron_tpu_torch.obs import core
from auron_tpu_torch.obs.core import (  # noqa: F401  (re-exported)
    MODE_OFF,
    MODE_RECORDER,
    MODE_TRACE,
    mode,
    mode_name,
    set_mode,
)
from auron_tpu_torch.obs.span import (  # noqa: F401  (re-exported)
    Span,
    Trace,
    _span_var,
    current_span,
    current_trace,
    get_trace,
    query_trace,
    recent_queries,
    span,
    use_span,
)
from auron_tpu_torch.utils.config import int_conf, str_conf

OBS_MODE = str_conf(
    "obs.mode", "recorder", "observability",
    "recording mode: off (instrumentation short-circuits) | recorder "
    "(always-on bounded flight recorder) | trace (full tracing: per-query summaries + span/metric "
    "cross-check). Applied process-wide when a task's conf sets it "
    "explicitly (runtime/task.py); AURON_TPU_OBS_MODE sets the start mode",
)
OBS_TRACE_ID = int_conf(
    "obs.trace.id", 0, "observability",
    "INTERNAL: id of the owning query trace, threaded through task/spill "
    "confs by obs.query_trace so work dispatched to foreign threads still "
    "attributes to its query. 0 = untraced",
)
OBS_RING_EVENTS = int_conf(
    "obs.recorder.events", 32768, "observability",
    "flight-recorder ring capacity in events PER THREAD (bounded memory; "
    "oldest events overwrite first). The derived env twin "
    "AURON_TPU_OBS_RECORDER_EVENTS also applies at import, before any "
    "session conf reaches the bridge",
)
OBS_QUERIES_KEEP = int_conf(
    "obs.queries.keep", 64, "observability",
    "finished query-trace summaries retained in the /queries ring",
)


def apply_conf(conf) -> None:
    """Apply explicitly-set obs knobs from a session/task conf (called by
    the bridge on task entry, next to the httpsvc lazy start). Only keys
    the SESSION conf actually carries are applied — env values took
    effect at import, and re-asserting them per task would clobber a
    later programmatic set_mode."""
    if conf.has(OBS_MODE, include_env=False):
        set_mode(conf.get(OBS_MODE))
    if conf.has(OBS_RING_EVENTS, include_env=False):
        core.set_ring_capacity(conf.get(OBS_RING_EVENTS))
    if conf.has(OBS_QUERIES_KEEP, include_env=False):
        from auron_tpu_torch.obs.span import set_queries_keep

        set_queries_keep(conf.get(OBS_QUERIES_KEEP))


# ---------------------------------------------------------------------------
# instrumentation facade (the engine-side call sites)
# ---------------------------------------------------------------------------


def _span_ids():
    sp = _span_var.get()
    if sp is None:
        return None, 0, 0
    return sp.trace, sp.trace_id, sp.span_id


def note_op(op: str, metric: str, dur_ns: int) -> None:
    """One MetricNode.timer interval (exec/metrics.py): the span
    timeline's per-operator compute segments. The SAME dt lands in the
    metric tree, so span-derived and metric-derived per-op totals agree
    by construction. Per-event Trace accumulation (the span_op_ns side
    of the cross-check) is TRACE-mode only — recorder mode pays for ring
    appends, never a per-event lock."""
    if core._mode == MODE_OFF:
        return
    trace, tid, sid = _span_ids()
    core.record("op", metric, dur_ns, tid, sid, 0, op.partition(".")[0])
    if trace is not None and core._mode == MODE_TRACE:
        trace.note_op(op, metric, dur_ns)


def note_sync(dur_ns: int, is_async: bool) -> None:
    """One device->host read observed by EngineCounters (blocking sync or
    async-window harvest), attributed to the calling thread's span."""
    if core._mode == MODE_OFF:
        return
    trace, tid, sid = _span_ids()
    core.record("async" if is_async else "sync",
                "async_read" if is_async else "host_sync",
                dur_ns, tid, sid, 0, None)
    if trace is not None and core._mode == MODE_TRACE:
        trace.note_sync(dur_ns, is_async)


def note_compile(dur_ns: int, what: str = "graph_capture") -> None:
    """One preparation of new device work (utils/profiling.py): a CUDA
    graph capture of a fused stage or an nvcc build of a kernel source."""
    if core._mode == MODE_OFF:
        return
    trace, tid, sid = _span_ids()
    core.record("compile", what, dur_ns, tid, sid, 0, None)
    if trace is not None and core._mode == MODE_TRACE:
        trace.note_compile(dur_ns)


def note_spill(consumer: str, what: str, dur_ns: int, nbytes: int,
               sp: "Span | None" = None, trace_id: int = 0) -> None:
    """A spill-path event. Attribution is EXPLICIT only: the owner's span
    (memmgr's registration-captured one) or the owning conf's trace id
    (spill containers carry conf) — never the executing thread's ambient
    span, which during a cross-thread spill belongs to a FOREIGN task."""
    if core._mode == MODE_OFF:
        return
    if sp is not None:
        trace, tid, sid = sp.trace, sp.trace_id, sp.span_id
    else:
        trace, tid, sid = get_trace(trace_id), int(trace_id), 0
    core.record("spill", what, dur_ns, tid, sid, 0,
                {"consumer": consumer, "bytes": int(nbytes)})
    if trace is not None and what == "spill" and core._mode == MODE_TRACE:
        trace.note_spill(dur_ns, nbytes)


def note_harvest(n: int, dur_ns: int) -> None:
    """One async-transfer window harvest (runtime/transfer.py)."""
    if core._mode == MODE_OFF:
        return
    _, tid, sid = _span_ids()
    core.record("transfer", "harvest", dur_ns, tid, sid, 0, {"n": n})


def note_transfer_start(n: int) -> None:
    if core._mode == MODE_OFF:
        return
    _, tid, sid = _span_ids()
    core.record("transfer", "start", 0, tid, sid, 0, {"n": n})


def note_pump_batch() -> None:
    """One batch through a task pump (runtime/task.py)."""
    if core._mode == MODE_OFF:
        return
    trace, tid, sid = _span_ids()
    core.record("pump", "batch", 0, tid, sid, 0, None)
    if trace is not None and core._mode == MODE_TRACE:
        trace.note_batch()


if core.KILLED:  # no-obs baseline: rebind facade to no-ops
    def _noop(*a, **k) -> None:
        return None

    note_op = note_sync = note_compile = note_spill = _noop  # noqa: F811
    note_harvest = note_transfer_start = note_pump_batch = _noop  # noqa: F811
    apply_conf = _noop  # noqa: F811
