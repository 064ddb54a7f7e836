"""Query/task-scoped spans and per-query trace accumulators (port of
``auron_tpu/obs/span.py``; only the imports differ).

Span model: a ``Trace`` is one query's (or one
standalone task's) identity — an integer id threaded through the stack
the same way a task's ``Configuration`` is: explicitly,
never via ambient thread state that a foreign thread would misread. A
``Span`` is one timed region inside a trace (sql.parse, a task pump, a
spill). The *current* span rides a ``contextvars.ContextVar`` so
everything running on the opening thread attributes automatically;
crossing a thread hop requires an explicit hand-off:

- same thread / nested calls         -> nothing to do (contextvar)
- task dispatch (bridge call_native) -> TaskRuntime captures the caller's
  span and re-installs it on the pump thread (runtime/task.py)
- spill dispatch                     -> MemManager captures the OWNING
  task's span at consumer registration and installs it around spill()
  (memory/memmgr.py), so a spill performed by a foreign thread still
  lands in the owner's trace
- async-transfer harvest             -> TransferWindow captures the span
  at push() and installs it at harvest (runtime/transfer.py)
- spill containers                   -> carry the owning conf, and with
  it ``obs.trace.id`` (conf-id attribution, no live Span needed)

Every accumulator mutation on a ``Trace`` takes the trace's own lock:
events arrive from pump threads, spill threads and harvest threads
concurrently.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from collections import deque

from auron_tpu_torch.obs import core

_span_var: contextvars.ContextVar = contextvars.ContextVar(
    "auron_obs_span", default=None
)

_id_seq = itertools.count(1)
_span_seq = itertools.count(1)

_traces_lock = threading.Lock()
_traces: dict[int, "Trace"] = {}

#: recent per-query summary records served at /queries (newest last);
#: maxlen is fixed at module load — obs.queries.keep resizes via
#: set_queries_keep (utils/config value applied by query_trace)
_recent: deque = deque(maxlen=64)
_recent_lock = threading.Lock()


def set_queries_keep(n: int) -> None:
    global _recent
    n = max(1, int(n))
    with _recent_lock:
        if _recent.maxlen != n:
            _recent = deque(_recent, maxlen=n)


def recent_queries() -> list[dict]:
    """Most-recent-first summaries of finished query traces."""
    with _recent_lock:
        return list(reversed(_recent))


class Span:
    __slots__ = ("trace", "trace_id", "span_id", "parent_id",
                 "name", "cat", "t0_ns")

    def __init__(self, name: str, cat: str, trace: "Trace | None",
                 trace_id: int, parent_id: int):
        self.name = name
        self.cat = cat
        self.trace = trace
        self.trace_id = trace_id
        self.span_id = next(_span_seq)
        self.parent_id = parent_id
        self.t0_ns = time.perf_counter_ns()


class Trace:
    """Per-query accumulator. Two independent per-operator accountings
    live here ON PURPOSE (the cross-check the q5 misattribution needed):

    - ``op_totals``   — MetricNode snapshot rollups folded in at task
      finalize (the engine's existing accounting);
    - ``span_op_ns``  — the same timers, accumulated from the live timer
      *events* as they happen (the span timeline's accounting).

    the gates and tests compare the two through
    ``op_seconds_skew``; they agree exactly when every thread hop was
    threaded, so divergence means a hop lost its span.

    Per-EVENT accumulation (span_op_ns, sync/compile/spill/batch
    counters) happens only in TRACE mode — recorder mode never takes
    this lock on a hot path; its summaries carry the per-task side
    (wall, tasks, op_seconds from finalize rollups) with the event
    counters at zero."""

    __slots__ = ("id", "name", "kind", "t0_ns", "_lock",
                 "syncs", "sync_ns", "async_reads", "async_ns",
                 "compiles", "compile_ns",
                 "spills", "spill_ns", "spill_bytes",
                 "batches", "tasks", "op_totals", "span_op_ns", "closed")

    def __init__(self, name: str, kind: str = "query"):
        self.id = next(_id_seq)
        self.name = name
        self.kind = kind
        self.t0_ns = time.perf_counter_ns()
        self._lock = threading.Lock()
        self.syncs = 0
        self.sync_ns = 0
        self.async_reads = 0
        self.async_ns = 0
        self.compiles = 0
        self.compile_ns = 0
        self.spills = 0
        self.spill_ns = 0
        self.spill_bytes = 0
        self.batches = 0
        self.tasks = 0
        self.op_totals: dict[str, dict[str, int]] = {}
        self.span_op_ns: dict[str, dict[str, int]] = {}
        self.closed = False

    # -- accumulators (all cross-thread; every write under self._lock) --

    def note_sync(self, dur_ns: int, is_async: bool) -> None:
        with self._lock:
            if is_async:
                self.async_reads += 1
                self.async_ns += dur_ns
            else:
                self.syncs += 1
                self.sync_ns += dur_ns

    def note_compile(self, dur_ns: int) -> None:
        with self._lock:
            self.compiles += 1
            self.compile_ns += dur_ns

    def note_spill(self, dur_ns: int, nbytes: int) -> None:
        with self._lock:
            self.spills += 1
            self.spill_ns += dur_ns
            self.spill_bytes += int(nbytes)

    def note_batch(self) -> None:
        with self._lock:
            self.batches += 1

    def note_op(self, op: str, metric: str, dur_ns: int) -> None:
        op = op.partition(".")[0] or "<node>"
        with self._lock:
            tot = self.span_op_ns.setdefault(op, {})
            tot[metric] = tot.get(metric, 0) + dur_ns

    def add_task_metrics(self, snapshot: dict) -> None:
        from auron_tpu_torch.exec.metrics import MetricNode

        with self._lock:
            self.tasks += 1
            MetricNode.accumulate_op_totals(snapshot, self.op_totals)

    # -- readers --

    def metric_op_seconds(self) -> dict[str, float]:
        """Per-op timer seconds from the finalize-time metric rollup —
        THE shared MetricNode.op_seconds definition."""
        from auron_tpu_torch.exec.metrics import MetricNode

        with self._lock:
            return {op: MetricNode.op_seconds(tot)
                    for op, tot in self.op_totals.items()}

    def span_op_seconds(self) -> dict[str, float]:
        """Per-op timer seconds re-derived from span-timeline events."""
        from auron_tpu_torch.exec.metrics import MetricNode

        with self._lock:
            return {op: MetricNode.op_seconds(tot)
                    for op, tot in self.span_op_ns.items()}

    def op_seconds_skew(self, min_s: float = 0.05) -> dict:
        """Cross-check the two accountings: max relative divergence over
        operators with at least ``min_s`` of metric time."""
        metric = self.metric_op_seconds()
        span = self.span_op_seconds()
        worst = 0.0
        worst_op = None
        compared = 0
        for op, ms in metric.items():
            if ms < min_s:
                continue
            compared += 1
            skew = abs(span.get(op, 0.0) - ms) / ms
            if skew > worst:
                worst, worst_op = skew, op
        # ``compared`` lets gate consumers reject a VACUOUS pass (nothing
        # crossed min_s) — worst_op alone is also None on exact agreement
        return {"max_skew_pct": round(100.0 * worst, 2), "op": worst_op,
                "compared": compared, "ok": worst <= 0.05}

    def summary(self) -> dict:
        wall_ns = time.perf_counter_ns() - self.t0_ns
        ops = self.metric_op_seconds()
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:5]
        with self._lock:
            return {
                "trace_id": self.id,
                "name": self.name,
                "kind": self.kind,
                "wall_s": round(wall_ns / 1e9, 4),
                "tasks": self.tasks,
                "batches": self.batches,
                "op_seconds": {k: round(v, 4) for k, v in ops.items()},
                "top_ops": {k: round(v, 4) for k, v in top},
                "host_syncs": self.syncs,
                "host_sync_s": round(self.sync_ns / 1e9, 4),
                "async_reads": self.async_reads,
                "async_read_s": round(self.async_ns / 1e9, 4),
                "compiles": self.compiles,
                "compile_s": round(self.compile_ns / 1e9, 4),
                "spills": self.spills,
                "spill_s": round(self.spill_ns / 1e9, 4),
                "spill_bytes": self.spill_bytes,
            }


def get_trace(trace_id: int) -> Trace | None:
    """Live trace by id (conf-threaded ``obs.trace.id`` resolution)."""
    if not trace_id:
        return None
    with _traces_lock:
        return _traces.get(int(trace_id))


def current_span() -> Span | None:
    return _span_var.get()


def current_trace() -> Trace | None:
    sp = _span_var.get()
    return sp.trace if sp is not None else None


_UNSET = object()


class span:
    """Open a child span for a ``with`` region. ``parent`` defaults to the
    calling thread's current span; pass ``parent=``/``trace=`` explicitly
    when opening on a new thread (the task pump). No-ops in mode off."""

    __slots__ = ("name", "cat", "arg", "sp", "_tok")

    def __init__(self, name: str, cat: str = "", arg=None,
                 parent=_UNSET, trace: Trace | None = None):
        self.name = name
        self.cat = cat
        self.arg = arg
        if parent is _UNSET:
            parent = None if core._mode == core.MODE_OFF else _span_var.get()
        if trace is None and parent is not None:
            trace = parent.trace
        self.sp = (parent, trace)
        self._tok = None

    def __enter__(self) -> Span | None:
        if core._mode == core.MODE_OFF:
            self.sp = None
            return None
        parent, trace = self.sp
        tid = trace.id if trace is not None else (
            parent.trace_id if parent is not None else 0
        )
        sp = Span(self.name, self.cat, trace, tid,
                  parent.span_id if parent is not None else 0)
        self.sp = sp
        self._tok = _span_var.set(sp)
        return sp

    def __exit__(self, *exc):
        sp = self.sp
        if sp is None:
            return False
        if self._tok is not None:
            _span_var.reset(self._tok)
        if core._mode != core.MODE_OFF:
            core.record("span", sp.name, time.perf_counter_ns() - sp.t0_ns,
                        sp.trace_id, sp.span_id, sp.parent_id, self.arg)
        return False


class use_span:
    """Install an EXISTING span on this thread (the cross-thread hand-off
    primitive: spill dispatch, transfer harvest). ``use_span(None)``
    CLEARS the ambient span — work owned by an untraced producer must not
    attribute to whatever foreign span the executing thread happens to
    carry (the misattribution this subsystem exists to kill)."""

    __slots__ = ("sp", "_tok")

    def __init__(self, sp: Span | None):
        self.sp = sp
        self._tok = None

    def __enter__(self):
        self._tok = _span_var.set(self.sp)
        return self.sp

    def __exit__(self, *exc):
        if self._tok is not None:
            _span_var.reset(self._tok)
        return False


class query_trace:
    """Open a query-scoped trace: registers a live ``Trace``, installs a
    conf scope carrying ``obs.trace.id`` (so task/spill confs attribute),
    and opens the root span on the calling thread. On exit the trace's
    summary lands in the recent-queries ring (``/queries``).

    Inert in mode off — ``.trace`` stays None and nothing records."""

    def __init__(self, name: str, conf=None, keep: bool = True):
        self.name = name
        self.keep = keep
        self.trace: Trace | None = None
        self.summary: dict | None = None
        #: the conf actually installed (base conf + obs.trace.id) — pass
        #: it to runners that take an EXPLICIT conf instead of reading
        #: the ambient scope (sqlgate's execute)
        self.conf = None
        self._conf = conf
        self._cs = None
        self._root = None

    def __enter__(self) -> "query_trace":
        if core._mode == core.MODE_OFF:
            return self
        from auron_tpu_torch.obs import OBS_TRACE_ID
        from auron_tpu_torch.utils.config import active_conf, conf_scope

        tr = Trace(self.name)
        with _traces_lock:
            _traces[tr.id] = tr
        self.trace = tr
        conf = (self._conf if self._conf is not None
                else active_conf()).copy().set(OBS_TRACE_ID, tr.id)
        self.conf = conf
        # NOTE: the /queries ring is process-global; its size is applied
        # by obs.apply_conf (session-set only), NOT per query — one
        # query's conf must not truncate every other session's history
        self._cs = conf_scope(conf)
        self._cs.__enter__()
        self._root = span(self.name, cat="query", parent=None, trace=tr)
        self._root.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.trace is None:
            return False
        self._root.__exit__(exc_type, exc, tb)
        self._cs.__exit__(exc_type, exc, tb)
        with _traces_lock:
            _traces.pop(self.trace.id, None)
        self.trace.closed = True
        self.summary = self.trace.summary()
        # a query that died must not masquerade as a fast success in the
        # /queries ring — operators triage from these entries
        self.summary["error"] = (
            None if exc_type is None
            else f"{exc_type.__name__}: {exc}"[:200]
        )
        if self.keep:
            with _recent_lock:
                _recent.append(self.summary)
        return False
