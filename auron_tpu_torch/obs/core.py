"""Flight-recorder core: mode switch + per-thread event rings (port of
``auron_tpu/obs/core.py``, verbatim but for the imports).

The recorder's job is to keep the *last N events per thread* available at
all times for near-zero cost, so a production incident can be examined
after the fact (the Dapper/Canopy "cheap always-on sampling" posture,
PAPERS.md) without having had tracing "on". Three modes:

- ``off``      — every instrumentation site short-circuits on one module
                 global; nothing is recorded.
- ``recorder`` — the default: events land in a lock-free (GIL-append)
                 per-thread ring buffer with bounded memory; the last
                 ring-full of events per thread is always retrievable
                 (``/trace?last=...`` on the HTTP service).
- ``trace``    — full tracing: same rings, plus per-query ``Trace``
                 accumulators feed exportable per-query summaries and the
                 span-vs-metrics cross-check (obs/span.py).

``AURON_TPU_OBS_KILL=1`` is the obscheck *baseline* switch: at import the
public facade in ``auron_tpu_torch.obs`` is rebound to true no-ops, so a replay
under it measures the engine without instrumentation.

Threading: ``record()`` touches only the calling thread's ring (created
lazily); the registry of rings is locked ONLY at ring creation and at
snapshot — never on the event path. Ring memory is bounded two ways:
each ring holds at most ``ring_capacity`` events, and the registry keeps
at most ``_MAX_RINGS`` rings, evicting the stalest dead-thread ring
first (a finished task's recent events stay readable until they age out).
"""

from __future__ import annotations

import itertools
import os
import threading
import time

MODE_OFF, MODE_RECORDER, MODE_TRACE = 0, 1, 2
_MODE_NAMES = {"off": MODE_OFF, "recorder": MODE_RECORDER, "trace": MODE_TRACE}

#: hard baseline switch: no instrumentation at all (see module docstring)
KILLED = os.environ.get("AURON_TPU_OBS_KILL", "") == "1"


def _initial_mode() -> int:
    if KILLED:
        return MODE_OFF
    m = os.environ.get("AURON_TPU_OBS_MODE", "recorder").strip().lower()
    return _MODE_NAMES.get(m, MODE_RECORDER)


#: THE hot-path flag; instrumentation sites read it as ``core._mode``
_mode = _initial_mode()


def mode() -> int:
    return _mode


def mode_name() -> str:
    return {v: k for k, v in _MODE_NAMES.items()}[_mode]


def set_mode(m: int | str) -> None:
    """Switch the process-wide recording mode ("off"|"recorder"|"trace")."""
    global _mode
    if KILLED:
        return
    if isinstance(m, str):
        if m.strip().lower() not in _MODE_NAMES:
            raise ValueError(f"unknown obs mode {m!r}")
        m = _MODE_NAMES[m.strip().lower()]
    _mode = int(m)


# ---------------------------------------------------------------------------
# per-thread rings
# ---------------------------------------------------------------------------

_MAX_RINGS = 256
#: dead-thread rings older than this are pruned at snapshot/creation
_RETENTION_NS = 300 * 1_000_000_000

# SAME env name the Configuration system derives for obs.recorder.events:
# one knob whether set via env or session conf (obs.apply_conf)
_ring_capacity = int(os.environ.get("AURON_TPU_OBS_RECORDER_EVENTS", "32768"))


def set_ring_capacity(cap: int) -> None:
    """Capacity for rings created AFTER this call (existing rings keep
    theirs — resizing a live ring would race its owner thread)."""
    global _ring_capacity
    _ring_capacity = max(256, int(cap))


class _Ring:
    __slots__ = ("buf", "idx", "cap", "tid", "ident", "tname", "last_ns")

    def __init__(self, tid: int, cap: int):
        self.buf: list = [None] * cap
        self.idx = 0
        self.cap = cap
        self.tid = tid
        t = threading.current_thread()
        self.ident = t.ident
        self.tname = t.name
        self.last_ns = time.perf_counter_ns()


_tls = threading.local()
_reg_lock = threading.Lock()
_rings: list[_Ring] = []
_ring_seq = itertools.count(1)


def _live_idents() -> set:
    return {t.ident for t in threading.enumerate()}


def _make_ring() -> _Ring:
    with _reg_lock:
        if len(_rings) >= _MAX_RINGS:
            # evict the stalest DEAD-thread ring only. A live thread's
            # ring must never leave the registry — its owner would keep
            # recording into an orphan invisible to every export. With
            # no dead rings the registry simply grows: it is bounded by
            # the live thread count, which is a process-level bound
            # already (each thread's ring is just its buffer)
            live = _live_idents()
            dead = [r for r in _rings if r.ident not in live]
            if dead:
                _rings.remove(min(dead, key=lambda r: r.last_ns))
        r = _Ring(next(_ring_seq), _ring_capacity)
        _rings.append(r)
    _tls.ring = r
    return r


def record(kind: str, name: str, dur_ns: int, trace_id: int,
           span_id: int, parent_id: int, arg=None) -> None:
    """Append one event to the calling thread's ring. Callers MUST have
    checked ``core._mode`` already — this function does not re-check.
    Event layout (a plain tuple, cheapest thing Python has):
    ``(ts_start_ns, dur_ns, kind, name, trace_id, span_id, parent_id, arg)``.
    """
    r = getattr(_tls, "ring", None)
    if r is None:
        r = _make_ring()
    now = time.perf_counter_ns()
    i = r.idx
    r.buf[i % r.cap] = (now - dur_ns, dur_ns, kind, name,
                        trace_id, span_id, parent_id, arg)
    r.idx = i + 1
    r.last_ns = now


def _prune_locked(now_ns: int) -> None:
    live = _live_idents()
    _rings[:] = [
        r for r in _rings
        if r.ident in live or now_ns - r.last_ns < _RETENTION_NS
    ]


def snapshot_events(last_s: float | None = None,
                    trace_id: int | None = None) -> list[tuple[dict, list]]:
    """Best-effort copy of every ring's events, oldest-first per ring,
    optionally limited to the last ``last_s`` seconds and/or one trace.
    Returns ``[(ring_info, [event, ...]), ...]``. Concurrent writers may
    overwrite a slot mid-copy; the copy simply reflects whichever event
    won — the recorder trades a perfectly consistent snapshot for a
    lock-free hot path."""
    now = time.perf_counter_ns()
    cut = None if last_s is None else now - int(float(last_s) * 1e9)
    with _reg_lock:
        _prune_locked(now)
        rings = list(_rings)
    out = []
    for r in rings:
        idx, cap = r.idx, r.cap
        buf = list(r.buf)  # one GIL-atomic-ish copy, then filter
        if idx >= cap:
            start = idx % cap
            ordered = buf[start:] + buf[:start]
        else:
            ordered = buf[:idx]
        evs = [
            ev for ev in ordered
            if ev is not None
            and (cut is None or ev[0] + ev[1] >= cut)
            and (trace_id is None or ev[4] == trace_id)
        ]
        if evs:
            out.append(({"tid": r.tid, "name": r.tname}, evs))
    return out


def reset_for_tests() -> None:
    """Drop all rings (test isolation only — not part of the API)."""
    with _reg_lock:
        _rings.clear()
    # each thread's _tls.ring is dropped lazily: a stale thread-local ring
    # keeps recording but is no longer exported
    if getattr(_tls, "ring", None) is not None:
        _tls.ring = None
