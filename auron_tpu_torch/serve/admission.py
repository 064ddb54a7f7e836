"""Admission control: share the executor pool, queue instead of dying
(port of ``auron_tpu/serve/admission.py``; only the imports differ).

Two gates in front of every query:

- a CONCURRENCY slot (``serve.admission.max.concurrent``): admitted
  queries interleave on one card, each on its own CUDA stream, so the
  bound shapes memory pressure and host-thread contention (the reference
  bounds the same thing with per-task tokio runtimes drawing from one
  pool);
- MEMORY headroom (``serve.admission.memory.fraction``): while the
  memory manager's consumers already hold more than the configured
  fraction of its budget, new queries WAIT in the queue. Queries already
  admitted keep running — the memory manager degrades them to spilling
  per its fair shares (memory/memmgr.py) — but the server stops stacking
  new concurrent builds onto an overcommitted pool ("queue, don't die").

Waiters poll the pool state on a short condition-variable tick: spills
and consumer unregistration happen inside the memory manager, which has
no hook back into the server, and slot releases notify directly. A query
that outwaits ``serve.admission.queue.timeout.seconds`` fails with
:class:`AdmissionTimeout` (HTTP 503) — bounded queueing, never a hang.
"""

from __future__ import annotations

import threading
import time

from auron_tpu_torch.utils.config import (
    SERVE_ADMIT_MEM_FRACTION,
    SERVE_MAX_CONCURRENT,
    SERVE_QUEUE_TIMEOUT_S,
    Configuration,
)

#: condition-variable tick while waiting on MEMORY headroom (slot
#: releases notify immediately; memmgr releases have no server hook)
_POLL_S = 0.05


class AdmissionTimeout(RuntimeError):
    """The admission queue's bound fired; the caller answers busy (503)."""


class AdmissionController:
    """Concurrency + memory admission; thread-safe (every handler thread
    goes through admit(), all state under one lock)."""

    def __init__(self, conf: Configuration):
        self.max_concurrent = max(1, conf.get(SERVE_MAX_CONCURRENT))
        self.queue_timeout_s = float(conf.get(SERVE_QUEUE_TIMEOUT_S))
        self.mem_fraction = float(conf.get(SERVE_ADMIT_MEM_FRACTION))
        self._lock = threading.Lock()
        self._released = threading.Condition(self._lock)
        self.running = 0
        self.admitted = 0
        self.queued = 0         # admissions that had to wait at all
        self.timeouts = 0
        self.peak_running = 0
        self.peak_queue = 0
        self._waiting = 0
        self.queue_wait_s = 0.0

    # ------------------------------------------------------------------

    def _mem_ok(self) -> bool:
        from auron_tpu_torch.memory.memmgr import MemManager

        mgr = MemManager.get()
        budget = mgr.budget
        if budget <= 0:
            return True
        return mgr.total_used() <= self.mem_fraction * budget

    def admit(self):
        """Context manager: blocks until a slot AND memory headroom are
        available (or AdmissionTimeout). Usage::

            with admission.admit():
                ... execute the query ...
        """
        return _Admit(self)

    def _acquire(self) -> float:
        """Returns seconds spent queued."""
        t0 = time.perf_counter()
        deadline = t0 + self.queue_timeout_s
        waited = False
        with self._lock:
            while True:
                if self.running < self.max_concurrent and self._mem_ok():
                    self.running += 1
                    self.admitted += 1
                    self.peak_running = max(self.peak_running, self.running)
                    if waited:
                        self.queued += 1
                    wait_s = time.perf_counter() - t0
                    self.queue_wait_s += wait_s
                    return wait_s
                now = time.perf_counter()
                if now >= deadline:
                    self.timeouts += 1
                    raise AdmissionTimeout(
                        f"admission queue timeout after "
                        f"{self.queue_timeout_s:.1f}s "
                        f"(running={self.running}/{self.max_concurrent}, "
                        f"mem_ok={self._mem_ok()})"
                    )
                waited = True
                self._waiting += 1
                self.peak_queue = max(self.peak_queue, self._waiting)
                try:
                    # short tick: memory releases don't notify this cv
                    self._released.wait(min(_POLL_S, deadline - now))
                finally:
                    self._waiting -= 1

    def _release(self) -> None:
        with self._lock:
            self.running -= 1
            self._released.notify_all()

    def stats(self) -> dict:
        with self._lock:
            return {
                "max_concurrent": self.max_concurrent,
                "running": self.running,
                "waiting": self._waiting,
                "admitted": self.admitted,
                "queued": self.queued,
                "timeouts": self.timeouts,
                "peak_running": self.peak_running,
                "peak_queue": self.peak_queue,
                "queue_wait_s": round(self.queue_wait_s, 4),
            }


class _Admit:
    __slots__ = ("_ctl", "wait_s")

    def __init__(self, ctl: AdmissionController):
        self._ctl = ctl
        self.wait_s = 0.0

    def __enter__(self) -> "_Admit":
        self.wait_s = self._ctl._acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self._ctl._release()
        return False
