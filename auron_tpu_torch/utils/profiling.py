"""Engine-level counters: compiles and host reads (port of
``auron_tpu/utils/profiling.py``; same snapshot keys).

The per-operator metric tree cannot see two engine-level costs. On the
card they are:

- a **compile**: something new the card has to be prepared for. That is
  a CUDA graph capture of a fused stage (``plan/fusion.py``) or an nvcc
  build of a kernel source (``ops/cuda_build.py``); both call
  ``note_compile``;
- a **host read**: a device-to-host read at the port's own read points,
  ``runtime/transfer.py``. A blocking read (``blocking_read``) and a
  harvest that had to wait on its copy's event (``waited_reads``,
  ``drain_waits``) are host syncs; a harvest whose copy had already
  landed is an ``async_read``. Both call ``note_read``.

Nothing is patched: neither ``torch.Tensor`` nor anything else. The
counters count only while installed (``EngineCounters.install()``); the
span timeline (``obs``) records each event whether or not they are.

Thread safety: reads arrive from task pumps, spill threads and transfer
harvests concurrently; all counter state is guarded by one lock.
"""

from __future__ import annotations

import threading

from auron_tpu_torch import obs

#: a read longer than this is attributed to its site
_STALL_S = 0.001


class EngineCounters:
    """Process-wide compile/read counters. install() is idempotent per
    process; read the totals from .snapshot()."""

    _installed: "EngineCounters | None" = None

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.compiles = 0
        self.compile_s = 0.0
        self.syncs = 0
        self.sync_s = 0.0
        # harvests whose copy had landed; separated so host_syncs
        # measures stalls, not reads
        self.async_reads = 0
        self.async_read_s = 0.0
        # batches pumped through task runtimes (per-batch denominator)
        self.batches = 0
        # per-call-site stall attribution (engine frame nearest the read)
        self.sync_sites: dict[str, list] = {}
        # per-OPERATOR stall attribution: the innermost live ExecOperator
        # frame at the moment of the stall (a producer suspended at
        # ``yield`` is not on the stack, so a consumer's stall never books
        # under its producer)
        self.op_sync: dict[str, list] = {}

    def _find_site(self) -> tuple[str, str | None]:
        """(nearest engine frame, innermost ExecOperator class name) — one
        stack walk, outside the lock. The read points themselves
        (``runtime/transfer.py``) are skipped: the site is their caller."""
        import sys as _sys

        try:
            from auron_tpu_torch.exec.base import ExecOperator as _EO
        except Exception:  # pragma: no cover — partial-import windows
            _EO = None
        site = None
        op = None
        f = _sys._getframe(2)
        while f is not None:
            fn = f.f_code.co_filename
            if ("auron_tpu_torch" in fn and "utils/profiling" not in fn
                    and "runtime/transfer" not in fn):
                if site is None:
                    site = f"{fn.rsplit('auron_tpu_torch/', 1)[-1]}:{f.f_lineno}"
                if op is None and _EO is not None:
                    slf = f.f_locals.get("self")
                    if isinstance(slf, _EO):
                        op = type(slf).__name__
                if site is not None and op is not None:
                    break
            f = f.f_back
        return site or "?", op

    def _record_site(self, dt: float) -> None:
        site, op = self._find_site()
        with self._lock:
            ent = self.sync_sites.setdefault(site, [0, 0.0])
            ent[0] += 1
            ent[1] += dt
            if op is not None:
                oent = self.op_sync.setdefault(op, [0, 0.0])
                oent[0] += 1
                oent[1] += dt

    @classmethod
    def install(cls) -> "EngineCounters":
        if cls._installed is None:
            cls._installed = cls()
        return cls._installed

    def _compile(self, dt: float) -> None:
        with self._lock:
            self.compiles += 1
            self.compile_s += dt

    def _read(self, dt: float, is_async: bool) -> None:
        with self._lock:
            if is_async:
                self.async_reads += 1
                self.async_read_s += dt
            else:
                self.syncs += 1
                self.sync_s += dt
        if dt > _STALL_S:
            self._record_site(dt)

    def note_batch(self) -> None:
        with self._lock:
            self.batches += 1

    def snapshot(self) -> dict:
        with self._lock:
            sites = {k: [v[0], v[1]] for k, v in self.sync_sites.items()}
            ops = {k: [v[0], v[1]] for k, v in self.op_sync.items()}
            out = {
                "compiles": self.compiles,
                "compile_s": round(self.compile_s, 3),
                "host_syncs": self.syncs,
                "host_sync_s": round(self.sync_s, 3),
                "async_reads": self.async_reads,
                "async_read_s": round(self.async_read_s, 3),
                "batches": self.batches,
            }
        top = sorted(sites.items(), key=lambda kv: -kv[1][1])[:10]
        out["sync_sites"] = {k: [v[0], round(v[1], 3)] for k, v in top}
        otop = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
        out["op_sync"] = {k: [v[0], round(v[1], 3)] for k, v in otop}
        return out


def note_compile(seconds: float, what: str) -> None:
    """One compile (a graph capture or a kernel build) of ``seconds``."""
    counters = EngineCounters._installed
    if counters is not None:
        counters._compile(seconds)
    obs.note_compile(int(seconds * 1e9), what)


def note_read(seconds: float, is_async: bool) -> None:
    """One device-to-host read of ``seconds``: a host sync, or with
    ``is_async`` an async-window harvest whose copy had landed."""
    counters = EngineCounters._installed
    if counters is not None:
        counters._read(seconds, is_async)
    obs.note_sync(int(seconds * 1e9), is_async)
