"""Device-memory budget manager with spillable consumers (port of
``auron_tpu/memory/memmgr.py``).

A process-wide budget (total x ``memory.fraction``) that stateful
operators register with as consumers: sort runs, aggregate states,
shuffle staging, join builds. Unspillable consumers (a join build the
probe needs, a dense aggregate table) register too, so that their bytes
shrink the managed pool the others fair-share (``_pool_state``). Growth
follows the JAX package's two protocols:

- ``update_mem_used``: fair-share limits (max = managed / spillables,
  min = max / 8); a consumer over its share spills itself, one under its
  min share waits for siblings to release, and spills when the wait times
  out (``memory.wait.timeout.seconds``);
- ``acquire``: the cascade the operators use before each staged batch —
  the largest other spillable consumers spill first, the requester last.
  The manager's lock is never held across a consumer's ``spill()``; the
  lock order is manager, then consumer.

Spill tiers: device tensors -> host RAM (``HostSpill``: encoded blocks
kept in RAM, demoted to disk when the process ledger passes
``memory.host.spill.budget.bytes``) -> local disk (``DiskSpill``). A
container holds batches in the shuffle's v2 block format
(``exec/shuffle/format.py`` ``encode_block`` / ``decode_block``, dictionary
strings as ENC_DICT), with the shuffle writer's general codec
(``fallback_codec``: auto = ``spill.compression.codec``, lz4), so spills
compress as the reference's do (``memmgr.py:320-332``); an unavailable
codec degrades with the shuffle writer's single warning.

Observability as in the JAX package (``memmgr.py:133-207``, ``:300-306``,
``:330-470``): a consumer's owning span is captured at ``register`` and a
spill runs under it (``_dispatch_spill``), so a spill another task's
thread dispatches lands in the owner's trace; the containers' writes and
demotions note ``obs.note_spill`` with the trace id their conf carries
(``_conf_trace_id``). ``SPILL_STATS`` counts what the spills park.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Iterator, Protocol

import numpy as np
import torch

from auron_tpu_torch import obs
from auron_tpu_torch.utils.config import (
    HBM_BUDGET_BYTES, HOST_SPILL_BUDGET_BYTES, MEM_WAIT_TIMEOUT_S, MEMORY_FRACTION, active_conf,
)

# growth below this never triggers spill/wait (reference MIN_TRIGGER_SIZE)
_MIN_TRIGGER_BYTES = 1 << 20

#: bytes the spill containers parked, by tier, and the host ledger's
#: demotions; cumulative over the process (a caller zeroes them to read
#: one run, as with the kernels' LAUNCHES)
SPILL_STATS = {"host_bytes": 0, "disk_bytes": 0, "demotions": 0, "demoted_bytes": 0}
_stats_lock = threading.Lock()


def count_spill(**deltas: int) -> None:
    with _stats_lock:
        for k, v in deltas.items():
            SPILL_STATS[k] += v


def _auto_budget() -> int:
    """``memory.hbm.budget.bytes`` = 0: the card's memory where CUDA is
    available, else half the physical RAM (CPU tensors live in host RAM;
    no floor, so a small host spills instead of running out)."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory)
    try:
        return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2
    except (ValueError, OSError):
        return 8 << 30


class MemConsumer(Protocol):
    name: str

    def mem_used(self) -> int: ...

    def spill(self) -> int:
        """Release memory; returns bytes freed."""
        ...


class MemManager:
    _instance: "MemManager | None" = None

    def __init__(self, budget_bytes: int | None = None):
        # built from the ambient conf: init() runs at session setup under
        # the session's scope, a lazy get() sees the global conf
        conf = active_conf()
        # 0 = auto applies to the conf default only; an explicit
        # budget_bytes=0 is an intentional always-spill manager
        total = (budget_bytes if budget_bytes is not None
                 else (conf.get(HBM_BUDGET_BYTES) or _auto_budget()))
        self.budget = int(total * conf.get(MEMORY_FRACTION))
        self._lock = threading.RLock()
        self._released = threading.Condition(self._lock)
        self._consumers: list[MemConsumer] = []
        self._spillable: dict[int, bool] = {}
        # owning span captured at register(): registration happens on the
        # owning task's thread, so a spill dispatched later by a foreign
        # thread still attributes to the owner's trace
        self._owner_spans: dict[int, object] = {}
        self.num_spills = 0
        self.num_waits = 0
        self._wait_timeout = float(conf.get(MEM_WAIT_TIMEOUT_S))

    # ---- lifecycle ----

    @classmethod
    def init(cls, budget_bytes: int | None = None) -> "MemManager":
        cls._instance = MemManager(budget_bytes)
        return cls._instance

    @classmethod
    def get(cls) -> "MemManager":
        if cls._instance is None:
            cls._instance = MemManager()
        return cls._instance

    # ---- consumer API ----

    def register(self, consumer: MemConsumer, spillable: bool = True) -> None:
        with self._lock:
            self._consumers.append(consumer)
            self._spillable[id(consumer)] = spillable
            self._owner_spans[id(consumer)] = obs.current_span()

    def unregister(self, consumer: MemConsumer) -> None:
        with self._lock:
            if consumer in self._consumers:
                self._consumers.remove(consumer)
            self._spillable.pop(id(consumer), None)
            self._owner_spans.pop(id(consumer), None)
            # freed capacity: wake waiters blocked on the managed pool
            self._released.notify_all()

    def notify_released(self) -> None:
        """Consumers call this after shrinking, so waiters in
        update_mem_used re-check the pool."""
        with self._lock:
            self._released.notify_all()

    def total_used(self) -> int:
        with self._lock:
            return sum(c.mem_used() for c in self._consumers)

    def mem_snapshot(self) -> dict:
        """Budget, spill and wait counts and per-consumer usage, under the lock."""
        with self._lock:
            return {
                "budget_bytes": self.budget,
                "num_spills": self.num_spills,
                "num_waits": self.num_waits,
                "consumers": [{"name": c.name, "mem_used": c.mem_used()}
                              for c in self._consumers],
            }

    def _pool_state(self) -> tuple[int, int, int]:
        """(total_used, managed pool, spillables): the managed pool is the
        budget less the unspillable consumers' usage."""
        total_used = unspillable = n_spillables = 0
        for c in self._consumers:
            u = c.mem_used()
            total_used += u
            if self._spillable.get(id(c), True):
                n_spillables += 1
            else:
                unspillable += u
        return total_used, max(self.budget - unspillable, 0), max(n_spillables, 1)

    def mem_used_percent(self, consumer: MemConsumer) -> float:
        """The consumer's usage over its fair-share maximum."""
        with self._lock:
            _, managed, n = self._pool_state()
            return consumer.mem_used() / max(managed / n, 1)

    def _dispatch_spill(self, consumer: MemConsumer) -> int:
        """``consumer.spill()`` under the OWNING task's span (captured at
        register()), never the executing thread's ambient one; an
        owner-less consumer records untraced."""
        if obs.core._mode == obs.MODE_OFF:  # keep the no-obs path bare
            return consumer.spill()
        sp = self._owner_spans.get(id(consumer))
        t0 = time.perf_counter_ns()
        with obs.use_span(sp):
            freed = consumer.spill()
        if freed:
            # freed == 0 attempts are not spills (num_spills skips them too)
            obs.note_spill(consumer.name, "spill", time.perf_counter_ns() - t0, freed, sp=sp)
        return freed

    def update_mem_used(self, consumer: MemConsumer, old_used: int, new_used: int) -> None:
        """Fair-share growth: past the managed pool or its share a
        spillable consumer spills itself; under its min share (or
        unspillable) it waits for siblings, and spills on timeout."""
        if new_used <= old_used or new_used < _MIN_TRIGGER_BYTES:
            if new_used < old_used:
                self.notify_released()
            return
        with self._lock:
            spillable = self._spillable.get(id(consumer), True)
            total_used, managed, n = self._pool_state()
            consumer_max = managed // n
            consumer_min = consumer_max // 8
            if not (total_used > managed or new_used > consumer_max):
                return
            if not (spillable and new_used > consumer_min):
                self.num_waits += 1
                ok = self._released.wait_for(
                    lambda: self._pool_state()[0] <= self._pool_state()[1],
                    timeout=self._wait_timeout)
                if ok or not spillable:
                    return
        # the spill runs outside the manager lock (it takes the consumer's)
        if self._dispatch_spill(consumer):
            with self._lock:
                self.num_spills += 1
            self.notify_released()

    def acquire(self, consumer: MemConsumer, additional: int) -> None:
        """Declare intent to grow by ``additional`` bytes: the largest other
        spillable consumers spill first, the requester last. Victims are
        chosen under the lock and spilled outside it, the shortfall
        re-checked before each."""
        with self._lock:
            if self.total_used() + additional - self.budget <= 0:
                return
            others = sorted((c for c in self._consumers
                             if c is not consumer and self._spillable.get(id(c), True)),
                            key=lambda c: c.mem_used(), reverse=True)
            victims = others + ([consumer] if self._spillable.get(id(consumer), True) else [])
        for c in victims:
            with self._lock:
                needed = self.total_used() + additional - self.budget
                # a victim that unregistered meanwhile must not spill: its
                # spill would write a file nothing ever removes
                gone = c is not consumer and c not in self._consumers
            if needed <= 0:
                break
            if gone or c.mem_used() == 0:
                continue
            if c is not consumer:
                _settle_streams()
            if self._dispatch_spill(c):
                with self._lock:
                    self.num_spills += 1
        self.notify_released()


def _settle_streams() -> None:
    """Before a consumer of another task spills: that task's tensors may
    still be written on its own stream (concurrent task slots,
    ``models/tpcds.run_tasks_parallel``), and the spill reads them on this
    thread's, so every stream finishes first."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        from auron_tpu_torch.plan.fusion import _GRAPH_LOCK

        with _GRAPH_LOCK:  # no stage is being captured meanwhile
            torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# consumers of a task: every path out unregisters them
# ---------------------------------------------------------------------------


def register(ctx, consumer: MemConsumer, spillable: bool = True) -> MemManager:
    """Register ``consumer`` with the current manager and note it in the
    task's context, so that ``release_task_consumers`` can unregister and
    release it when its operator never reached its own ``finally`` (an
    abandoned stream)."""
    mm = MemManager.get()
    mm.register(consumer, spillable)
    with ctx.consumers_lock:
        ctx.consumers.append((mm, consumer))
    return mm


def release_task_consumers(ctx) -> None:
    """Unregister every consumer the task registered, and ``release()`` the
    ones that hold spill containers or files (idempotent)."""
    with ctx.consumers_lock:
        held, ctx.consumers[:] = list(ctx.consumers), []
    for mm, consumer in held:
        mm.unregister(consumer)
        release = getattr(consumer, "release", None)
        if release is not None:
            release()


# ---------------------------------------------------------------------------
# spill containers (host-RAM and disk tiers)
# ---------------------------------------------------------------------------


def encode_batch(b, conf) -> bytes:
    """The live rows of ``b`` as one length-prefixed v2 block, its planes
    under the owning task's general codec (``conf``: a spill runs on
    whichever thread the manager dispatches it from)."""
    from auron_tpu_torch.exec.shuffle.format import DictCodes, encode_block, fallback_codec

    codec = fallback_codec(conf) if conf is not None else None
    idx = torch.nonzero(b.device.sel).flatten()
    cols = []
    for i, f in enumerate(b.schema):
        vals = b.col_values(i)[idx].cpu().numpy()
        valid = b.col_validity(i)[idx].cpu().numpy()
        if f.dtype.is_dict_encoded:
            vals = DictCodes(vals, b.dicts[i])
        cols.append((vals, None if valid.all() else valid))
    return encode_block(b.schema, cols, codec=codec)


def decode_batches(data: bytes, schema, device) -> Iterator:
    """Each block of ``data`` as one batch on ``device`` (capacity bucketed)."""
    from auron_tpu_torch.columnar.batch import Batch, DeviceBatch, bucket_capacity
    from auron_tpu_torch.exec.shuffle.format import decode_block, iter_block_payloads

    for payload in iter_block_payloads(data):
        nrows, cols = decode_block(payload, schema)
        cap = bucket_capacity(nrows)
        values, validity, dicts = [], [], []
        for f, (vals, valid) in zip(schema, cols):
            vocab = None
            if f.dtype.is_dict_encoded:
                vals, vocab = vals.codes, vals.vocab
            v = np.zeros(cap, dtype=f.dtype.numpy_dtype())
            v[:nrows] = vals
            m = np.zeros(cap, dtype=bool)
            m[:nrows] = True if valid is None else valid
            values.append(torch.from_numpy(v).to(device))
            validity.append(torch.from_numpy(m).to(device))
            dicts.append(vocab)
        sel = torch.arange(cap, device=device) < nrows
        yield Batch(schema, DeviceBatch(sel, tuple(values), tuple(validity)), tuple(dicts))


def _conf_trace_id(conf) -> int:
    """The owning trace id a spill container's conf carries
    (``obs.trace.id``): the executing thread may be a foreign task's."""
    if conf is None:
        return 0
    try:
        return int(conf.get(obs.OBS_TRACE_ID))
    except Exception:  # noqa: BLE001 — a malformed id attributes to no trace
        return 0


class DiskSpill:
    """Disk tier: v2 blocks appended to a ``.spill`` temp file.

    ``conf``: the owning task's Configuration — a spill runs on whichever
    thread the manager dispatches it from, so its settings are threaded,
    not read from that thread's ``active_conf()``."""

    def __init__(self, spill_dir: str | None = None, *, conf):
        fd, self.path = tempfile.mkstemp(suffix=".spill", dir=spill_dir or tempfile.gettempdir())
        os.close(fd)
        self._conf = conf

    def write_block(self, blk: bytes) -> None:
        with open(self.path, "ab") as f:
            f.write(blk)
        count_spill(disk_bytes=len(blk))

    def write_batch(self, b) -> None:
        obs_on = obs.core._mode != obs.MODE_OFF
        t0 = time.perf_counter_ns() if obs_on else 0
        blk = encode_batch(b, self._conf)
        self.write_block(blk)
        if obs_on:
            obs.note_spill("DiskSpill", "write", time.perf_counter_ns() - t0, len(blk),
                           trace_id=_conf_trace_id(self._conf))

    def read_batches(self, schema, device) -> Iterator:
        with open(self.path, "rb") as f:
            data = f.read()
        yield from decode_batches(data, schema, device)

    def release(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


class _HostLedger:
    """Process-wide host-RAM spill bytes. Past the host budget the OLDEST
    resident HostSpills (the coldest) demote to disk first."""

    def __init__(self):
        self._lock = threading.Lock()
        self._resident: list["HostSpill"] = []
        self._bytes = 0

    def admit(self, spill: "HostSpill", nbytes: int, conf=None) -> list["HostSpill"]:
        """Record bytes; returns the demotion victims WITHOUT demoting them
        (the caller demotes after releasing its own spill's lock).
        ``conf``: the admitting spill's, for the host budget."""
        budget = int((conf if conf is not None else active_conf()).get(HOST_SPILL_BUDGET_BYTES))
        to_demote: list[HostSpill] = []
        with self._lock:
            self._bytes += nbytes
            if spill not in self._resident:
                self._resident.append(spill)
            # only enough victims to clear the shortfall: their bytes leave
            # the ledger at each victim's forget, so count a remainder here
            remaining = self._bytes
            while remaining > budget and self._resident:
                victim = self._resident.pop(0)
                to_demote.append(victim)
                remaining -= victim._admitted
        return to_demote

    def forget(self, spill: "HostSpill", nbytes: int) -> None:
        with self._lock:
            self._bytes -= nbytes
            if spill in self._resident:
                self._resident.remove(spill)

    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes


_host_ledger = _HostLedger()


class HostSpill:
    """Host-RAM tier: encoded blocks kept in RAM; demotes itself to a
    DiskSpill when the host ledger fills. Same interface as DiskSpill."""

    def __init__(self, spill_dir: str | None = None, *, conf):
        self._blocks: list[bytes] | None = []
        self._admitted = 0  # bytes this spill holds in the ledger
        self._disk: DiskSpill | None = None
        self._spill_dir = spill_dir
        self._conf = conf
        self._lock = threading.Lock()

    def write_batch(self, b) -> None:
        obs_on = obs.core._mode != obs.MODE_OFF
        t0 = time.perf_counter_ns() if obs_on else 0
        blk = encode_batch(b, self._conf)
        with self._lock:
            if self._disk is not None:
                self._disk.write_block(blk)
                victims = []
            else:
                self._blocks.append(blk)
                self._admitted += len(blk)
                count_spill(host_bytes=len(blk))
                # admission under OUR lock: a concurrent demotion of this
                # spill takes it first, so it always forgets exactly _admitted
                victims = _host_ledger.admit(self, len(blk), conf=self._conf)
        if obs_on:
            obs.note_spill("HostSpill", "write", time.perf_counter_ns() - t0, len(blk),
                           trace_id=_conf_trace_id(self._conf))
        for v in victims:  # outside our lock (lock order spill -> ledger)
            v._demote()

    def _demote(self) -> None:
        """Move the resident blocks to disk (ledger pressure)."""
        obs_on = obs.core._mode != obs.MODE_OFF
        t0 = time.perf_counter_ns() if obs_on else 0
        with self._lock:
            if self._disk is not None or self._blocks is None:
                return
            disk = DiskSpill(self._spill_dir, conf=self._conf)
            try:
                for blk in self._blocks:
                    disk.write_block(blk)
            except BaseException:
                # a failed demotion (disk full) must not leak the file; the
                # blocks stay in RAM
                disk.release()
                raise
            freed = self._admitted
            self._blocks, self._admitted = [], 0
            self._disk = disk
        _host_ledger.forget(self, freed)
        count_spill(demotions=1, demoted_bytes=freed)
        if obs_on:
            obs.note_spill("HostSpill", "demote", time.perf_counter_ns() - t0, freed,
                           trace_id=_conf_trace_id(self._conf))

    @property
    def demoted(self) -> bool:
        with self._lock:
            return self._disk is not None

    def read_batches(self, schema, device) -> Iterator:
        with self._lock:
            disk, blocks = self._disk, list(self._blocks or ())
        if disk is not None:
            yield from disk.read_batches(schema, device)
            return
        yield from decode_batches(b"".join(blocks), schema, device)

    def release(self) -> None:
        with self._lock:
            disk, freed = self._disk, self._admitted
            self._blocks, self._disk, self._admitted = None, None, 0
        if disk is not None:
            disk.release()
        if freed:
            _host_ledger.forget(self, freed)


def make_spill(spill_dir: str | None = None, *, conf):
    """Spill container for operator state: the host-RAM tier first,
    demoted to disk under ledger pressure. ``conf`` is required: the
    OWNING task's Configuration (pass None only for conf-free scratch)."""
    return HostSpill(spill_dir, conf=conf)
