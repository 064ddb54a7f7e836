"""The host mechanisms concurrent serving rests on, held on the CPU with
threads and stand-ins (the card runs them in ``test_torch_cuda.py`` and
``chip_smoke.py`` phase 24):

- what the serving legs count: a contended acquire of the graph cache's
  lock (``plan/fusion._TimedLock``, re-entrant) and a settle of the card
  before a spill across tasks (``memory/memmgr._settle_streams``);
- the host's turn (``runtime/dispatch.py``): first come, first served;
  re-entrant; given up for a wait (a stream with work left, a waited
  harvest) and taken back after it; a task's pump and its consumer hand
  batches over under it; a task started outside it (a task slot) never
  takes it; a memory wait under it takes its timeout's outcome at once;
  a wait for it is counted;
- the serving gate's per-leg record (``servegate._leg_record``).
"""

import threading
import time

import pytest
import torch

from auron_tpu_torch.memory.memmgr import MemManager
from auron_tpu_torch.plan import fusion
from auron_tpu_torch.runtime import dispatch
from auron_tpu_torch.utils.profiling import EngineCounters


def _threads(n, target):
    ts = [threading.Thread(target=target, args=(i,), daemon=True) for i in range(n)]
    for t in ts:
        t.start()
    return ts


def _join(ts, timeout=10.0):
    for t in ts:
        t.join(timeout)
        assert not t.is_alive(), "a thread hung"


# ---------------------------------------------------------------------------
# what the serving legs count
# ---------------------------------------------------------------------------


def test_a_contended_graph_lock_is_counted_and_reentrant():
    counters = EngineCounters.install()
    before = counters.snapshot()["lock_waits"].get("graph", [0, 0.0])[0]
    lock = fusion._TimedLock()
    held = threading.Event()
    release = threading.Event()

    def holder(_):
        with lock:
            with lock:  # re-entrant: a capture's spill settles under it
                held.set()
                release.wait(5)

    ts = _threads(1, holder)
    held.wait(5)
    ts += _threads(1, lambda _: lock.__enter__() and lock.__exit__())
    time.sleep(0.05)
    release.set()
    _join(ts)
    after = counters.snapshot()["lock_waits"]["graph"]
    assert after[0] - before == 1 and after[1] > 0


def test_a_spill_across_tasks_settles_the_device_and_is_counted(monkeypatch):
    log = []
    counters = EngineCounters.install()
    settles = counters.snapshot()["settles"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: log.append("device"))
    mm = MemManager.init(budget_bytes=10 << 20)
    try:
        victim, asker = _Consumer("victim", 8 << 20), _Consumer("asker", 1 << 20)
        mm.register(victim)
        mm.register(asker)
        mm.acquire(asker, 4 << 20)
        assert victim.spills == 1 and asker.spills == 0 and log == ["device"]
        assert counters.snapshot()["settles"] - settles == 1
    finally:
        monkeypatch.undo()
        MemManager.init()


class _Consumer:
    def __init__(self, name, used):
        self.name, self.used, self.spills = name, used, 0

    def mem_used(self):
        return self.used

    def spill(self):
        freed, self.used = self.used, 0
        self.spills += 1
        return freed


# ---------------------------------------------------------------------------
# the host's turn
# ---------------------------------------------------------------------------


def test_the_turn_is_served_first_come_first_served():
    order = []
    held = threading.Event()
    done = threading.Event()

    def first(_):
        with dispatch.turn():
            held.set()
            done.wait(5)

    ts = _threads(1, first)
    held.wait(5)

    def waiter(i):
        with dispatch.turn():
            order.append(i)

    for i in range(4):  # each in line before the next starts
        ts += [threading.Thread(target=waiter, args=(i,), daemon=True)]
        ts[-1].start()
        while len(dispatch._wakers) < i + 1:
            time.sleep(0.001)
    done.set()
    _join(ts)
    assert order == [0, 1, 2, 3] and dispatch.holder() is None


def test_the_turn_is_reentrant_and_given_up_for_a_wait():
    counters = EngineCounters.install()
    before = counters.snapshot()["lock_waits"].get("turn", [0, 0.0])[0]
    seen = []
    with dispatch.turn():
        with dispatch.turn():
            assert dispatch.holder() == threading.get_ident()

            def other(_):
                with dispatch.turn():
                    seen.append("other")

            ts = _threads(1, other)
            while not dispatch._wakers:
                time.sleep(0.001)
            with dispatch.waiting():  # the other thread dispatches now
                _join(ts)
            assert seen == ["other"]
            assert dispatch.holder() == threading.get_ident()
        assert dispatch.holder() == threading.get_ident()
    assert dispatch.holder() is None
    with dispatch.waiting():  # not held: nothing to give up
        assert dispatch.holder() is None
    assert counters.snapshot()["lock_waits"]["turn"][0] - before == 1  # the other thread


def test_an_abandoned_ticket_is_skipped():
    with dispatch._lock:
        ticket = dispatch._next_ticket
        dispatch._next_ticket += 2  # a ticket a holder took, and one abandoned
        dispatch._abandoned.add(ticket + 1)
        dispatch._owner = threading.get_ident()
        dispatch._serving = ticket
    dispatch._release()
    assert dispatch._serving == ticket + 2 and not dispatch._abandoned
    got = []
    _join(_threads(1, lambda _: got.append(dispatch._acquire() or dispatch._release())))
    assert got == [None]


@pytest.mark.parametrize("yield_turn", [True, False])
def test_a_waited_harvest_gives_the_turn_up_only_when_asked(yield_turn):
    """``transfer.harvest(yield_turn=True)`` waits for its copy without the
    turn and takes it back after; by default the wait keeps it. Neither
    counts the turn's wait as the read's."""
    from auron_tpu_torch.runtime import transfer

    me = threading.get_ident()
    during = []

    class Event:
        def query(self):
            return False

        def synchronize(self):
            during.append(dispatch.holder())

    tr = transfer.HostTransfer((torch.arange(3),), Event())
    with dispatch.turn():
        (got,) = transfer.harvest(tr, yield_turn=yield_turn)
        assert dispatch.holder() == me
    assert got.tolist() == [0, 1, 2]
    assert during == ([None] if yield_turn else [me])


@pytest.mark.parametrize("done", [True, False])
def test_a_stream_wait_gives_the_turn_up_only_with_work_left(done):
    me = threading.get_ident()
    seen = []

    class Stream:
        def query(self):
            return done

        def synchronize(self):
            seen.append(dispatch.holder())

    with dispatch.turn():
        dispatch.wait_for(Stream())
        assert dispatch.holder() == me
    assert seen == ([] if done else [None])


def test_a_task_pump_and_its_consumer_hand_batches_over_under_the_turn():
    """A consumer that holds the turn reads a task to its end (its pump takes
    the turn a batch), and finalizes it while the pump may be in line."""
    from auron_tpu_torch.runtime.task import TaskRuntime

    got = []
    with dispatch.turn():
        rt = TaskRuntime(_scan_parts(5), device="cpu")
        assert rt._turn is dispatch.turn
        while (b := rt.next_batch()) is not None:
            got.append(b.num_rows())
        rt.finalize()
        half = TaskRuntime(_scan_parts(5), device="cpu")
        assert half.next_batch() is not None
        half.finalize()  # the pump is still producing: cancelled and joined
        assert dispatch.holder() == threading.get_ident()
    assert got == [10] * 5 and dispatch.holder() is None


def _scan_parts(n_batches):
    import numpy as np

    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exec.basic import MemoryScanExec

    schema = T.Schema((T.Field("x", T.INT64),))
    parts = [[Batch.from_numpy([np.arange(i * 10, i * 10 + 10, dtype=np.int64)], schema,
                               device="cpu") for i in range(n_batches)]]
    return MemoryScanExec(parts, schema)


def test_a_task_started_outside_the_turn_runs_while_another_thread_holds_it():
    """The task slots (``run_tasks_parallel``) and a caller's own tasks do
    not take the turn: a task started without it reads to its end while a
    served query's thread holds the turn."""
    from auron_tpu_torch.runtime.task import TaskRuntime

    held, release = threading.Event(), threading.Event()

    def server(_):
        with dispatch.turn():
            held.set()
            release.wait(10)

    ts = _threads(1, server)
    held.wait(5)
    try:
        rt = TaskRuntime(_scan_parts(4), device="cpu")
        got = []
        while (b := rt.next_batch()) is not None:
            got.append(b.num_rows())
        rt.finalize()
        assert got == [10] * 4 and dispatch.holder() is not None
    finally:
        release.set()
        _join(ts)


@pytest.mark.parametrize("under_turn", [True, False])
def test_a_memory_wait_under_the_turn_takes_its_timeouts_outcome_at_once(under_turn):
    """A consumer under its min share waits for its siblings to release,
    and spills when the wait times out; under the turn the siblings wait
    for the turn, so the manager spills at once, as the timeout would."""
    from auron_tpu_torch.utils.config import Configuration, conf_scope

    c = Configuration()
    c.set("memory.wait.timeout.seconds", 0.5)
    with conf_scope(c):
        mm = MemManager.init(budget_bytes=64 << 20)
    mm.budget = 64 << 20
    try:
        hog, small = _Consumer("hog", 63 << 20), _Consumer("small", 2 << 20)
        mm.register(hog)
        mm.register(small)
        t0 = time.monotonic()
        if under_turn:
            with dispatch.turn():
                mm.update_mem_used(small, 0, 2 << 20)
        else:
            mm.update_mem_used(small, 0, 2 << 20)
        waited = time.monotonic() - t0
        assert (small.spills, hog.spills, mm.num_waits, mm.num_spills) == (1, 0, 1, 1)
        assert (waited < 0.25) if under_turn else (waited >= 0.5), waited
    finally:
        MemManager.init()


# ---------------------------------------------------------------------------
# the gate's per-leg record
# ---------------------------------------------------------------------------


def test_leg_record_is_the_difference_of_two_probes():
    from auron_tpu_torch.models import servegate

    counters = EngineCounters.install()
    dev = torch.device("cpu")
    a = servegate._leg_probe(counters, dev)
    counters._read(0.002, is_async=False)
    counters._lock_wait("graph", 0.25)
    counters._settle(0.5)
    sum(range(200_000))
    b = servegate._leg_probe(counters, dev)
    rec = servegate._leg_record(a, b)
    assert rec["host_syncs"] == 1 and rec["settles"] == 1
    assert rec["lock_waits"]["graph"] == [1, 0.25]
    assert sum(n for n, _ in rec["sync_sites"].values()) == 1
    assert rec["wall_s"] >= 0 and rec["cpu_s"] >= 0 and rec["spills"] == 0
