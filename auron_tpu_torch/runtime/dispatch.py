"""The host's turn: one engine thread dispatches to the card at a time.

The port runs a query as eager torch calls (thousands a query) and CUDA
graph replays, from Python threads. Every torch call gives up the
interpreter lock while it runs and has to win it back. When the threads of
several queries dispatch at once, each call becomes a hand-off between
them: the lock changes hands thousands of times a second, the waiting
threads wake and sleep again at every call, and the process spends more
CPU on each query than when it runs alone (PERF.md §6: 3.8x the CPU a
query at 8 clients, and fewer queries/s than one client gets). The JAX
package does not meet this: a query there is a few XLA executions, each
one call that holds no interpreter lock while it runs.

A *turn* is a fair (first come, first served) process-wide lock that a
served query's thread takes while it dispatches (``serve/server.py``),
and the pumps of the tasks it starts take a batch at a time
(``runtime/task.py``); both give it up where they wait:

- ``turn()``: hold the turn for a block of dispatch (re-entrant);
- ``waiting()``: around a wait for the card (a stage's end, a query's
  barrier) or for another thread (a task's queue, a pump's end, a table
  upload): the turn is given up for the wait and taken back after it, so
  another query dispatches while this one waits. Callers skip it where
  nothing is left to wait for (``wait_for`` a stream that is done, a
  queue that holds a batch): giving the turn up costs a hand-off and a
  place at the end of the line.

Nothing else takes the turn: a thread that does not hold it (a caller's
main thread, the task slots of ``models/tpcds.run_tasks_parallel``, a
stream's pump) dispatches as it did without one, and ``waiting()`` and
``wait_for`` there are a plain wait. Waits inside operator code (a
blocking read, a window's harvest) keep the turn: an operator may hold a
consumer's lock there, and the next holder's memory accounting
(``mem_used``) or spill would wait for that lock. The one exception is a
caller that holds no lock (the dense aggregate's fold harvest,
``transfer.harvest(yield_turn=True)``). The memory manager does not wait
for siblings under the turn (``held()``): they wait for the turn, so the
wait could end only at its timeout. A wait for the turn that finds it
held counts its seconds as ``lock_waits["turn"]`` of ``utils/profiling``.
"""

from __future__ import annotations

import contextlib
import threading
import time

_lock = threading.Lock()
_owner: int | None = None
_next_ticket = 0
_serving = 0
#: a waiting thread's wake-up by ticket: a release wakes the next ticket's
#: thread only, so the threads in line do not all wake (and contend for the
#: interpreter lock) at every hand-off
_wakers: dict = {}
#: tickets whose thread stopped waiting (an exception in the wait): skipped
_abandoned: set = set()
_held = threading.local()


def _depth() -> int:
    return getattr(_held, "depth", 0)


def _advance() -> None:
    """Serve the next ticket (``_lock`` held)."""
    global _owner, _serving
    _owner = None
    _serving += 1
    while _serving in _abandoned:
        _abandoned.discard(_serving)
        _serving += 1
    waker = _wakers.get(_serving)
    if waker is not None:
        waker.set()


def _acquire() -> None:
    global _owner, _next_ticket
    me = threading.get_ident()
    with _lock:
        ticket = _next_ticket
        _next_ticket += 1
        if _serving == ticket:
            _owner = me
            return
        waker = _wakers[ticket] = threading.Event()
    t0 = time.perf_counter()
    try:
        waker.wait()
    except BaseException:
        with _lock:
            _wakers.pop(ticket, None)
            if _serving == ticket:
                _advance()
            else:
                _abandoned.add(ticket)
        raise
    with _lock:
        _wakers.pop(ticket, None)
        _owner = me
    from auron_tpu_torch.utils.profiling import note_lock_wait

    note_lock_wait("turn", time.perf_counter() - t0)


def _release() -> None:
    with _lock:
        _advance()


@contextlib.contextmanager
def turn():
    """Hold the turn for the block (at once if this thread holds it)."""
    if _depth():
        _held.depth += 1
    else:
        _acquire()
        _held.depth = 1
    try:
        yield
    finally:
        _held.depth -= 1
        if not _held.depth:
            _release()


@contextlib.contextmanager
def waiting():
    """Give the turn up for a wait, if this thread holds it; take it back
    after."""
    depth = _depth()
    if not depth:
        yield
        return
    _held.depth = 0
    _release()
    try:
        yield
    finally:
        _acquire()
        _held.depth = depth


def wait_for(stream) -> None:
    """Synchronize ``stream``, giving the turn up for the wait if it has
    work left."""
    if stream.query():
        return
    with waiting():
        stream.synchronize()


def held() -> bool:
    """Whether this thread holds the turn."""
    return _depth() > 0


def holder() -> int | None:
    """The thread ident holding the turn (None when free)."""
    return _owner
