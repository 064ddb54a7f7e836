"""Kernel launch counting that keeps a CUDA-graph capture's launches apart.

Each kernel wrapper adds one to its module's ``LAUNCHES`` where it launches
its kernel. A capture (``plan/fusion.py``) records launches without running
them: ``diverted()`` sends the capturing thread's counts to a tally of its
own, while task threads on other streams keep counting into ``LAUNCHES``;
each replay of the graph then adds its tally."""

from __future__ import annotations

import contextlib
import threading

_tls = threading.local()


def add(counts: dict, lock, name: str, n: int = 1) -> None:
    tally = getattr(_tls, "tally", None)
    if tally is not None:
        t = tally.setdefault(id(counts), {})
        t[name] = t.get(name, 0) + n
        return
    with lock:
        counts[name] += n


@contextlib.contextmanager
def diverted():
    """This thread's launches go to the yielded tally ({id(counts): {name: n}})."""
    prev = getattr(_tls, "tally", None)
    _tls.tally = {}
    try:
        yield _tls.tally
    finally:
        _tls.tally = prev
