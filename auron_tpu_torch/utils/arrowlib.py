"""pyarrow, imported on a thread that outlives its users.

pyarrow's default memory pool (mimalloc) is set up by the thread that
first imports pyarrow. When that thread exits, the next allocation from
the pool on another thread can crash the process (seen with pyarrow 25:
a task pump that imports pyarrow and ends, then the next pump's first
``pa.array`` segfaults). The port imports pyarrow lazily, often first on
a pump or a request thread, so ``pyarrow()`` makes the first import on
the main thread when called there, and otherwise on a parked daemon
thread that lives as long as the process.
"""

from __future__ import annotations

import sys
import threading

_lock = threading.Lock()


def pyarrow():
    """The pyarrow module (first imported on a thread that never exits)."""
    mod = sys.modules.get("pyarrow")
    if mod is None and threading.current_thread() is not threading.main_thread():
        with _lock:
            if "pyarrow" not in sys.modules:
                _import_on_keeper()
    import pyarrow as pa

    return pa


def _import_on_keeper() -> None:
    done = threading.Event()
    failed: list[BaseException] = []

    def keeper() -> None:
        try:
            import pyarrow  # noqa: F401
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
            failed.append(e)
        done.set()
        threading.Event().wait()  # parked for the life of the process

    threading.Thread(target=keeper, daemon=True, name="auron-torch-pyarrow-keeper").start()
    done.wait()
    if failed:
        raise failed[0]
