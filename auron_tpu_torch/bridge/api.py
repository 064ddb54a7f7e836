"""Host-engine bridge: the task entry points + resource map (port of the
Python entries of ``auron_tpu/bridge/api.py``).

``call_native`` starts a task from serialized ``TaskDefinition`` bytes (the
same bytes the JAX package's builders produce) and returns a handle;
``next_batch`` pulls the next device ``Batch`` (the JAX package hands Arrow
here; a port batch converts with ``Batch.to_arrow()`` when pyarrow is
installed); ``finalize_native`` ends the task and returns its metric tree.
Scan inputs arrive through ``put_resource`` as per-partition lists of port
batches. ``init_memory`` sets the process's device-memory budget at
session setup (``MemManager.init``); every task unregisters its memory
consumers on every path out (``runtime/task.py``).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.memory.memmgr import MemManager
from auron_tpu_torch.runtime.task import TaskRuntime
from auron_tpu_torch.utils.config import Configuration, conf_scope

_lock = threading.Lock()
_resources: dict[str, Any] = {}
_runtimes: dict[int, TaskRuntime] = {}
_next_handle = itertools.count(1)


def init_memory(budget_bytes: int | None = None, conf: dict | None = None) -> MemManager:
    """Session setup: a fresh process memory manager, its budget
    ``budget_bytes`` (else ``memory.hbm.budget.bytes``, 0 = auto) times
    ``memory.fraction``, with the other ``memory.*`` keys of ``conf``."""
    with conf_scope(Configuration(conf or {})):
        return MemManager.init(budget_bytes)


def put_resource(key: str, value: Any) -> None:
    with _lock:
        _resources[key] = value


def remove_resource(key: str) -> None:
    with _lock:
        _resources.pop(key, None)


def call_native(task_bytes: bytes, extra_resources: dict | None = None,
                device: str = "cuda") -> int:
    """Start a task; returns a handle. ``device`` places outputs that have
    no input batch (operators otherwise follow their inputs' device)."""
    with _lock:
        resources = dict(_resources)
    if extra_resources:
        resources.update(extra_resources)
    rt = TaskRuntime(task_bytes, resources=resources, shared=_resources, device=device)
    h = next(_next_handle)
    with _lock:
        _runtimes[h] = rt
    return h


class _NativeTask:
    def __init__(self, task_bytes: bytes, extra_resources: dict | None, device: str):
        self._args = (task_bytes, extra_resources, device)
        self.handle: int | None = None

    def __enter__(self) -> int:
        self.handle = call_native(*self._args)
        return self.handle

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.handle is None:
            return False
        if exc_type is None:
            finalize_native(self.handle)
        else:
            try:
                finalize_native(self.handle)
            except Exception:  # noqa: BLE001 — the propagating error is primary
                pass
        return False


def native_task(task_bytes: bytes, extra_resources: dict | None = None, device: str = "cuda"):
    """Context manager: ``call_native`` on entry, ``finalize_native`` on
    every exit."""
    return _NativeTask(task_bytes, extra_resources, device)


def next_batch(handle: int) -> Batch | None:
    return _runtimes[handle].next_batch()


def finalize_native(handle: int) -> dict:
    with _lock:
        rt = _runtimes.pop(handle, None)
    return {} if rt is None else rt.finalize()
