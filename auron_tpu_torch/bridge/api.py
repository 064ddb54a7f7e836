"""Host-engine bridge: the task entry points + resource map (port of the
Python entries of ``auron_tpu/bridge/api.py``).

``call_native`` starts a task from serialized ``TaskDefinition`` bytes
(decoded by the port's own proto3 codec, ``auron_tpu_torch.proto``: the
same bytes the reference's builders and ``plan/builders.py`` produce) or
from an exec tree, and returns a handle; ``next_batch`` pulls the next
device ``Batch``; ``finalize_native`` ends the task and returns its metric
tree. ``init_memory`` sets the process's device-memory budget at session
setup (``MemManager.init``); every task unregisters its memory consumers on
every path out (``runtime/task.py``).

The C ABI (``csrc/auron_bridge.h``, built by ``ops/cuda_build.py``) calls
the functions below; batches cross it as Arrow, without pyarrow
(``columnar/arrow_c.py``, ``columnar/arrow_ipc.py``):

- ``call_native_c`` (``auron_call_native``): a task from bytes on the
  device ``init_c_abi`` chose when the bridge started: ``cuda``, or the
  CPU when the host set ``AURON_TORCH_DEVICE=cpu`` (a CUDA task raises
  without a card; nothing falls back);
- ``put_resource_ipc`` (``auron_put_resource``): an Arrow IPC stream,
  registered as a list of host batches for an ``ffi_reader``;
- ``put_resource`` (``auron_put_resource_bytes``): opaque bytes;
- ``put_resource_c_stream`` (``auron_put_resource_arrow``): an
  ``ArrowArrayStream*``, imported by pointer (no serialization, no copy)
  as a one-shot reader;
- ``put_resource_shuffle`` (``auron_put_resource_shuffle``): a JSON
  manifest of committed map outputs, registered as a reduce-side block
  provider (``convert/stages.provider_from_manifest``);
- ``next_batch_c`` (``auron_next_batch_arrow``): the next batch exported
  into host-allocated ``ArrowArray*`` / ``ArrowSchema*`` structs;
- ``next_batch_ipc`` (``auron_next_batch``): the next batch as IPC bytes;
- ``finalize_native_json``, ``remove_resource``, ``set_metrics_sink`` and
  ``on_exit``.

- ``convert_plan_json`` (``auron_convert_plan``): host-plan JSON to the
  segmentation response of ``convert/service.py``.

- ``install_udf_callback`` (``auron_register_udf_callback``): the host's
  evaluator for ``__hive:<blob>`` UDFs (``bridge/udf.py``).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from typing import Any

import torch

from auron_tpu_torch.columnar import arrow_c, arrow_ipc
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.device import resolve_device
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


# ---- resource map (JniBridge.putResource/getResource analog) ----


def put_resource(key: str, value: Any) -> None:
    with _lock:
        _resources[key] = value


def put_resource_ipc(key: str, payload: bytes) -> None:
    """C-ABI batch-resource entry: the payload MUST be an Arrow IPC stream;
    it registers as a list of host batches (consumable by ``ffi_reader``).
    Raw opaque payloads go through plain ``put_resource`` instead — an
    explicit type split, no content sniffing."""
    put_resource(key, arrow_ipc.read_stream(bytes(payload)))


def put_resource_c_stream(key: str, stream_ptr: int) -> None:
    """Arrow C-FFI batch-resource entry (auron_put_resource_arrow): the host
    hands an ``ArrowArrayStream*`` and batches cross the boundary by
    POINTER — no IPC serialization, no copy. The stream is moved into the
    port and its schema read now; the registered reader is one-shot, like a
    host engine's per-task scan handoff."""
    put_resource(key, arrow_c.import_stream(int(stream_ptr)))


def put_resource_shuffle(key: str, manifest: bytes) -> None:
    """C-ABI shuffle-fetch entry: the payload is a JSON manifest of committed
    map outputs (``[{"data": path, "index": path}, ...]``); it registers as
    the block provider a reduce task's ``ipc_reader`` with this key reads."""
    from auron_tpu_torch.convert.stages import provider_from_manifest

    put_resource(key, provider_from_manifest(manifest))


def remove_resource(key: str) -> None:
    with _lock:
        _resources.pop(key, None)


def convert_plan_json(payload: bytes) -> bytes:
    """C-ABI conversion entry (``auron_convert_plan``): host-plan JSON in,
    segmentation response JSON out (``convert/service.py``); an error comes
    back as ``{"converted": false, "error": ...}``, never as a raise."""
    from auron_tpu_torch.convert.service import convert_host_plan_json

    return convert_host_plan_json(bytes(payload))


def install_udf_callback(fn_ptr: int) -> None:
    """C-ABI host-UDF entry (``auron_register_udf_callback``): install the
    host's evaluator; ``__hive:<blob>`` expressions route through it."""
    from auron_tpu_torch.bridge import udf

    udf.install_c_callback(int(fn_ptr or 0))


# ---- task entry points ----


def call_native(task, extra_resources: dict | None = None, device: str = "cuda",
                conf: dict | None = None, stage_id: int = 0, partition_id: int = 0) -> int:
    """Start a task; returns a handle. ``task`` is serialized
    ``TaskDefinition`` bytes, or an exec tree, which takes ``conf``,
    ``stage_id`` and ``partition_id`` here (the bytes carry their own).
    ``extra_resources`` overlay the process map for this task only.
    ``device`` places outputs that have no input batch (operators otherwise
    follow their inputs' device)."""
    with _lock:
        resources = dict(_resources)
    if extra_resources:
        resources.update(extra_resources)
    rt = TaskRuntime(task, resources=resources, shared=_resources, stage_id=stage_id,
                     partition_id=partition_id, conf=Configuration(conf or {}), device=device)
    try:
        h = next(_next_handle)
        with _lock:
            _runtimes[h] = rt
    except BaseException:
        # the runtime's pump thread is already running: a failure before
        # the handle is published must cancel and join it, or it leaks
        try:
            rt.finalize()
        except Exception:  # noqa: BLE001 — the original failure is the error
            pass
        raise
    return h


#: the device of the tasks the C ABI starts; set by ``init_c_abi``
_c_device = "cuda"


def init_c_abi() -> None:
    """The C bridge's init (``csrc/auron_bridge.cpp``): its tasks run on
    ``cuda`` unless the host process asks for the CPU with
    ``AURON_TORCH_DEVICE=cpu``. On ``cuda`` the card's context is made now
    (the host's start-up, not its first task), and without a card this
    raises, so every C call then fails with that error."""
    global _c_device
    device = os.environ.get("AURON_TORCH_DEVICE", "cuda")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"AURON_TORCH_DEVICE must be cuda or cpu, not {device!r}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.empty(1, device=dev)
    _c_device = device


def call_native_c(task_bytes: bytes) -> int:
    """C-ABI task entry (``auron_call_native``): ``call_native`` of the bytes
    on the device ``init_c_abi`` chose."""
    return call_native(bytes(task_bytes), device=_c_device)


class _NativeTask:
    def __init__(self, task, extra_resources: dict | None, device: str):
        self._args = (task, extra_resources, device)
        self.handle: int | None = None
        self.metrics: dict | None = None  # the finalized task's metric tree

    def __enter__(self) -> int:
        self.handle = call_native(*self._args)
        return self.handle

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.handle is None:
            return False
        if exc_type is None:
            self.metrics = finalize_native(self.handle)
        else:
            try:
                finalize_native(self.handle)
            except Exception:  # noqa: BLE001 — the propagating error is primary
                pass
        return False


def native_task(task, extra_resources: dict | None = None, device: str = "cuda"):
    """Context manager: ``call_native`` on entry, ``finalize_native`` on
    every exit; after a clean exit its ``metrics`` hold the metric tree."""
    return _NativeTask(task, extra_resources, device)


def next_batch(handle: int) -> Batch | None:
    """The next device batch (``Batch.to_arrow()`` gives pyarrow where it is
    installed; the C-ABI functions below give Arrow without it)."""
    return _runtimes[handle].next_batch()


def next_batch_c(handle: int, array_ptr: int, schema_ptr: int) -> int:
    """Arrow C-FFI batch export (auron_next_batch_arrow): writes the next
    batch into host-allocated ``ArrowArray*`` / ``ArrowSchema*`` structs
    (release callbacks transfer ownership per the C data interface spec).
    Returns 1 on a batch, 0 at end of stream."""
    hb = _runtimes[handle].next_arrow()
    if hb is None:
        return 0
    arrow_c.export_batch(hb, int(array_ptr), int(schema_ptr))
    return 1


def next_batch_ipc(handle: int) -> bytes | None:
    """IPC-serialized variant for out-of-process hosts: one schema message,
    the batch, end-of-stream."""
    hb = _runtimes[handle].next_arrow()
    return None if hb is None else arrow_ipc.write_stream([hb])


_metrics_sink = None


def set_metrics_sink(fn) -> None:
    """Install a callable receiving every finalized task's metric-tree
    snapshot (the reference pushes each task's metric tree into Spark's
    SQLMetric registry at finalize). Pass None to uninstall."""
    global _metrics_sink
    _metrics_sink = fn


def finalize_native(handle: int) -> dict:
    with _lock:
        rt = _runtimes.pop(handle, None)
    if rt is None:
        return {}
    snap = rt.finalize()
    sink = _metrics_sink
    if sink is not None:
        try:
            sink(snap)
        except Exception:  # noqa: BLE001 — a broken metrics consumer must not fail the task
            pass
    return snap


def finalize_native_json(handle: int) -> bytes:
    """C-ABI variant: the metric tree serialized as JSON bytes, with the
    process's kernel launches so far (``"kernel_launches"``: the
    ``LAUNCHES`` counts of ``ops/bitonic.py`` and ``ops/partition_kernels.py``;
    a host process that runs one task reads that task's)."""
    from auron_tpu_torch.ops import bitonic, partition_kernels

    snap = finalize_native(handle)
    snap["kernel_launches"] = {**bitonic.LAUNCHES, **partition_kernels.LAUNCHES}
    return json.dumps(snap).encode("utf-8")


def on_exit() -> None:
    """Finalize every live task (the host's exit hook). A task whose
    finalize fails does not keep the others alive; the first failure is
    raised once all are finalized."""
    with _lock:
        handles = list(_runtimes)
    first: Exception | None = None
    for h in handles:
        try:
            finalize_native(h)
        except Exception as e:  # noqa: BLE001 — finalize the rest, then raise
            first = first or e
    if first is not None:
        raise first
