"""C hosts of the port's C ABI (``csrc/auron_bridge.h``), for tests and the
TPC-DS runners: what a JVM shim does, from Python.

- ``run_harnesses``: tasks through ``bridge_harness`` (``csrc/
  bridge_harness.c``), each a separate C process that embeds the
  interpreter through ``libauron_bridge``; processes run concurrently.
  Each job's resources cross as files (Arrow IPC streams, or a JSON
  shuffle manifest under a ``shuffle:<id>`` key), its answer comes back as
  the harness's framed IPC batches, its metric tree as JSON, and the
  harness's own clock splits its wall into the engine's start (the
  interpreter, its imports, the device), the resource registrations and
  the task.
- ``CLibrary``: ``libauron_bridge`` loaded into this process with
  ``ctypes``; the library uses this process's interpreter and bridge
  module, so resources and counters are this process's.

Both run the device the C bridge chose at its start: ``cuda``, or the CPU
when ``AURON_TORCH_DEVICE=cpu`` is set (``bridge/api.init_c_abi``).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import struct
import subprocess
import sys
import time
from dataclasses import dataclass

from auron_tpu_torch.columnar import arrow_ipc

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def harness_env(device: str) -> dict:
    """A harness process's environment: the engine root, this interpreter's
    import path (an embedded interpreter starts from the system prefix, not
    this one's environment), and the device asked for."""
    return dict(os.environ, AURON_TORCH_ROOT=_ROOT,
                PYTHONPATH=os.pathsep.join(p for p in sys.path if p),
                AURON_TORCH_DEVICE=str(device).split(":")[0])


def read_framed(data: bytes) -> list:
    """Host batches of a harness's output: ``[u64 length][IPC stream]``..."""
    out, pos = [], 0
    while pos < len(data):
        (n,) = struct.unpack_from("<Q", data, pos)
        out += arrow_ipc.read_stream(data[pos + 8:pos + 8 + n])
        pos += 8 + n
    return out


@dataclass
class HarnessRun:
    """One harness process: its answer, metric tree and times."""

    batches: list
    metrics: dict
    process_s: float  # fork to exit, on this process's clock
    init_s: float  # the engine's start inside it (interpreter, imports, device)
    resources_s: float
    task_s: float  # call_native to finalize
    resource_bytes: int


def _run_one(harness: str, task: bytes, resources: dict, work: str, label: str,
             device: str, timeout: float) -> HarnessRun:
    os.makedirs(work, exist_ok=True)
    task_f, out_f = os.path.join(work, f"{label}.task"), os.path.join(work, f"{label}.out")
    with open(task_f, "wb") as f:
        f.write(task)
    args = [harness, task_f, out_f]
    for i, (key, payload) in enumerate(resources.items()):
        path = os.path.join(work, f"{label}.res{i}")
        with open(path, "wb") as f:
            f.write(payload)
        args += [key, path]
    t0 = time.perf_counter()
    r = subprocess.run(args, env=harness_env(device), capture_output=True, text=True,
                       timeout=timeout)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"bridge harness ({label}) exited with {r.returncode}:\n"
                           f"{r.stderr[-6000:]}")
    timing = next(json.loads(line.split(" ", 1)[1]) for line in r.stderr.splitlines()
                  if line.startswith("harness_timing "))
    with open(out_f, "rb") as f:
        batches = read_framed(f.read())
    return HarnessRun(batches, json.loads(r.stdout), wall, timing["init_s"],
                      timing["resources_s"], timing["task_s"],
                      sum(len(v) for v in resources.values()))


def run_harnesses(jobs: list[tuple[bytes, dict]], work: str, device: str = "cuda",
                  label: str = "task", timeout: float = 600.0) -> list[HarnessRun]:
    """Run each (TaskDefinition bytes, {key: payload}) job in its own harness
    process, all at once; results in job order. A failed process raises with
    its stderr."""
    from auron_tpu_torch.ops.cuda_build import build_bridge

    _, harness = build_bridge()
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as ex:
        futs = [ex.submit(_run_one, harness, task, res, work, f"{label}{i}", device, timeout)
                for i, (task, res) in enumerate(jobs)]
        return [f.result() for f in futs]


class CLibrary:
    """``libauron_bridge`` loaded into this process (built at first use).
    Its tasks run on the device ``bridge/api.init_c_abi`` chose at the
    library's start; ``device`` must be that device."""

    def __init__(self, device: str = "cuda"):
        from auron_tpu_torch.bridge import api
        from auron_tpu_torch.ops.cuda_build import build_bridge

        so, _ = build_bridge()
        lib = ctypes.CDLL(so)
        u8p, sz = ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t
        sig = {
            "auron_init": ([], ctypes.c_int),
            "auron_last_error": ([], ctypes.c_char_p),
            "auron_call_native": ([ctypes.c_char_p, sz], ctypes.c_int64),
            "auron_next_batch": ([ctypes.c_int64, ctypes.POINTER(u8p), ctypes.POINTER(sz)],
                                 ctypes.c_int),
            "auron_finalize_native": ([ctypes.c_int64, ctypes.POINTER(u8p), ctypes.POINTER(sz)],
                                      ctypes.c_int),
            "auron_put_resource": ([ctypes.c_char_p, ctypes.c_char_p, sz], ctypes.c_int),
            "auron_put_resource_shuffle": ([ctypes.c_char_p, ctypes.c_char_p, sz], ctypes.c_int),
            "auron_remove_resource": ([ctypes.c_char_p], ctypes.c_int),
        }
        for name, (args, res) in sig.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        self._lib = lib
        self._check(lib.auron_init(), "init")
        if api._c_device != str(device).split(":")[0]:
            raise ValueError(f"the C bridge of this process runs its tasks on {api._c_device}, "
                             f"not {device}: set AURON_TORCH_DEVICE before its first call")

    def _check(self, rc: int, what: str) -> int:
        if rc < 0:
            raise RuntimeError(f"auron C ABI {what} failed: "
                               f"{self._lib.auron_last_error().decode('utf-8', 'replace')}")
        return rc

    def put_resource(self, key: str, ipc: bytes) -> None:
        """An Arrow IPC stream, as ``auron_put_resource``."""
        self._check(self._lib.auron_put_resource(key.encode(), ipc, len(ipc)), "put_resource")

    def put_resource_shuffle(self, key: str, manifest: bytes) -> None:
        self._check(self._lib.auron_put_resource_shuffle(key.encode(), manifest, len(manifest)),
                    "put_resource_shuffle")

    def remove_resource(self, key: str) -> None:
        self._check(self._lib.auron_remove_resource(key.encode()), "remove_resource")

    def run(self, task: bytes) -> tuple[list, dict]:
        """One task: (answer host batches, metric tree of its finalize)."""
        lib = self._lib
        h = self._check(lib.auron_call_native(task, len(task)), "call_native")
        data, n = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_size_t()
        batches = []
        try:
            while self._check(lib.auron_next_batch(h, ctypes.byref(data), ctypes.byref(n)),
                              "next_batch"):
                batches += arrow_ipc.read_stream(ctypes.string_at(data, n.value))
        finally:
            rc = lib.auron_finalize_native(h, ctypes.byref(data), ctypes.byref(n))
        self._check(rc, "finalize_native")
        return batches, json.loads(ctypes.string_at(data, n.value))
