"""Host-callback (UDF, UDAF, UDTF) registries (port of
``auron_tpu/bridge/udf.py``).

The host engine serializes a function the converter could not translate;
the engine calls it back with Arrow columns. A callback is a Python
callable registered per name, with the reference's contract, so one
registered function serves both packages:

- UDF: ``fn(args: list[pa.Array], n) -> pa.Array`` of length ``n``. The
  positions are the batch's slots one for one, padding included (a
  callback must tolerate the padding's values; the engine keeps the
  selection mask). pyarrow is imported inside the call, never here.
- UDAF: the incremental accumulator protocol ``UdafSpec`` (init, update,
  merge, finish); the state is an opaque object pickled into the BINARY
  intermediate column between stages.
- UDTF: ``fn(row_value) -> list of output-row tuples``.

A ``__hive:<b64 blob>`` name evaluates through the host's C callback
(``auron_register_udf_callback`` -> ``install_c_callback``): the argument
columns go out as one Arrow IPC stream and the single result column comes
back as one, both written and read by ``columnar/arrow_ipc.py``, so a C
host without pyarrow evaluates a Hive UDF.
"""

from __future__ import annotations

import ctypes
import threading
import time
from dataclasses import dataclass
from typing import Callable

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.arrow_c import HostArray, HostBatch

_UDFS: dict[str, Callable] = {}

#: host callback calls and their seconds, over the process
_STATS = {"calls": 0, "rows": 0, "seconds": 0.0}
_stats_lock = threading.Lock()


def stats() -> dict:
    with _stats_lock:
        return dict(_STATS)


def _count(rows: int, seconds: float) -> None:
    with _stats_lock:
        _STATS["calls"] += 1
        _STATS["rows"] += rows
        _STATS["seconds"] += seconds


def register_udf(name: str, fn: Callable) -> None:
    _UDFS[name] = fn


def lookup_udf(name: str) -> Callable:
    if name.startswith("__hive:"):
        # the plan carries the serialized function: any executor evaluates
        # it through the host's C callback, with no local registry
        return hive_blob_udf(name[len("__hive:"):])
    if name not in _UDFS:
        raise KeyError(f"host UDF '{name}' is not registered with the bridge")
    return _UDFS[name]


def udf_names() -> list[str]:
    return sorted(_UDFS)


def evaluate_udf(name: str, args: HostBatch, n: int) -> HostArray:
    """One UDF call over the host argument columns (``n`` rows each); the
    single result column as a host array. A ``__hive:`` name stays in the
    port's own IPC; a registered Python callable gets pyarrow arrays."""
    fn = lookup_udf(name)
    t0 = time.perf_counter()
    out = fn(args, n) if name.startswith("__hive:") else _call_with_pyarrow(fn, args, n)
    _count(n, time.perf_counter() - t0)
    if out.length != n:
        raise RuntimeError(f"host UDF '{name}' returned {out.length} values for {n} slots")
    return out


def _call_with_pyarrow(fn: Callable, args: HostBatch, n: int) -> HostArray:
    import pyarrow as pa

    from auron_tpu_torch.columnar.arrow_c import import_from

    cols = list(_to_pyarrow(args).columns) if args.columns else []
    result = fn(cols, n)
    if isinstance(result, pa.ChunkedArray):
        result = result.combine_chunks()
    if not isinstance(result, pa.Array):
        result = pa.array(result)
    return import_from(pa.record_batch([result], names=["r"])).columns[0]


def _to_pyarrow(hb: HostBatch):
    """A host batch as a pyarrow RecordBatch, through the C data interface."""
    import pyarrow as pa

    from auron_tpu_torch.columnar.arrow_c import ArrowArray, ArrowSchema, export_batch

    arr, sch = ArrowArray(), ArrowSchema()
    export_batch(hb, ctypes.addressof(arr), ctypes.addressof(sch))
    return pa.RecordBatch._import_from_c(ctypes.addressof(arr), ctypes.addressof(sch))


# ---------------------------------------------------------------------------
# UDAFs (the aggregate fallback: the incremental accumulator protocol)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UdafSpec:
    """The accumulator protocol (the reference's SparkUDAFWrapperContext):

    - ``init() -> state``                fresh per-group state
    - ``update(state, value) -> state``  fold one input value
    - ``merge(state, other) -> state``   combine partial states
    - ``finish(state) -> scalar``        final value

    States are opaque Python objects, pickled into the BINARY intermediate
    column between stages: a group's memory is its state's size, never its
    input count, and the state batches spill like any aggregation state."""

    init: Callable
    update: Callable
    merge: Callable
    finish: Callable
    out_dtype: T.DataType


_UDAFS: dict[str, UdafSpec] = {}


def register_udaf_accumulator(name: str, *, init: Callable, update: Callable, merge: Callable,
                              finish: Callable, out_dtype: T.DataType) -> None:
    """Register an incremental (bounded-state) host UDAF."""
    _UDAFS[name] = UdafSpec(init, update, merge, finish, out_dtype)


def register_udaf(name: str, fn: Callable, out_dtype: T.DataType) -> None:
    """``fn(values: list) -> scalar`` evaluated per group at the final
    stage: the accumulator protocol over a LIST state (a group's raw
    inputs accumulate). Prefer ``register_udaf_accumulator``."""
    _UDAFS[name] = UdafSpec(init=list, update=lambda st, v: (st.append(v) or st),
                            merge=lambda a, b: (a.extend(b) or a), finish=fn,
                            out_dtype=out_dtype)


def lookup_udaf(name: str) -> UdafSpec:
    if name not in _UDAFS:
        raise KeyError(f"host UDAF '{name}' is not registered with the bridge")
    return _UDAFS[name]


# ---------------------------------------------------------------------------
# UDTFs (the table-generating fallback)
# ---------------------------------------------------------------------------

_UDTFS: dict[str, tuple[Callable, T.Schema]] = {}


def register_udtf(name: str, fn: Callable, out_schema: T.Schema) -> None:
    """``fn(row_value) -> list of output-row tuples`` (possibly empty);
    ``out_schema`` types the generated columns."""
    _UDTFS[name] = (fn, out_schema)


def lookup_udtf(name: str) -> tuple[Callable, T.Schema]:
    if name not in _UDTFS:
        raise KeyError(f"host UDTF '{name}' is not registered with the bridge")
    return _UDTFS[name]


# ---------------------------------------------------------------------------
# the C-ABI host callback (Hive UDFs: auron_register_udf_callback)
# ---------------------------------------------------------------------------

_C_EVAL = None  # the host's evaluator, process-wide like the C ABI

_EVAL_FN = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,  # udf blob
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,  # argument columns, Arrow IPC
    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),  # result column, Arrow IPC
    ctypes.POINTER(ctypes.c_size_t),
)


def install_c_callback(fn_ptr: int) -> None:
    """The host's evaluator (``auron_udf_eval_fn``, ``csrc/auron_bridge.h``),
    from ``auron_register_udf_callback``; 0 uninstalls it."""
    global _C_EVAL
    _C_EVAL = _EVAL_FN(fn_ptr) if fn_ptr else None


def host_callback_installed() -> bool:
    return _C_EVAL is not None


def _eval_via_c(blob: bytes, args: HostBatch, n: int) -> HostArray:
    from auron_tpu_torch.columnar import arrow_ipc

    if not args.columns:  # no arguments: one NULL column carries the length
        args = HostBatch(T.Schema((T.Field("__empty", T.NULL, True),)), n,
                         (HostArray("n", T.NULL, n, n, 0, ()),))
    payload = arrow_ipc.write_stream([args])
    buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
    bbuf = (ctypes.c_uint8 * max(len(blob), 1)).from_buffer_copy(blob or b"\x00")
    out_ptr = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t(0)
    rc = _C_EVAL(bbuf, len(blob), buf, len(payload), ctypes.byref(out_ptr),
                 ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"host UDF callback failed (rc={rc})")
    batches = arrow_ipc.read_stream(ctypes.string_at(out_ptr, out_len.value))
    rows = sum(b.length for b in batches)
    if len(batches) != 1 or len(batches[0].columns) != 1 or rows != n:
        raise RuntimeError(f"host UDF: expected 1 column x {n} rows in one batch, got "
                           f"{len(batches)} batches of {[len(b.columns) for b in batches]} "
                           f"columns, {rows} rows")
    return batches[0].columns[0]


def hive_blob_udf(blob_b64: str) -> Callable:
    """The callable ``lookup_udf`` gives a ``__hive:<b64 blob>`` name: it
    takes the host argument batch itself (no pyarrow)."""
    import base64

    blob = base64.b64decode(blob_b64)

    def fn(args: HostBatch, n: int) -> HostArray:
        if _C_EVAL is None:
            raise RuntimeError("no host UDF callback installed (auron_register_udf_callback)")
        return _eval_via_c(blob, args, n)

    return fn
