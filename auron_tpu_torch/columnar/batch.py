"""Fixed-shape columnar device batches (torch).

Port of ``auron_tpu/columnar/batch.py``. A batch is a capacity-bucketed
set of dense tensors:

- every column is a dense value tensor of length ``capacity`` (padded) plus
  a bool validity tensor (SQL NULLs);
- a bool selection tensor ``sel``: row *i* exists iff ``sel[i]``; filters
  refine ``sel`` instead of compacting;
- capacities are powers of two (``bucket_capacity``), as in the JAX package,
  so operator code and results line up batch for batch;
- dictionary-encoded columns (STRING/BINARY, wide decimals, LIST, MAP,
  STRUCT) carry int32 codes on the device; the vocabulary is a numpy object
  array on the host (a wide decimal's holds ``decimal.Decimal`` values at
  the column's scale, a nested one the values pyarrow's ``to_pylist``
  gives: a LIST entry a list, a MAP entry a list of ``(key, value)``
  tuples, a STRUCT entry a dict of every field). A nested column ingests as
  identity codes into a per-batch vocabulary (reference
  ``columnar/batch.py:469-475``): its values cannot be ordered or hashed,
  so such vocabularies merge by ``vocab_key`` (lists and pairs as tuples,
  dicts as sorted tuples) or, in ``device_concat``, are laid end to end,
  and are always filled entry by entry (``object_array``);
- a decimal64 column (precision <= 18) is an int64 plane of unscaled
  values; a value outside int64 ingests as NULL (reference
  ``columnar/batch.py:499-512``).

``DeviceBatch`` holds the tensors; ``Batch`` adds the schema and the host
vocabularies. Arrow and pandas interop import their libraries lazily; the
device path needs neither (``from_numpy``/``to_numpy``).

The host boundary needs no pyarrow either: ``from_host_arrow`` ingests a
``HostBatch`` (Arrow arrays on the host, imported through the C data
interface or read from IPC, ``columnar/arrow_c.py``) and ``to_host_arrow``
gives one back (reference ``columnar/batch.py:158-172``, ``:440-560``).
Host planes cross through pinned staging buffers and ``non_blocking``
copies, validity bitmaps cross packed and are unpacked on the device, and
``exec.scan.zerocopy`` decides whether a plane that is a view of the
producer's buffer goes straight to its staging copy or is first copied
into an owned array (one host copy or two). ``ingest_stats()`` counts the
planes each way, the bytes copied to the device and the host seconds
spent. ``from_arrow`` is the same ingest, through pyarrow's C export.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.arrow_c import (
    ArrowArray, ArrowSchema, HostArray, HostBatch, array_from_numpy, export_batch, micros,
)
from auron_tpu_torch.device import resolve_device
from auron_tpu_torch.utils.config import SCAN_ZEROCOPY, active_conf, resolve_tri

MIN_CAPACITY = 128


def bucket_capacity(n: int) -> int:
    """Static-shape bucket for a batch holding n rows: next power of two."""
    c = MIN_CAPACITY
    while c < n:
        c <<= 1
    return c


def compaction_bucket(n_live: int, in_capacity: int) -> int | None:
    """The capacity bucket to compact ``n_live`` rows into, or None when
    compaction would not pay (same 4x rule as auron_tpu)."""
    cap = bucket_capacity(max(n_live, 1))
    if cap * 4 > in_capacity:
        return None
    return cap


class DeviceBatch(NamedTuple):
    sel: torch.Tensor  # bool[capacity]
    values: tuple  # one dense tensor per column
    validity: tuple  # bool[capacity] per column

    @property
    def capacity(self) -> int:
        return int(self.sel.shape[0])

    def num_rows(self) -> torch.Tensor:
        """Live row count as a device scalar (no sync)."""
        return self.sel.sum()


def object_array(entries: Sequence) -> np.ndarray:
    """A numpy object array holding ``entries`` one per slot. Filled entry by
    entry: ``out[:] = entries`` broadcasts (or raises) when the entries are
    lists of equal length."""
    out = np.empty(len(entries), dtype=object)
    for i, e in enumerate(entries):
        out[i] = e
    return out


def vocab_key(v):
    """Hashable key of a vocabulary entry: lists and tuples (at any depth)
    become tuples, dicts sorted tuples of their items (reference
    ``columnar/batch.py:_vocab_key``)."""
    if isinstance(v, (list, tuple)):
        return tuple(vocab_key(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, vocab_key(x)) for k, x in v.items()))
    return v


def empty_entry(dtype: T.DataType):
    """The filler a vocabulary holds behind a NULL row or a failed entry
    (reference ``columnar/batch.py:350-364``): an empty list or map, a
    struct of NULL fields, zero, an empty string or bytes."""
    k = dtype.kind
    if k in (T.TypeKind.LIST, T.TypeKind.MAP):
        return []
    if k == T.TypeKind.STRUCT:
        return dict.fromkeys(dtype.struct_names)
    if k == T.TypeKind.BINARY:
        return b""
    if k == T.TypeKind.DECIMAL:
        return T.decimal_from_unscaled(0, dtype.scale)
    return ""


def _as_list(v) -> list:
    return v if type(v) is list else list(v)


@functools.lru_cache(maxsize=None)
def nested_normalizer(dtype: T.DataType):
    """The function that puts a non-NULL ``dtype`` value in the port's
    Python form, the form pyarrow's ``to_pylist`` gives and ``pa.array``
    takes: a LIST a list, a MAP a list of ``(key, value)`` tuples (given as
    pairs, as ``{"key", "value"}`` dicts or as a mapping), a STRUCT a dict
    of every field (given as a dict or a sequence in field order). A NULL
    map key raises ``ValueError`` as Arrow's conversion does; a value
    already in the port's form comes back as it is (the same list). Built
    once per type."""
    k = dtype.kind
    if not dtype.is_nested:
        return lambda v: v

    def inner(t):
        return nested_normalizer(t) if t.is_nested else None

    if k == T.TypeKind.LIST:
        el = inner(dtype.inner[0])
        return (lambda v: [x if x is None else el(x) for x in v]) if el else _as_list
    if k == T.TypeKind.MAP:
        kf, vf = (inner(t) for t in dtype.inner)

        def norm_map(v):
            if not (kf or vf) and type(v) is list and all(
                    type(e) is tuple and len(e) == 2 and e[0] is not None for e in v):
                return v
            out = []
            for e in (v.items() if isinstance(v, dict) else v):
                key, val = (e["key"], e["value"]) if isinstance(e, dict) else e
                if key is None:
                    raise ValueError("Invalid Map: key field cannot contain null values")
                out.append((kf(key) if kf else key,
                            vf(val) if vf and val is not None else val))
            return out
        return norm_map
    names = dtype.struct_names
    fns = [inner(t) for t in dtype.inner]

    def norm_struct(v):
        vals = ([v.get(n) for n in names] if isinstance(v, dict)
                else list(v) + [None] * (len(names) - len(v)))
        return {n: f(x) if f and x is not None else x for n, x, f in zip(names, vals, fns)}
    return norm_struct


def nested_vocab(col, valid: np.ndarray, dtype: T.DataType) -> tuple[np.ndarray, np.ndarray]:
    """(identity int32 codes, per-batch vocabulary) of a host LIST, MAP or
    STRUCT column (``nested_normalizer`` of each row): a NULL row keeps its
    code with ``empty_entry`` behind it."""
    n = len(col)
    if not n:
        return np.zeros(0, np.int32), empty_dict(dtype)
    norm = nested_normalizer(dtype)
    entries = [norm(e) if ok and e is not None else empty_entry(dtype)
               for e, ok in zip(col, valid)]
    return np.arange(n, dtype=np.int32), object_array(entries)


def empty_dict(dtype: T.DataType) -> np.ndarray:
    """One-entry sentinel vocabulary (code 0 must always decode)."""
    out = np.empty(1, dtype=object)
    out[0] = empty_entry(dtype)
    return out


def decimal64_plane(col: np.ndarray, valid: np.ndarray,
                    scale: int) -> tuple[np.ndarray, np.ndarray]:
    """(int64 unscaled values, validity) of a decimal64 host column given as
    int64 unscaled values or as Decimal objects; a Decimal whose unscaled
    value leaves int64 becomes NULL (Spark's non-ANSI overflow)."""
    if col.dtype != object:
        return col.astype(np.int64, copy=False), valid
    vals = np.zeros(len(col), dtype=np.int64)
    valid = valid.copy()
    for j in np.flatnonzero(valid):
        u = T.unscaled_int(col[j], scale)
        if -(2**63) <= u < 2**63:
            vals[j] = u
        else:
            valid[j] = False
    return vals, valid


def wide_decimal_vocab(col: np.ndarray, valid: np.ndarray, scale: int):
    """(int32 codes, vocabulary of Decimals at ``scale``) of a wide-decimal
    host column of Decimal objects (NULL rows code 0)."""
    vals = np.empty(len(col), dtype=object)
    vals[:] = [T.decimal_at_scale(x, scale) if ok else None for x, ok in zip(col, valid)]
    codes, vocab = encode_values(vals, valid)
    if not any(ok for ok in valid):
        vocab = np.array([T.decimal_from_unscaled(0, scale)], dtype=object)
    return codes, vocab


def encode_values(vals: np.ndarray, valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dictionary-encode a host column: (int32 codes, vocabulary) with the
    vocabulary in first-occurrence order (Arrow's dictionary_encode order).
    Null rows get code 0."""
    n = len(vals)
    codes = np.zeros(n, dtype=np.int32)
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return codes, np.array([""], dtype=object)
    live = vals[idx]
    uniq, first, inv = np.unique(live, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int32)
    rank[order] = np.arange(len(uniq), dtype=np.int32)
    codes[idx] = rank[inv.reshape(-1)]
    vocab = np.empty(len(uniq), dtype=object)
    vocab[:] = [x.item() if hasattr(x, "item") else x for x in uniq[order]]
    return codes, vocab


@dataclass
class Batch:
    """Host-side handle: schema + host vocabularies + device tensors."""

    schema: T.Schema
    device: DeviceBatch
    dicts: tuple  # per column: numpy object array (dict-encoded) or None

    # ---- construction ----

    @staticmethod
    def from_numpy(
        columns: Sequence[np.ndarray],
        schema: T.Schema,
        validity: Sequence[np.ndarray | None] | None = None,
        dicts: Sequence[np.ndarray | None] | None = None,
        capacity: int | None = None,
        device="cuda",
    ) -> "Batch":
        """Ingest host numpy columns (one per schema field). For a
        dict-encoded field the column is either the raw values (strings,
        Decimals of a wide decimal, or a sequence of the Python values of a
        LIST, MAP or STRUCT, in any form ``nested_normalizer`` takes; encoded
        here) or, when ``dicts[i]`` is given, int32 codes into it. A
        decimal64 column is int64 unscaled values or Decimal objects."""
        dev = resolve_device(device)
        n = len(columns[0]) if columns else 0
        cap = capacity or bucket_capacity(n)
        assert cap >= n, (cap, n)
        vals, masks, out_dicts = [], [], []
        for i, f in enumerate(schema):
            col = columns[i] if f.dtype.is_nested else np.asarray(columns[i])
            valid = None if validity is None else validity[i]
            valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
            d = None
            if f.dtype.is_dict_encoded:
                if dicts is not None and dicts[i] is not None:
                    codes, d = np.asarray(col).astype(np.int32), dicts[i]
                elif f.dtype.is_nested:
                    codes, d = nested_vocab(col, valid, f.dtype)
                elif f.dtype.is_wide_decimal:
                    codes, d = wide_decimal_vocab(col, valid, f.dtype.scale)
                else:
                    codes, d = encode_values(col, valid)
                col = codes
            elif f.dtype.kind == T.TypeKind.DECIMAL:
                col, valid = decimal64_plane(col, valid, f.dtype.scale)
            phys = f.dtype.numpy_dtype()
            v = np.zeros(cap, dtype=phys)
            v[:n] = np.where(valid, col, 0) if not valid.all() else col
            m = np.zeros(cap, dtype=bool)
            m[:n] = valid
            vals.append(v)
            masks.append(m)
            out_dicts.append(d)
        sel = np.zeros(cap, dtype=bool)
        sel[:n] = True
        return Batch(
            schema,
            DeviceBatch(
                torch.from_numpy(sel).to(dev),
                tuple(torch.from_numpy(v).to(dev) for v in vals),
                tuple(torch.from_numpy(m).to(dev) for m in masks),
            ),
            tuple(out_dicts),
        )

    @staticmethod
    def from_arrow(rb, capacity: int | None = None, device="cuda", conf=None) -> "Batch":
        """Arrow RecordBatch (or Table, its chunks combined) ingest through
        pyarrow's C export and ``from_host_arrow`` (imports pyarrow; ``conf``
        resolves ``exec.scan.zerocopy``)."""
        from auron_tpu_torch.columnar.arrow_c import import_from

        if not hasattr(rb, "_export_to_c"):  # a Table: one batch of its combined chunks
            import pyarrow as pa

            rb = pa.RecordBatch.from_arrays([c.combine_chunks() for c in rb.columns],
                                            schema=rb.schema)
        return Batch.from_host_arrow(import_from(rb), capacity=capacity, device=device,
                                     conf=conf)

    @staticmethod
    def from_pydict(data: dict, schema: T.Schema | None = None, capacity: int | None = None,
                    device="cuda") -> "Batch":
        """Python columns ({name: list}) through Arrow, typed by ``schema``
        where given, else as pyarrow infers them (imports pyarrow;
        reference ``columnar/batch.py:255``)."""
        import pyarrow as pa

        if schema is not None:
            rb = pa.record_batch([pa.array(data[f.name], type=f.dtype.to_arrow())
                                  for f in schema], names=[f.name for f in schema])
        else:
            rb = pa.RecordBatch.from_pydict(data)
        return Batch.from_arrow(rb, capacity, device)

    @staticmethod
    def from_pandas(df, schema: T.Schema | None = None, capacity: int | None = None,
                    device="cuda") -> "Batch":
        """pandas ingest through Arrow (imports pandas/pyarrow)."""
        import pyarrow as pa

        rb = pa.RecordBatch.from_pandas(df, preserve_index=False)
        if schema is not None:
            rb = rb.cast(schema.to_arrow())
        return Batch.from_arrow(rb, capacity, device)

    @staticmethod
    def empty(schema: T.Schema, capacity: int = MIN_CAPACITY, device="cuda") -> "Batch":
        dev = resolve_device(device)
        return Batch(
            schema,
            DeviceBatch(
                torch.zeros(capacity, dtype=torch.bool, device=dev),
                tuple(torch.zeros(capacity, dtype=f.dtype.physical_dtype(), device=dev)
                      for f in schema),
                tuple(torch.zeros(capacity, dtype=torch.bool, device=dev) for _ in schema),
            ),
            tuple(empty_dict(f.dtype) if f.dtype.is_dict_encoded else None for f in schema),
        )

    @staticmethod
    def from_host_arrow(hb: HostBatch, capacity: int | None = None, device="cuda",
                        conf=None) -> "Batch":
        """Ingest a host Arrow batch (imported C arrays or an IPC batch) onto
        ``device`` (``capacity`` slots, by default ``bucket_capacity``):
        strings and binaries dictionary-encoded into the per-batch
        vocabulary, decimal128 at p <= 18 into the decimal64 plane (a value
        outside int64 as NULL), wider ones into the wide vocabulary, LIST,
        MAP and STRUCT as identity codes. On the card the host planes and
        the live mask cross through one pinned staging buffer and one copy
        when they hold at most ``transfer.PACK_BYTES`` (``_to_device_packed``:
        a small batch pays one copy's overhead, not one a plane), else each
        through its own (``_to_device``: a large batch's columns do not
        share, and so do not keep alive, one device buffer); a column with
        NULLs crosses its validity bitmap packed, unpacked and its NULL
        lanes zeroed on the device."""
        from auron_tpu_torch.runtime import transfer

        t0 = time.perf_counter()
        dev = resolve_device(device)
        n = hb.length
        cap = capacity or bucket_capacity(n)
        assert cap >= n, (cap, n)
        zc = zero_copy_enabled(conf)
        counts = {"zerocopy_planes": 0, "copied_planes": 0, "ingest_bytes": 0}
        # (host plane, slots) to copy, the live mask first; per column what
        # to make of them
        stage, cols = [(np.ones(n, bool), cap)], []
        for f, arr in zip(hb.schema, hb.columns):
            plane, is_view, validity, vocab = host_plane(arr, f.dtype)
            if plane is None:  # the NULL type
                cols.append(None)
                continue
            if is_view and zc:
                counts["zerocopy_planes"] += 1
            else:
                if is_view:
                    plane = np.array(plane)  # the owned copy the key's off setting makes
                counts["copied_planes"] += 1
            stage.append((plane, cap))
            mask = None
            if validity is not None:
                bits, bit_off = validity if isinstance(validity, tuple) else (validity, None)
                mask = (len(stage), bit_off)
                stage.append((bits, cap if bit_off is None else len(bits)))
            cols.append((len(stage) - 1 - (mask is not None), mask, vocab))
        if dev.type == "cuda" and sum(slots * p.dtype.itemsize for p, slots in stage) \
                <= transfer.PACK_BYTES:
            staged = _to_device_packed(stage, dev)
        else:
            staged = [_to_device(plane, slots, dev) for plane, slots in stage]
        live = staged[0]
        vals, masks, dicts = [], [], []
        for c in cols:
            if c is None:
                vals.append(torch.zeros(cap, dtype=torch.int8, device=dev))
                masks.append(torch.zeros(cap, dtype=torch.bool, device=dev))
                dicts.append(None)
                continue
            i, mask, vocab = c
            v = staged[i]
            counts["ingest_bytes"] += v.numel() * v.element_size()
            if mask is None:
                m = live
            else:
                j, bit_off = mask
                counts["ingest_bytes"] += staged[j].numel()
                m = staged[j] if bit_off is None else _unpack_bits(staged[j], bit_off, n, cap)
                v = torch.where(m, v, torch.zeros((), dtype=v.dtype, device=dev))
            vals.append(v)
            masks.append(m)
            dicts.append(vocab)
        _count_ingest(counts, time.perf_counter() - t0)
        return Batch(hb.schema, DeviceBatch(live, tuple(vals), tuple(masks)), tuple(dicts))

    # ---- accessors ----

    @property
    def capacity(self) -> int:
        return self.device.capacity

    @property
    def torch_device(self) -> torch.device:
        return self.device.sel.device

    def num_rows(self) -> int:
        """Live row count — one device read."""
        return int(self.device.num_rows().item())

    def col_values(self, i: int) -> torch.Tensor:
        return self.device.values[i]

    def col_validity(self, i: int) -> torch.Tensor:
        return self.device.validity[i]

    def with_device(self, dev: DeviceBatch, schema: T.Schema | None = None,
                    dicts: tuple | None = None) -> "Batch":
        return Batch(schema or self.schema, dev,
                     dicts if dicts is not None else self.dicts)

    # ---- materialization ----

    def to_numpy(self) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        """Live rows on the host: name -> (values, validity). Dict-encoded
        columns (wide decimals too) decode to object arrays (None at NULL
        rows); a decimal64 column stays int64 unscaled values."""
        sel = self.device.sel.cpu().numpy()
        idx = np.flatnonzero(sel)
        out = {}
        for i, f in enumerate(self.schema):
            v = self.device.values[i].cpu().numpy()[idx]
            m = self.device.validity[i].cpu().numpy()[idx]
            if f.dtype.is_dict_encoded:
                d = self.dicts[i]
                dec = [d[c] if ok else None for c, ok in zip(v.tolist(), m.tolist())]
                if f.dtype.is_nested:
                    v = object_array(dec)
                else:
                    v = np.empty(len(dec), dtype=object)
                    v[:] = dec
            out[f.name] = (v, m)
        return out

    def to_pydict(self) -> dict[str, list]:
        """Live rows as Python lists, decimals as ``decimal.Decimal``."""
        out = {}
        for f, (name, (v, m)) in zip(self.schema, self.to_numpy().items()):
            vals = v.tolist()
            if f.dtype.kind == T.TypeKind.DECIMAL and not f.dtype.is_wide_decimal:
                vals = [T.decimal_from_unscaled(x, f.dtype.scale) for x in vals]
            out[name] = [x if ok else None for x, ok in zip(vals, m.tolist())]
        return out

    def to_pandas(self):
        """Live rows as a pandas frame through Arrow (imports pyarrow and
        pandas; reference ``columnar/batch.py:341``)."""
        return self.to_arrow().to_pandas()

    def prefetch_host(self) -> None:
        """Start the device->host copies of every plane now
        (``runtime/transfer.start_host_transfer``); ``to_host_arrow``
        harvests them."""
        from auron_tpu_torch.runtime.transfer import start_host_transfer

        d = self.device
        self._host_transfer = start_host_transfer(d.sel, *d.values, *d.validity)

    def live_host_planes(self, metrics=None) -> tuple[int, list]:
        """(live rows, [(values, validity)] of each column's live rows) on the
        host: every plane copied through ``runtime/transfer.py`` (pinned,
        under one event; the copies ``prefetch_host`` started, when it ran)."""
        from auron_tpu_torch.runtime.transfer import harvest, start_host_transfer

        tr = getattr(self, "_host_transfer", None)
        self._host_transfer = None
        if tr is None:
            d = self.device
            tr = start_host_transfer(d.sel, *d.values, *d.validity)
        host = harvest(tr, metrics)
        k = len(self.schema)
        idx = np.flatnonzero(host[0])
        return len(idx), [(host[1 + i][idx], host[1 + k + i][idx]) for i in range(k)]

    def to_host_arrow(self, metrics=None) -> HostBatch:
        """Live rows as a host Arrow batch: vocabularies expanded, validity
        packed, decimals as decimal128 (``live_host_planes``)."""
        n, planes = self.live_host_planes(metrics)
        cols = []
        for i, (f, (v, m)) in enumerate(zip(self.schema, planes)):
            if f.dtype.is_dict_encoded:
                d = self.dicts[i]
                v = object_array([d[c] if ok else None for c, ok in zip(v.tolist(), m.tolist())])
            cols.append(array_from_numpy(v, f.dtype, m))
        return HostBatch(self.schema, n, tuple(cols))

    def to_arrow(self, metrics=None):
        """Live rows as a pyarrow RecordBatch (imports pyarrow): the host
        Arrow batch of ``to_host_arrow`` (pinned copies) exported through the
        C data interface (``arrow_c.export_batch``) and imported by pyarrow,
        with no pyarrow conversion of each column."""
        import ctypes

        from auron_tpu_torch.utils.arrowlib import pyarrow

        pa = pyarrow()
        arr, sch = ArrowArray(), ArrowSchema()
        export_batch(self.to_host_arrow(metrics), ctypes.addressof(arr), ctypes.addressof(sch))
        return pa.RecordBatch._import_from_c(ctypes.addressof(arr), ctypes.addressof(sch))


# ---------------------------------------------------------------------------
# host Arrow ingest: zero-copy planes, pinned staging, the counters
# (reference columnar/batch.py:55-100, 440-560)
# ---------------------------------------------------------------------------

_ingest_lock = threading.Lock()
_INGEST_STATS = {"zerocopy_planes": 0, "copied_planes": 0, "ingest_bytes": 0, "ingest_s": 0.0}


def zero_copy_enabled(conf=None) -> bool:
    """Resolve the exec.scan.zerocopy tri-state (auto = on)."""
    c = conf if conf is not None else active_conf()
    return resolve_tri(c.get(SCAN_ZEROCOPY), True)


def _count_ingest(counts: dict, seconds: float) -> None:
    with _ingest_lock:
        for k, v in counts.items():
            _INGEST_STATS[k] += v
        _INGEST_STATS["ingest_s"] += seconds


def ingest_stats() -> dict:
    """Snapshot of the ingest counters: value planes staged straight from
    the producer's buffer (``zerocopy_planes``, one host copy) or from an
    array the host made first (``copied_planes``: the key's owned copy or a
    conversion), bytes copied to the device (``ingest_bytes``) and host
    seconds in ``from_host_arrow`` (``ingest_s``)."""
    with _ingest_lock:
        return dict(_INGEST_STATS)


def reset_ingest_stats() -> None:
    with _ingest_lock:
        for k in _INGEST_STATS:
            _INGEST_STATS[k] = 0


_TORCH_DTYPE = {np.dtype(d): t for d, t in (
    (np.bool_, torch.bool), (np.int8, torch.int8), (np.uint8, torch.uint8),
    (np.int16, torch.int16), (np.int32, torch.int32), (np.int64, torch.int64),
    (np.float32, torch.float32), (np.float64, torch.float64))}


def _to_device(plane: np.ndarray, cap: int, dev: torch.device) -> torch.Tensor:
    """A ``cap``-slot tensor on ``dev`` holding ``plane`` then zeros; on the
    card through a pinned staging buffer and a ``non_blocking`` copy. The
    buffer is freed when this returns, under its copy: PyTorch's caching
    host allocator records an event on a pinned block that a
    ``non_blocking`` copy reads and reuses the block only once that event
    has completed, so a staging buffer is never overwritten under a running
    copy. On the CPU the staging buffer is the batch's own tensor."""
    n = len(plane)
    if dev.type != "cuda":
        out = np.zeros(cap, plane.dtype)
        out[:n] = plane
        return torch.from_numpy(out)
    st = torch.empty(cap, dtype=_TORCH_DTYPE[plane.dtype], pin_memory=True)
    h = st.numpy()
    h[:n] = plane
    h[n:] = 0
    return st.to(dev, non_blocking=True)


def _to_device_packed(stage: list, dev: torch.device) -> list:
    """``_to_device`` of every (plane, slots) in ``stage`` through one pinned
    staging buffer and one ``non_blocking`` copy: each result is a view of
    one device buffer, its region 16-byte aligned (the staging buffer is
    freed under its copy as ``_to_device``'s is)."""
    offs, total = [], 0
    for plane, slots in stage:
        offs.append(total)
        total += -(-slots * plane.dtype.itemsize // 16) * 16
    st = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    h = st.numpy()
    for (plane, slots), off in zip(stage, offs):
        view = h[off: off + slots * plane.dtype.itemsize].view(plane.dtype)
        view[:len(plane)] = plane
        view[len(plane):] = 0
    d = st.to(dev, non_blocking=True)
    return [d[off: off + slots * plane.dtype.itemsize].view(_TORCH_DTYPE[plane.dtype])
            for (plane, slots), off in zip(stage, offs)]


def _unpack_bits(packed: torch.Tensor, bit_off: int, n: int, cap: int) -> torch.Tensor:
    """bool[cap]: rows ``bit_off .. bit_off + n`` of a little-endian packed
    bitmap, unpacked on its device, then False."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = ((packed[:, None] >> shifts) & 1).reshape(-1)[bit_off: bit_off + n].to(torch.bool)
    out = torch.zeros(cap, dtype=torch.bool, device=packed.device)
    out[:n] = bits
    return out


#: Arrow fixed-width formats whose values buffer is the physical plane as is
_VIEW_FORMATS = {"c": np.int8, "s": np.int16, "i": np.int32, "l": np.int64, "f": np.float32,
                 "g": np.float64, "tdD": np.int32, "tsu": np.int64}
_WIDEN = {"C": np.uint8, "S": np.uint16, "I": np.uint32, "L": np.uint64}


def host_plane(arr: HostArray, dtype: T.DataType):
    """(values plane of ``arr.length`` rows or None for the NULL type,
    whether it is a view of the producer's buffer, validity, vocabulary).
    Validity is None (no NULLs), (packed bitmap bytes, bit offset) or a
    bool array (when the host had to decide it: a decimal that leaves
    int64 turns NULL)."""
    n = arr.length
    k = dtype.kind
    if k == T.TypeKind.NULL:
        return None, False, None, None
    if arr.dictionary is not None and (dtype.is_nested or not dtype.is_dict_encoded):
        arr = arr.normalized()  # a dictionary of nested or fixed-width values: decoded
    validity = arr.validity_bits() if arr.nulls() else None
    fmt = arr.fmt if arr.fmt[:2] != "ts" else arr.fmt[:3]
    if arr.dictionary is not None:
        codes = arr.typed(1, np.dtype(_VIEW_FORMATS.get(fmt) or _WIDEN[fmt]), n, arr.offset)
        vocab = object_array(arr.dictionary.to_pylist())
        is_view = codes.dtype == np.int32
        return (codes if is_view else codes.astype(np.int32), is_view, validity,
                vocab if len(vocab) else empty_dict(dtype))
    if k == T.TypeKind.BOOL:
        return arr.bool_values(), False, validity, None
    if fmt in _VIEW_FORMATS:
        return arr.typed(1, _VIEW_FORMATS[fmt], n, arr.offset), True, validity, None
    if fmt[:2] == "ts":  # seconds, milliseconds or nanoseconds
        return micros(arr.typed(1, np.int64, n, arr.offset), fmt), False, validity, None
    if fmt in _WIDEN:
        raw = arr.typed(1, _WIDEN[fmt], n, arr.offset)
        if fmt == "L" and (raw[arr.valid_mask()] > np.iinfo(np.int64).max).any():
            raise ValueError("a uint64 value does not fit int64")
        return raw.astype(dtype.numpy_dtype()), False, validity, None
    if k == T.TypeKind.DECIMAL and not dtype.is_wide_decimal:
        words = arr.decimal_words()
        lo, hi = np.ascontiguousarray(words[:, 0]), words[:, 1]
        fits = hi == (lo >> 63)
        if not fits.all():
            validity = arr.valid_mask() & fits
        return lo, False, validity, None
    valid = arr.valid_mask()
    if dtype.is_nested:
        codes, vocab = nested_vocab(arr.to_pylist(), valid, dtype)
    elif dtype.is_wide_decimal:
        codes, vocab = wide_decimal_vocab(object_array(arr.to_pylist()), valid, dtype.scale)
    else:
        codes, vocab = encode_values(object_array(arr.to_pylist()), valid)
    return codes, False, validity, vocab


# ---------------------------------------------------------------------------
# batch-level utilities
# ---------------------------------------------------------------------------


def device_take(dev: DeviceBatch, order: torch.Tensor) -> DeviceBatch:
    """Permute every column by one index tensor."""
    return DeviceBatch(
        dev.sel[order],
        tuple(v[order] for v in dev.values),
        tuple(m[order] for m in dev.validity),
    )


def merge_vocab(entry_lists: Sequence) -> tuple[np.ndarray, list[np.ndarray]]:
    """Merge per-source vocabularies into ONE (first-occurrence order, equal
    entries by ``vocab_key``); returns (unified, per-source remap tables
    new = remaps[src][old])."""
    vocab: dict = {}
    values: list = []
    remaps: list[np.ndarray] = []
    for entries in entry_lists:
        r = np.empty(len(entries), dtype=np.int32)
        for i, s in enumerate(entries):
            k = vocab_key(s) if isinstance(s, (list, dict, tuple)) else s
            if k in vocab:
                r[i] = vocab[k]
            else:
                r[i] = vocab[k] = len(values)
                values.append(s)
        remaps.append(r)
    return object_array(values or [""]), remaps


def unify_dict(batches: Sequence[Batch], col: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """One vocabulary for column ``col`` across batches: (unified, per-batch
    remap tables with new_code = remaps[i][old_code]); the device remap is
    then a single gather."""
    entries = []
    for b in batches:
        if b.dicts[col] is None:
            raise ValueError(f"column {col} of {b.schema[col].name} is not dictionary-encoded")
        entries.append(b.dicts[col])
    return merge_vocab(entries)


def device_concat(batches: Sequence[Batch]) -> Batch:
    """Concatenate batches on the device. Output capacity is the bucket of
    the summed input capacities (dead rows keep sel=0); dictionary columns
    are unified on the host and their codes remapped with one gather, and
    a nested column's vocabularies (identity-coded, one entry per row) are
    laid end to end, each batch's codes shifted by the entries before it."""
    assert batches
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    total = sum(b.capacity for b in batches)
    cap = bucket_capacity(total)
    pad = cap - total
    dev = batches[0].torch_device

    def cat(parts):
        out = torch.cat(parts)
        if pad:
            out = torch.cat([out, torch.zeros(pad, dtype=out.dtype, device=dev)])
        return out

    values, validity, dicts = [], [], []
    for ci, f in enumerate(schema):
        vs = [b.col_values(ci) for b in batches]
        d = None
        if f.dtype.is_nested:
            sizes = [len(b.dicts[ci]) for b in batches]
            d = np.concatenate([b.dicts[ci] for b in batches])
            starts = np.cumsum([0] + sizes[:-1]).tolist()
            vs = [v.clamp(0, n - 1) + s for v, n, s in zip(vs, sizes, starts)]
        elif f.dtype.is_dict_encoded:
            d, remaps = merge_vocab([b.dicts[ci] for b in batches])
            vs = [
                torch.from_numpy(r).to(dev)[v.clamp(0, len(r) - 1).long()]
                for v, r in zip(vs, remaps)
            ]
        values.append(cat(vs))
        validity.append(cat([b.col_validity(ci) for b in batches]))
        dicts.append(d)
    sel = cat([b.device.sel for b in batches])
    return Batch(schema, DeviceBatch(sel, tuple(values), tuple(validity)), tuple(dicts))


def compaction_index(sel: torch.Tensor, out_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx[out_cap], sel_out[out_cap]): positions of the live rows, in
    order, by a cumsum and ``searchsorted`` (``auron_tpu/columnar/batch.py:
    701``). Static size and no host read: live rows past ``out_cap`` are
    dropped, and the caller that sized ``out_cap`` by a prediction checks
    the live count later."""
    cap = sel.shape[0]
    pos = torch.cumsum(sel.to(torch.int64), 0)
    want = torch.arange(1, out_cap + 1, dtype=torch.int64, device=sel.device)
    idx = torch.searchsorted(pos, want).clamp_(0, max(cap - 1, 0))
    sel_out = want <= pos[-1]
    return idx, sel_out


def compact_batch(batch: Batch, out_capacity: int) -> Batch:
    """Gather live rows into a dense prefix of ``out_capacity`` slots
    (callers size it at the live count or more; rows past it are dropped)."""
    if out_capacity >= batch.capacity:
        return batch
    dev = batch.device
    idx, sel_out = compaction_index(dev.sel, out_capacity)
    return Batch(
        batch.schema,
        DeviceBatch(
            sel_out,
            tuple(v[idx] for v in dev.values),
            tuple(m[idx] & sel_out for m in dev.validity),
        ),
        batch.dicts,
    )


def prefix_slice(batch: Batch, new_capacity: int) -> Batch:
    """Keep only the first new_capacity slots."""
    if new_capacity >= batch.capacity:
        return batch
    dev = batch.device
    return Batch(
        batch.schema,
        DeviceBatch(
            dev.sel[:new_capacity],
            tuple(v[:new_capacity] for v in dev.values),
            tuple(m[:new_capacity] for m in dev.validity),
        ),
        batch.dicts,
    )


# ---------------------------------------------------------------------------
# host rows of columns (the host-evaluation contracts: row-wise functions,
# list construction) without Arrow
# ---------------------------------------------------------------------------


def _python_value(v, dtype: T.DataType, d):
    """One physical value as the Python value Arrow's ``to_pylist`` gives:
    a vocabulary entry, a Decimal, a ``datetime.date`` or a naive
    ``datetime.datetime``, else the number."""
    import datetime as _dt

    k = dtype.kind
    if dtype.is_dict_encoded:
        return d[min(max(int(v), 0), len(d) - 1)]
    if k == T.TypeKind.DECIMAL:
        return T.decimal_from_unscaled(int(v), dtype.scale)
    if k == T.TypeKind.DATE32:
        return _dt.date(1970, 1, 1) + _dt.timedelta(days=int(v))
    if k == T.TypeKind.TIMESTAMP:
        return _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=int(v))
    if k == T.TypeKind.NULL:
        return None
    return v.item() if hasattr(v, "item") else v


def host_pylists(cvs, metrics=None) -> list[list]:
    """Every row of each column (``.values``/``.validity``/``.dtype``/
    ``.dict``) as a Python list, NULL rows None: ONE batched device->host
    read for all columns (``runtime/transfer.py``: one event behind every
    copy)."""
    from auron_tpu_torch.runtime.transfer import harvest, start_host_transfer

    tensors = []
    for cv in cvs:
        tensors += [cv.values, cv.validity]
    host = harvest(start_host_transfer(*tensors), metrics, "blocking_reads")
    out = []
    for j, cv in enumerate(cvs):
        vals, mask = host[2 * j], host[2 * j + 1]
        dt = cv.dtype
        if dt.is_dict_encoded:  # the vocabulary's entries, gathered by code
            d = cv.dict
            col = d[np.clip(vals, 0, len(d) - 1)].tolist()
        elif dt.is_integer or dt.is_float or dt.kind == T.TypeKind.BOOL:
            col = vals.tolist()
        else:
            col = [_python_value(v, dt, None) for v in vals]
        for i in np.flatnonzero(~mask).tolist():
            col[i] = None
        out.append(col)
    return out


def host_arrays(cvs, metrics=None) -> list[HostArray]:
    """Every slot of each column (``.values``/``.validity``/``.dtype``/
    ``.dict``) as a host Arrow array, NULL slots NULL and vocabularies
    expanded: ONE batched device->host read for all columns (the host
    callbacks' argument columns, ``bridge/udf.py``)."""
    from auron_tpu_torch.runtime.transfer import harvest, start_host_transfer

    tensors = []
    for cv in cvs:
        tensors += [cv.values, cv.validity]
    host = harvest(start_host_transfer(*tensors), metrics, "blocking_reads")
    out = []
    for j, cv in enumerate(cvs):
        vals, mask = host[2 * j], host[2 * j + 1]
        if cv.dtype.is_dict_encoded:
            d = cv.dict
            vals = d[np.clip(vals, 0, len(d) - 1)] if len(d) else object_array([None] * len(vals))
        out.append(array_from_numpy(vals, cv.dtype, mask))
    return out


def _physical_of(x, dtype: T.DataType):
    """A Python value (as ``_python_value`` gives it) as the physical value of
    a fixed-width column."""
    import datetime as _dt

    if dtype.kind == T.TypeKind.DATE32 and isinstance(x, _dt.date):
        return (x - _dt.date(1970, 1, 1)).days
    if dtype.kind == T.TypeKind.TIMESTAMP and isinstance(x, _dt.datetime):
        delta = x.replace(tzinfo=None) - _dt.datetime(1970, 1, 1)
        return (delta.days * 86_400 + delta.seconds) * 1_000_000 + delta.microseconds
    return x


def column_from_pylist(values: list, dtype: T.DataType, cap: int, device):
    """(values tensor[cap], validity[cap], vocabulary or None) of a host column
    given as Python values (None = NULL), through the port's own encoders
    (``Batch.from_numpy``): strings dictionary-encoded, nested values as
    identity codes, decimals at the type's scale."""
    n = len(values)
    valid = np.array([x is not None for x in values], dtype=bool)
    if dtype.kind == T.TypeKind.NULL:
        return (torch.zeros(cap, dtype=torch.int8, device=resolve_device(device)),
                torch.zeros(cap, dtype=torch.bool, device=resolve_device(device)), None)
    if dtype.is_dict_encoded or dtype.kind == T.TypeKind.DECIMAL:
        col = values if dtype.is_nested else object_array(values)
        if dtype.kind == T.TypeKind.DECIMAL and not dtype.is_wide_decimal:
            col = object_array([x if x is not None else 0 for x in values])
    else:
        zero = False if dtype.kind == T.TypeKind.BOOL else 0
        col = np.array([_physical_of(x, dtype) if x is not None else zero for x in values],
                       dtype=dtype.numpy_dtype()) if n else np.zeros(0, dtype.numpy_dtype())
    b = Batch.from_numpy([col], T.Schema((T.Field("c", dtype, True),)), [valid],
                         capacity=cap, device=device)
    return b.device.values[0], b.device.validity[0], b.dicts[0]
