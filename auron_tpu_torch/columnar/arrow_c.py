"""The Arrow C data interface in ``ctypes``, without pyarrow.

The reference crosses the host boundary with pyarrow's ``_import_from_c``
and ``_export_to_c`` (``auron_tpu/bridge/api.py:36-70``). The machine with
the card has no pyarrow, so the port reads and writes the three C structs of
the specification (``ArrowSchema``, ``ArrowArray``, ``ArrowArrayStream``)
itself. This module has no counterpart in the reference (like
``ops/uwords.py``).

Host data lives in ``HostArray`` / ``HostBatch``: Arrow's physical layout
(format string, length, null count, offset, buffers, children, dictionary)
with numpy arrays as buffers. The IPC reader and writer
(``columnar/arrow_ipc.py``) and the device ingest and egress
(``Batch.from_host_arrow`` / ``Batch.to_host_arrow``) share it.

- Import (``import_batch``, ``import_stream``): every format of the types
  ``types.py`` holds — ``n b c s i l C S I L f g tdD tss: tsm: tsu: tsn:
  d:p,s u U z Z +l +L +m +s`` (timestamps to microseconds; a map's
  ``entries`` struct holds its key and value children, and its
  keys-sorted flag is read and not needed) — and dictionary
  arrays (``ArrowSchema.dictionary``), with ``offset`` != 0,
  ``null_count`` = -1 and a NULL validity buffer.
  Buffers come out as read-only numpy views of the producer's memory: no
  Python object per row for fixed-width data. The imported ``ArrowArray``
  is released exactly once, when the last view of its buffers is gone (or
  at ``close``); an imported schema is released as soon as it is parsed.
- Export (``export_batch``, ``export_stream``): a host batch as
  ``ArrowArray`` + ``ArrowSchema``, and a stream producer over a list of
  host batches. The structs' release callbacks keep every buffer alive until
  the consumer releases the struct (a child moved out by the consumer is
  released on its own), as the specification requires.
- A struct array's offset applies to its children, as the specification
  says: ``HostArray`` keeps both offsets as they came.

``stats()`` counts imported and released arrays and exported structs still
alive, so a test can hold each release to exactly once.
"""

from __future__ import annotations

import ctypes
import datetime as _dt
import itertools
import threading
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from auron_tpu_torch import types as T

# ---------------------------------------------------------------------------
# the structs (Arrow C data interface specification)
# ---------------------------------------------------------------------------

ARROW_FLAG_NULLABLE = 2


class ArrowSchema(ctypes.Structure):
    _fields_ = [("format", ctypes.c_void_p), ("name", ctypes.c_void_p),
                ("metadata", ctypes.c_void_p), ("flags", ctypes.c_int64),
                ("n_children", ctypes.c_int64), ("children", ctypes.c_void_p),
                ("dictionary", ctypes.c_void_p), ("release", ctypes.c_void_p),
                ("private_data", ctypes.c_void_p)]


class ArrowArray(ctypes.Structure):
    _fields_ = [("length", ctypes.c_int64), ("null_count", ctypes.c_int64),
                ("offset", ctypes.c_int64), ("n_buffers", ctypes.c_int64),
                ("n_children", ctypes.c_int64), ("buffers", ctypes.c_void_p),
                ("children", ctypes.c_void_p), ("dictionary", ctypes.c_void_p),
                ("release", ctypes.c_void_p), ("private_data", ctypes.c_void_p)]


class ArrowArrayStream(ctypes.Structure):
    _fields_ = [("get_schema", ctypes.c_void_p), ("get_next", ctypes.c_void_p),
                ("get_last_error", ctypes.c_void_p), ("release", ctypes.c_void_p),
                ("private_data", ctypes.c_void_p)]


_SCHEMA_RELEASE = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowSchema))
_ARRAY_RELEASE = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowArray))
_STREAM_GET_SCHEMA = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ArrowArrayStream),
                                      ctypes.POINTER(ArrowSchema))
_STREAM_GET_NEXT = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ArrowArrayStream),
                                    ctypes.POINTER(ArrowArray))
_STREAM_GET_LAST_ERROR = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.POINTER(ArrowArrayStream))
_STREAM_RELEASE = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowArrayStream))

_EIO = 5
_MASK64 = (1 << 64) - 1

_lock = threading.Lock()
_STATS = {"arrays_imported": 0, "arrays_released": 0, "struct_releases": 0}


def stats() -> dict:
    """Counters: arrays imported and released by this module (each once),
    releases of exported structs (one per struct of an exported tree), and
    exported trees still held by a consumer (``exports_live``)."""
    with _lock:
        return {**_STATS, "exports_live": len(_EXPORTS)}


# ---------------------------------------------------------------------------
# format strings <-> logical types
# ---------------------------------------------------------------------------

#: fixed-width formats: (numpy dtype of the values buffer, logical type)
_FIXED = {
    "c": (np.int8, T.INT8), "C": (np.uint8, T.INT16), "s": (np.int16, T.INT16),
    "S": (np.uint16, T.INT32), "i": (np.int32, T.INT32), "I": (np.uint32, T.INT64),
    "l": (np.int64, T.INT64), "L": (np.uint64, T.INT64), "f": (np.float32, T.FLOAT32),
    "g": (np.float64, T.FLOAT64), "tdD": (np.int32, T.DATE32),
}
#: timestamp units -> (multiplier, divisor) to microseconds
_TS_UNITS = {"tss": (1_000_000, 1), "tsm": (1_000, 1), "tsu": (1, 1), "tsn": (1, 1_000)}


def micros(raw: np.ndarray, unit: str) -> np.ndarray:
    """int64 microseconds of timestamps stored in ``unit`` (``tss`` ..
    ``tsn``); nanoseconds floor to the microsecond below."""
    mul, div = _TS_UNITS[unit]
    return raw * mul if div == 1 else raw // div
_STRINGS = {"u": (np.int32, T.STRING), "U": (np.int64, T.STRING),
            "z": (np.int32, T.BINARY), "Z": (np.int64, T.BINARY)}
#: formats with an offsets buffer and one child: lists and maps
_LISTS = {"+l": np.int32, "+L": np.int64, "+m": np.int32}


def _decimal_of(fmt: str) -> T.DataType:
    parts = fmt[2:].split(",")
    if len(parts) == 3 and parts[2] != "128":
        raise NotImplementedError(f"Arrow decimal{parts[2]} ({fmt!r}) is not in the port")
    return T.decimal(int(parts[0]), int(parts[1]))


def dtype_of(fmt: str, children: Sequence = (), names: Sequence = ()) -> T.DataType:
    """Logical type of an Arrow format string (``children``: the child
    fields' types, ``names`` their names, for a list, map or struct)."""
    if fmt == "n":
        return T.NULL
    if fmt == "b":
        return T.BOOL
    if fmt in _FIXED:
        return _FIXED[fmt][1]
    if fmt[:3] in _TS_UNITS and fmt[3:4] == ":":
        return T.TIMESTAMP
    if fmt.startswith("d:"):
        return _decimal_of(fmt)
    if fmt in _STRINGS:
        return _STRINGS[fmt][1]
    if fmt == "+m":  # one child: the entries struct of (key, value)
        return T.DataType(T.TypeKind.MAP, inner=tuple(children[0].inner[:2]))
    if fmt in _LISTS:
        return T.DataType(T.TypeKind.LIST, inner=(children[0],))
    if fmt == "+s":
        return T.DataType(T.TypeKind.STRUCT, inner=tuple(children), struct_names=tuple(names))
    raise NotImplementedError(f"Arrow format {fmt!r} is not in the port's types")


def format_of(dtype: T.DataType) -> str:
    """The canonical Arrow format string the port writes for a type."""
    k = dtype.kind
    canon = {T.TypeKind.NULL: "n", T.TypeKind.BOOL: "b", T.TypeKind.INT8: "c",
             T.TypeKind.INT16: "s", T.TypeKind.INT32: "i", T.TypeKind.INT64: "l",
             T.TypeKind.FLOAT32: "f", T.TypeKind.FLOAT64: "g", T.TypeKind.DATE32: "tdD",
             T.TypeKind.TIMESTAMP: "tsu:", T.TypeKind.STRING: "u", T.TypeKind.BINARY: "z",
             T.TypeKind.LIST: "+l", T.TypeKind.MAP: "+m", T.TypeKind.STRUCT: "+s"}
    if k == T.TypeKind.DECIMAL:
        return f"d:{dtype.precision},{dtype.scale}"
    if k in canon:
        return canon[k]
    raise NotImplementedError(f"Arrow format of {dtype} is not in the port's types")


def entries_dtype(map_type: T.DataType) -> T.DataType:
    """The STRUCT type of a MAP's ``entries`` child."""
    return T.DataType(T.TypeKind.STRUCT, inner=map_type.inner, struct_names=("key", "value"))


# ---------------------------------------------------------------------------
# host arrays
# ---------------------------------------------------------------------------


@dataclass
class HostArray:
    """One Arrow array on the host: ``buffers`` are uint8 numpy arrays (or
    None) in the layout ``fmt`` names; ``dtype`` is the logical type (the
    value type, for a dictionary array, whose ``fmt`` is the index
    format). ``null_count`` -1 means not computed."""

    fmt: str
    dtype: T.DataType
    length: int
    null_count: int
    offset: int
    buffers: tuple
    children: tuple = ()
    dictionary: "HostArray | None" = None

    def typed(self, i: int, npdt, count: int, start: int = 0) -> np.ndarray:
        """``count`` items of buffer ``i`` as ``npdt`` from item ``start``."""
        npdt = np.dtype(npdt)
        buf = self.buffers[i]
        if count == 0 or buf is None:
            return np.zeros(count, npdt)
        lo = start * npdt.itemsize
        return buf[lo: lo + count * npdt.itemsize].view(npdt)

    def validity_bits(self) -> tuple[np.ndarray, int] | None:
        """(packed little-endian validity bytes covering the rows, bit offset
        of the first row), or None when every row is valid."""
        if self.fmt == "n" or self.buffers[0] is None or self.null_count == 0 or not self.length:
            return None
        lo = self.offset // 8
        hi = (self.offset + self.length + 7) // 8
        return self.buffers[0][lo:hi], self.offset % 8

    def valid_mask(self) -> np.ndarray:
        """Validity of each row as bools (a NULL-typed array: all False)."""
        if self.fmt == "n":
            return np.zeros(self.length, bool)
        bits = self.validity_bits()
        if bits is None:
            return np.ones(self.length, bool)
        packed, off = bits
        return np.unpackbits(packed, bitorder="little")[off: off + self.length].astype(bool)

    def nulls(self) -> int:
        """The null count, computed from the bitmap when it was -1."""
        if self.null_count >= 0 and self.fmt != "n":
            return self.null_count
        return self.length - int(np.count_nonzero(self.valid_mask()))

    def offsets(self) -> np.ndarray:
        """The ``length + 1`` offsets of a string, binary or list array."""
        npdt = _STRINGS[self.fmt][0] if self.fmt in _STRINGS else _LISTS[self.fmt]
        if self.buffers[1] is None:
            return np.zeros(self.length + 1, npdt)
        return self.typed(1, npdt, self.length + 1, self.offset)

    def bool_values(self) -> np.ndarray:
        """Bit-packed BOOL values as bools."""
        lo = self.offset // 8
        hi = (self.offset + self.length + 7) // 8
        if self.buffers[1] is None or not self.length:
            return np.zeros(self.length, bool)
        bits = np.unpackbits(self.buffers[1][lo:hi], bitorder="little")
        return bits[self.offset % 8: self.offset % 8 + self.length].astype(bool)

    def decimal_words(self) -> np.ndarray:
        """(lo, hi) int64 words of each decimal128 value, as [length, 2]."""
        return self.typed(1, np.int64, 2 * self.length, 2 * self.offset).reshape(-1, 2)

    def to_pylist(self) -> list:
        """Python values as pyarrow's ``to_pylist`` gives them (ints, floats,
        bools, str, bytes, Decimal, datetime.date, naive datetime.datetime,
        lists, maps as lists of (key, value) tuples, structs as dicts), NULL
        rows None."""
        if self.dictionary is not None:
            idx = self.typed(1, _FIXED[self.fmt][0], self.length, self.offset)
            entries = self.dictionary.to_pylist()
            return [entries[int(i)] if ok else None
                    for i, ok in zip(idx.tolist(), self.valid_mask().tolist())]
        vals = self._values()
        if not self.nulls():
            return vals
        return [v if ok else None for v, ok in zip(vals, self.valid_mask().tolist())]

    def _values(self) -> list:
        f, n = self.fmt, self.length
        if f == "n":
            return [None] * n
        if f == "b":
            return self.bool_values().tolist()
        if f in _FIXED:
            vals = self.typed(1, _FIXED[f][0], n, self.offset).tolist()
            if f == "tdD":
                epoch = _dt.date(1970, 1, 1)
                return [epoch + _dt.timedelta(days=d) for d in vals]
            return vals
        if f[:3] in _TS_UNITS:
            epoch = _dt.datetime(1970, 1, 1)
            return [epoch + _dt.timedelta(microseconds=v) for v in
                    micros(self.typed(1, np.int64, n, self.offset), f[:3]).tolist()]
        if f.startswith("d:"):
            scale = self.dtype.scale
            return [T.decimal_from_unscaled((h << 64) | (lo & _MASK64), scale)
                    for lo, h in self.decimal_words().tolist()]
        if f in _STRINGS:
            offs = self.offsets().tolist()
            data = bytes(self.buffers[2][offs[0]: offs[-1]]) if n and self.buffers[2] is not None \
                else b""
            base = offs[0]
            raw = [data[a - base: b - base] for a, b in zip(offs[:-1], offs[1:])]
            return [r.decode("utf-8") for r in raw] if self.dtype.kind == T.TypeKind.STRING \
                else raw
        if f in _LISTS:
            offs = self.offsets().tolist()
            items = self.children[0].to_pylist()
            if f == "+m":  # the entries struct's (key, value) rows
                items = [tuple(e.values()) for e in items]
            return list(map(items.__getitem__, map(slice, offs[:-1], offs[1:])))
        if f == "+s":
            cols = [_slice(c, self.offset, n).to_pylist() for c in self.children]
            return [dict(zip(self.dtype.struct_names, row)) for row in zip(*cols)] \
                if cols else [{} for _ in range(n)]
        raise NotImplementedError(f"Arrow format {f!r} is not in the port's types")

    def normalized(self) -> "HostArray":
        """The same values at offset 0, dictionary decoded (what an IPC body
        holds); buffers are views where the layout allows."""
        if self.dictionary is not None:
            return array_from_pylist(self.to_pylist(), self.dtype)
        n, f = self.length, self.fmt
        nulls = self.nulls()
        if not nulls or f == "n":
            validity = None
        elif self.offset % 8 == 0:
            validity = self.buffers[0][self.offset // 8: (self.offset + n + 7) // 8]
        else:
            validity = _pack(self.valid_mask())
        if f == "n":
            return HostArray(f, self.dtype, n, n, 0, ())
        if f == "b":
            vals = self.buffers[1][: (n + 7) // 8] if (
                self.offset == 0 and self.buffers[1] is not None) else _pack(self.bool_values())
            return HostArray(f, self.dtype, n, nulls, 0, (validity, vals))
        if f in _FIXED or f[:3] in _TS_UNITS:
            npdt = _FIXED[f][0] if f in _FIXED else np.int64
            vals = self.typed(1, npdt, n, self.offset)
            return HostArray(f, self.dtype, n, nulls, 0, (validity, _bytes(vals)))
        if f.startswith("d:"):
            return HostArray(f, self.dtype, n, nulls, 0,
                             (validity, _bytes(np.ascontiguousarray(self.decimal_words()))))
        if f in _STRINGS:
            offs = self.offsets()
            data = self.buffers[2][int(offs[0]): int(offs[-1])] if n else np.zeros(0, np.uint8)
            return HostArray(f, self.dtype, n, nulls, 0,
                             (validity, _bytes(offs - offs[0]), data))
        if f in _LISTS:
            offs = self.offsets()
            child = _slice(self.children[0], int(offs[0]), int(offs[-1] - offs[0]))
            return HostArray(f, self.dtype, n, nulls, 0, (validity, _bytes(offs - offs[0])),
                             (child.normalized(),))
        if f == "+s":
            return HostArray(f, self.dtype, n, nulls, 0, (validity,),
                             tuple(_slice(c, self.offset, n).normalized() for c in self.children))
        raise NotImplementedError(f"Arrow format {f!r} is not in the port's types")


def _slice(a: HostArray, start: int, length: int) -> HostArray:
    nulls = a.null_count if a.null_count == 0 else -1
    return HostArray(a.fmt, a.dtype, length, nulls, a.offset + start, a.buffers, a.children,
                     a.dictionary)


def _bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _pack(mask: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(mask, bool), bitorder="little")


@dataclass
class HostBatch:
    """A record batch on the host: one ``HostArray`` per schema field."""

    schema: T.Schema
    length: int
    columns: tuple

    @staticmethod
    def from_numpy(columns: Sequence, schema: T.Schema,
                   validity: Sequence[np.ndarray | None] | None = None) -> "HostBatch":
        """Arrow arrays of host columns (one per field, as ``Batch.from_numpy``
        takes them: a decimal64 column as int64 unscaled values or Decimals, a
        string column as str objects, a LIST column as lists). A fixed-width
        numpy column of the field's physical dtype becomes a view, not a
        copy; the validity is packed."""
        n = len(columns[0]) if len(columns) else 0
        cols = []
        for i, f in enumerate(schema):
            valid = None if validity is None or validity[i] is None else \
                np.asarray(validity[i], bool)
            cols.append(array_from_numpy(columns[i], f.dtype, valid))
        return HostBatch(schema, n, tuple(cols))

    def to_pydict(self) -> dict:
        return {f.name: c.to_pylist() for f, c in zip(self.schema, self.columns)}

    def slice(self, start: int, length: int) -> "HostBatch":
        """Rows ``start .. start + length`` as views (each array's offset
        moves, as Arrow slices)."""
        length = max(0, min(length, self.length - start))
        return HostBatch(self.schema, length, tuple(_slice(c, start, length)
                                                    for c in self.columns))


def array_from_numpy(col, dtype: T.DataType, valid: np.ndarray | None = None) -> HostArray:
    """One host column as an Arrow array (see ``HostBatch.from_numpy``)."""
    n = len(col)
    if valid is not None and valid.all():
        valid = None
    nulls = 0 if valid is None else n - int(np.count_nonzero(valid))
    validity = None if valid is None else _pack(valid)
    k = dtype.kind
    fmt = format_of(dtype)
    if k == T.TypeKind.NULL:
        return HostArray(fmt, dtype, n, n, 0, ())
    if k == T.TypeKind.BOOL:
        return HostArray(fmt, dtype, n, nulls, 0, (validity, _pack(np.asarray(col, bool))))
    if k == T.TypeKind.DECIMAL and not dtype.is_wide_decimal and np.asarray(col).dtype != object:
        lo = np.ascontiguousarray(col, np.int64)
        words = np.stack([lo, lo >> 63], axis=1)
        return HostArray(fmt, dtype, n, nulls, 0, (validity, _bytes(words)))
    if dtype.is_dict_encoded or k == T.TypeKind.DECIMAL:
        ok = np.ones(n, bool) if valid is None else valid
        return array_from_pylist([x if m else None for x, m in zip(list(col), ok.tolist())],
                                 dtype)
    return HostArray(fmt, dtype, n, nulls, 0,
                     (validity, _bytes(np.asarray(col, dtype.numpy_dtype()))))


def array_from_pylist(values: Sequence, dtype: T.DataType) -> HostArray:
    """An Arrow array of Python values (None = NULL), in the canonical format
    of ``dtype`` (``format_of``)."""
    n = len(values)
    if dtype.is_integer or dtype.is_float:  # no NULL: one conversion
        try:
            plane = np.fromiter(values, dtype.numpy_dtype(), n)
        except TypeError:  # a None among the values
            pass
        else:
            return HostArray(format_of(dtype), dtype, n, 0, 0, (None, _bytes(plane)))
    valid = np.fromiter((v is not None for v in values), bool, n)
    nulls = n - int(np.count_nonzero(valid))
    validity = _pack(valid) if nulls else None
    fmt = format_of(dtype)
    k = dtype.kind
    if k == T.TypeKind.NULL:
        return HostArray(fmt, dtype, n, n, 0, ())
    if k in (T.TypeKind.STRING, T.TypeKind.BINARY):
        raw = [(v.encode("utf-8") if isinstance(v, str) else bytes(v)) if v is not None else b""
               for v in values]
        offs = np.zeros(n + 1, np.int32)
        np.cumsum([len(r) for r in raw], out=offs[1:])
        data = np.frombuffer(b"".join(raw), np.uint8)
        return HostArray(fmt, dtype, n, nulls, 0, (validity, _bytes(offs), data))
    if k == T.TypeKind.DECIMAL:
        u = [T.unscaled_int(T.decimal_at_scale(v, dtype.scale), dtype.scale) if v is not None
             else 0 for v in values]
        words = np.array([(x & _MASK64, (x >> 64) & _MASK64) for x in u],
                         dtype=np.uint64).reshape(n, 2)
        return HostArray(fmt, dtype, n, nulls, 0, (validity, _bytes(words)))
    if k in (T.TypeKind.LIST, T.TypeKind.MAP):
        present = [v for v in values if v is not None] if nulls else values
        lens = np.fromiter(map(len, present), np.int64, len(present))
        offs = np.zeros(n + 1, np.int32)
        if nulls:
            full = np.zeros(n, np.int64)
            full[valid] = lens
            lens = full
        np.cumsum(lens, out=offs[1:])
        items = list(itertools.chain.from_iterable(present))
        if k == T.TypeKind.LIST:
            child = array_from_pylist(items, dtype.inner[0])
        else:  # the entries struct: keys never NULL
            keys = [e[0] for e in items]
            if any(x is None for x in keys):
                raise ValueError("Invalid Map: key field cannot contain null values")
            child = HostArray("+s", entries_dtype(dtype), len(items), 0, 0, (None,),
                              (array_from_pylist(keys, dtype.inner[0]),
                               array_from_pylist([e[1] for e in items], dtype.inner[1])))
        return HostArray(fmt, dtype, n, nulls, 0, (validity, _bytes(offs)), (child,))
    if k == T.TypeKind.STRUCT:
        kids = tuple(array_from_pylist([v.get(name) if v is not None else None for v in values], t)
                     for name, t in zip(dtype.struct_names, dtype.inner))
        return HostArray(fmt, dtype, n, nulls, 0, (validity,), kids)
    if k == T.TypeKind.BOOL:
        return HostArray(fmt, dtype, n, nulls, 0,
                         (validity, _pack([bool(v) if v is not None else False for v in values])))
    if k == T.TypeKind.DATE32:
        epoch = _dt.date(1970, 1, 1)
        values = [(v - epoch).days if isinstance(v, _dt.date) else v for v in values]
    elif k == T.TypeKind.TIMESTAMP:
        values = [_micros(v) if isinstance(v, _dt.datetime) else v for v in values]
    plane = np.array(values if not nulls else [v if v is not None else 0 for v in values],
                     dtype=dtype.numpy_dtype())
    return HostArray(fmt, dtype, n, nulls, 0, (validity, _bytes(plane)))


def _micros(x: _dt.datetime) -> int:
    d = x.replace(tzinfo=None) - _dt.datetime(1970, 1, 1)
    return (d.days * 86_400 + d.seconds) * 1_000_000 + d.microseconds


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------


@dataclass
class _Field:
    name: str
    fmt: str
    flags: int
    children: tuple
    dictionary: "_Field | None"

    @property
    def dtype(self) -> T.DataType:
        if self.dictionary is not None:
            return self.dictionary.dtype
        return dtype_of(self.fmt, [c.dtype for c in self.children],
                        [c.name for c in self.children])


def _cstr(addr) -> str:
    return ctypes.string_at(addr).decode("utf-8") if addr else ""


def _parse_schema(s: ArrowSchema) -> _Field:
    fmt = _cstr(s.format)
    kids = ctypes.cast(s.children, ctypes.POINTER(ctypes.POINTER(ArrowSchema)))
    children = tuple(_parse_schema(kids[i].contents) for i in range(s.n_children))
    dictionary = (_parse_schema(ArrowSchema.from_address(s.dictionary))
                  if s.dictionary else None)
    field = _Field(_cstr(s.name), fmt, int(s.flags), children, dictionary)
    if fmt != "+s":
        field.dtype  # noqa: B018 — refuses a format outside the port's types now
    return field


def _release_schema(s: ArrowSchema) -> None:
    if s.release:
        _SCHEMA_RELEASE(s.release)(ctypes.byref(s))


def _take_schema(schema_addr: int) -> _Field:
    s = ArrowSchema.from_address(int(schema_addr))
    try:
        top = _parse_schema(s)
    finally:
        _release_schema(s)
    if top.fmt != "+s":
        raise ValueError(f"a record batch's schema has format '+s', not {top.fmt!r}")
    return top


def _schema_of(top: _Field) -> T.Schema:
    return T.Schema(tuple(T.Field(c.name, c.dtype, bool(c.flags & ARROW_FLAG_NULLABLE))
                          for c in top.children))


class _Owner:
    """Owns one imported ``ArrowArray`` (moved into memory of ours) and calls
    its release once: at ``close`` or when the last view of its buffers is
    garbage."""

    def __init__(self, struct: ArrowArray):
        self.struct = struct
        self._released = False
        # bound here: __del__ may run at interpreter shutdown, after the
        # module's globals are gone
        self._lock, self._stats, self._call = _lock, _STATS, _ARRAY_RELEASE
        self._pointer = ctypes.pointer
        with _lock:
            _STATS["arrays_imported"] += 1

    def close(self) -> None:
        with self._lock:
            if self._released:
                return
            self._released = True
            self._stats["arrays_released"] += 1
        if self.struct.release:
            self._call(self.struct.release)(self._pointer(self.struct))

    def __del__(self):
        self.close()


class _Memory:
    """A read-only numpy view of ``nbytes`` at ``addr`` that keeps its owner
    alive (numpy holds this object as the view's base)."""

    def __init__(self, owner: _Owner, addr: int, nbytes: int):
        self.owner = owner
        self.__array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                    "data": (addr, True), "version": 3}


def _view(owner: _Owner, addr, nbytes: int):
    if not addr:
        return None
    if nbytes == 0:
        return np.zeros(0, np.uint8)
    return np.asarray(_Memory(owner, addr, nbytes))


def _move(addr: int, cls):
    """Move the struct at ``addr`` into memory of ours: copy it and mark the
    source released (the specification's move)."""
    src = cls.from_address(int(addr))
    if not src.release:
        raise ValueError(f"the {cls.__name__} at {addr:#x} is already released")
    own = cls()
    ctypes.memmove(ctypes.addressof(own), ctypes.addressof(src), ctypes.sizeof(cls))
    src.release = None
    return own


def _host_array(a: ArrowArray, field: _Field, owner: _Owner, extra_offset: int = 0) -> HostArray:
    """A HostArray over an imported array's buffers (views held by ``owner``);
    ``extra_offset``: the parent struct's offset, which applies to its
    children."""
    fmt = field.fmt
    n, off = int(a.length), int(a.offset) + extra_offset
    end = off + n
    bufs = ctypes.cast(a.buffers, ctypes.POINTER(ctypes.c_void_p))
    ptr = [bufs[i] for i in range(a.n_buffers)] if a.buffers else []
    ptr += [None] * (3 - len(ptr))
    validity = _view(owner, ptr[0], (end + 7) // 8) if fmt != "n" else None
    nulls = int(a.null_count)
    dtype = field.dtype
    children = ()
    dictionary = None
    if field.dictionary is not None:
        if fmt not in _FIXED or fmt in ("f", "g", "tdD"):
            raise ValueError(f"dictionary indices of format {fmt!r}")
        itemsize = np.dtype(_FIXED[fmt][0]).itemsize
        buffers = (validity, _view(owner, ptr[1], end * itemsize))
        dictionary = _host_array(ArrowArray.from_address(a.dictionary), field.dictionary, owner)
    elif fmt == "n":
        buffers = ()
        nulls = n
    elif fmt == "b":
        buffers = (validity, _view(owner, ptr[1], (end + 7) // 8))
    elif fmt in _FIXED:
        buffers = (validity, _view(owner, ptr[1], end * np.dtype(_FIXED[fmt][0]).itemsize))
    elif fmt[:3] in _TS_UNITS:
        buffers = (validity, _view(owner, ptr[1], end * 8))
    elif fmt.startswith("d:"):
        buffers = (validity, _view(owner, ptr[1], end * 16))
    elif fmt in _STRINGS:
        odt = np.dtype(_STRINGS[fmt][0])
        offsets = _view(owner, ptr[1], (end + 1) * odt.itemsize)
        data_len = int(offsets.view(odt)[end]) if offsets is not None and offsets.size else 0
        data = _view(owner, ptr[2], data_len)
        buffers = (validity, offsets, data if data is not None else np.zeros(0, np.uint8))
    elif fmt in _LISTS:
        odt = np.dtype(_LISTS[fmt])
        buffers = (validity, _view(owner, ptr[1], (end + 1) * odt.itemsize))
        kids = ctypes.cast(a.children, ctypes.POINTER(ctypes.POINTER(ArrowArray)))
        children = (_host_array(kids[0].contents, field.children[0], owner),)
    elif fmt == "+s":  # its offset applies to the children, which keep theirs
        buffers = (validity,)
        kids = ctypes.cast(a.children, ctypes.POINTER(ctypes.POINTER(ArrowArray)))
        children = tuple(_host_array(kids[i].contents, c, owner)
                         for i, c in enumerate(field.children))
    else:
        dtype_of(fmt)  # raises naming the format
        raise NotImplementedError(f"Arrow format {fmt!r}")
    return HostArray(fmt, dtype, n, nulls, off, buffers, children, dictionary)


def _import_struct(own: ArrowArray, top: _Field, schema: T.Schema | None = None) -> HostBatch:
    owner = _Owner(own)
    try:
        if own.n_children != len(top.children):
            raise ValueError(f"array has {own.n_children} children, its schema "
                             f"{len(top.children)}")
        kids = ctypes.cast(own.children, ctypes.POINTER(ctypes.POINTER(ArrowArray)))
        cols = tuple(_host_array(kids[i].contents, f, owner, int(own.offset))
                     for i, f in enumerate(top.children))
    except BaseException:
        owner.close()
        raise
    return HostBatch(schema or _schema_of(top), int(own.length), cols)


def import_batch(array_addr: int, schema_addr: int) -> HostBatch:
    """A record batch from host-owned ``ArrowArray*`` / ``ArrowSchema*``
    structs (``pa.RecordBatch._export_to_c`` or a JVM's export). The schema
    is released at once; the array is moved into memory of ours and
    released when the batch's buffers are no longer referenced."""
    top = _take_schema(schema_addr)
    return _import_struct(_move(array_addr, ArrowArray), top)


#: (pyarrow schema, its parsed fields, the port's schema) of the last
#: ``import_from`` of an object with a ``schema``: a stream of batches of
#: one schema parses it once
_LAST_SCHEMA: tuple = (None, None, None)


def import_from(obj) -> HostBatch:
    """A record batch from any object with Arrow's ``_export_to_c(array,
    schema)`` method (a pyarrow RecordBatch), through the C structs. The
    schema is exported and parsed only when it differs from the last
    one's."""
    global _LAST_SCHEMA
    arr = ArrowArray()
    key = getattr(obj, "schema", None)
    last, top, schema = _LAST_SCHEMA
    if key is None or last is None or not key.equals(last):
        sch = ArrowSchema()
        obj._export_to_c(ctypes.addressof(arr), ctypes.addressof(sch))
        top = _take_schema(ctypes.addressof(sch))
        schema = _schema_of(top)
        if key is not None:
            _LAST_SCHEMA = (key, top, schema)
    else:
        obj._export_to_c(ctypes.addressof(arr))
    return _import_struct(_move(ctypes.addressof(arr), ArrowArray), top, schema)


class ArrowStreamReader:
    """An imported ``ArrowArrayStream``: iterates its record batches as
    ``HostBatch``es once. The stream is released when it ends, at
    ``close`` or when the reader is garbage; a second iteration yields
    nothing (a host engine's scan handoff is one-shot)."""

    def __init__(self, stream_addr: int):
        self._stream = _move(stream_addr, ArrowArrayStream)
        self._released = False
        self._call, self._pointer = _STREAM_RELEASE, ctypes.pointer  # for a __del__ at shutdown
        try:
            sch = ArrowSchema()
            self._check(_STREAM_GET_SCHEMA(self._stream.get_schema)(
                ctypes.byref(self._stream), ctypes.byref(sch)))
            self._top = _take_schema(ctypes.addressof(sch))
        except BaseException:
            self.close()
            raise
        self.schema = _schema_of(self._top)

    def _check(self, rc: int) -> None:
        if rc:
            err = _STREAM_GET_LAST_ERROR(self._stream.get_last_error)(ctypes.byref(self._stream)) \
                if self._stream.get_last_error else None
            raise RuntimeError(f"Arrow stream error {rc}: {_cstr(err) or 'no message'}")

    def __iter__(self) -> Iterator[HostBatch]:
        while not self._released:
            arr = ArrowArray()
            self._check(_STREAM_GET_NEXT(self._stream.get_next)(
                ctypes.byref(self._stream), ctypes.byref(arr)))
            if not arr.release:  # end of stream
                self.close()
                return
            yield _import_struct(arr, self._top)

    def close(self) -> None:
        if not self._released:
            self._released = True
            if self._stream.release:
                self._call(self._stream.release)(self._pointer(self._stream))

    def __del__(self):
        self.close()


def import_stream(stream_addr: int) -> ArrowStreamReader:
    return ArrowStreamReader(stream_addr)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

#: exported trees still held by a consumer: key -> [refcount, objects kept alive]
_EXPORTS: dict[int, list] = {}
_keys = itertools.count(1)


def _register(keep: list, n_structs: int) -> int:
    key = next(_keys)
    with _lock:
        _EXPORTS[key] = [n_structs, keep]
    return key


def _unref(key: int) -> None:
    dropped = None  # freed after the lock: its buffers may hold imported arrays
    with _lock:
        _STATS["struct_releases"] += 1
        entry = _EXPORTS.get(key)
        if entry is not None:
            entry[0] -= 1
            if entry[0] <= 0:
                dropped = _EXPORTS.pop(key)
    del dropped


def _release_children(children_addr, n: int, dictionary_addr, cls, release_type) -> None:
    """A parent's release: release each child (and the dictionary) the
    consumer did not move out (their release is still set)."""
    kids = ctypes.cast(children_addr, ctypes.POINTER(ctypes.POINTER(cls)))
    structs = [kids[i].contents for i in range(n)] if children_addr else []
    if dictionary_addr:
        structs.append(cls.from_address(dictionary_addr))
    for c in structs:
        if c.release:
            release_type(c.release)(ctypes.pointer(c))


def _released(s, cls, release_type) -> None:
    """A release callback's body: mark the struct released first (a consumer
    checks that), then release its children and drop the tree's reference.
    A consumer that frees its structs while the interpreter shuts down
    finds this module's globals gone; only the mark matters then."""
    children, n, dictionary, key = s.children, s.n_children, s.dictionary, s.private_data
    s.release = None
    try:
        _release_children(children, n, dictionary, cls, release_type)
        _unref(key)
    except (TypeError, AttributeError):  # interpreter teardown
        pass


# the callbacks bind what they call as defaults: at interpreter shutdown a
# module's globals may already be gone when a consumer releases a struct
@_SCHEMA_RELEASE
def _schema_release(p, _body=_released, _cls=ArrowSchema, _rt=_SCHEMA_RELEASE):
    _body(p.contents, _cls, _rt)


@_ARRAY_RELEASE
def _array_release(p, _body=_released, _cls=ArrowArray, _rt=_ARRAY_RELEASE):
    _body(p.contents, _cls, _rt)


_SCHEMA_RELEASE_PTR = ctypes.cast(_schema_release, ctypes.c_void_p).value
_ARRAY_RELEASE_PTR = ctypes.cast(_array_release, ctypes.c_void_p).value
_EMPTY = np.zeros(8, np.uint8)  # the address of an empty buffer (never NULL)


def _str(keep: list, s: str) -> int:
    b = ctypes.create_string_buffer(s.encode("utf-8"))
    keep.append(b)
    return ctypes.addressof(b)


def _ptrs(keep: list, cls, structs: list):
    arr = (ctypes.POINTER(cls) * max(len(structs), 1))(*[ctypes.pointer(s) for s in structs])
    keep.append(arr)
    return ctypes.addressof(arr) if structs else None


def _fill_schema(s: ArrowSchema, fmt: str, name: str, nullable: bool, children: list,
                 dictionary, keep: list, count: list) -> None:
    """``children``: (fmt, name, nullable, children, dictionary) tuples;
    ``dictionary``: one such tuple or None."""
    count[0] += 1
    kid_structs = []
    for c in children:
        k = ArrowSchema()
        _fill_schema(k, *c, keep, count)
        kid_structs.append(k)
    keep.extend(kid_structs)
    s.format = _str(keep, fmt)
    s.name = _str(keep, name)
    s.metadata = None
    s.flags = ARROW_FLAG_NULLABLE if nullable else 0
    s.n_children = len(children)
    s.children = _ptrs(keep, ArrowSchema, kid_structs)
    if dictionary is not None:
        d = ArrowSchema()
        _fill_schema(d, *dictionary, keep, count)
        keep.append(d)
        s.dictionary = ctypes.addressof(d)
    else:
        s.dictionary = None
    s.release = _SCHEMA_RELEASE_PTR


def child_fields(dtype: T.DataType, entries: bool = False) -> list[T.Field]:
    """The child fields Arrow gives a nested type: a list's ``item``, a
    map's non-nullable ``entries`` struct, a struct's fields (``entries``:
    the struct is a map's, whose ``key`` is non-nullable)."""
    k = dtype.kind
    if k == T.TypeKind.LIST:
        return [T.Field("item", dtype.inner[0], True)]
    if k == T.TypeKind.MAP:
        return [T.Field("entries", entries_dtype(dtype), False)]
    if k == T.TypeKind.STRUCT:
        return [T.Field(n, t, not (entries and n == "key"))
                for n, t in zip(dtype.struct_names, dtype.inner)]
    return []


def _field_spec(a_fmt: str, dtype: T.DataType, name: str, nullable: bool, dictionary=None,
                entries: bool = False):
    children = []
    if dictionary is None:
        children = [_field_spec(format_of(c.dtype), c.dtype, c.name, c.nullable,
                                entries=dtype.kind == T.TypeKind.MAP)
                    for c in child_fields(dtype, entries)]
    return (a_fmt, name, nullable, children, dictionary)


def _column_spec(f: T.Field, col: HostArray | None, entries: bool = False):
    if col is None:
        return _field_spec(format_of(f.dtype), f.dtype, f.name, f.nullable, entries=entries)
    if col.dictionary is not None:
        d = col.dictionary
        return (col.fmt, f.name, f.nullable, [], _field_spec(d.fmt, d.dtype, "", True))
    if col.children:  # the children's own formats
        kids = [_column_spec(cf, c, entries=f.dtype.kind == T.TypeKind.MAP)
                for cf, c in zip(child_fields(f.dtype, entries), col.children)]
        return (col.fmt, f.name, f.nullable, kids, None)
    return _field_spec(col.fmt, f.dtype, f.name, f.nullable)


def _fill_array(a: ArrowArray, col: HostArray, keep: list, count: list) -> None:
    count[0] += 1
    bufs = [b if b is not None else None for b in col.buffers]
    addrs = []
    for b in bufs:
        if b is None:
            addrs.append(None)
        else:
            b = np.ascontiguousarray(b)
            keep.append(b)
            addrs.append(b.ctypes.data if b.size else _EMPTY.ctypes.data)
    ptr_arr = (ctypes.c_void_p * max(len(addrs), 1))(*addrs)
    keep.append(ptr_arr)
    kid_structs = []
    for c in col.children:
        k = ArrowArray()
        _fill_array(k, c, keep, count)
        kid_structs.append(k)
    keep.extend(kid_structs)
    a.length = col.length
    a.null_count = col.null_count
    a.offset = col.offset
    a.n_buffers = len(addrs)
    a.n_children = len(kid_structs)
    a.buffers = ctypes.addressof(ptr_arr) if addrs else None
    a.children = _ptrs(keep, ArrowArray, kid_structs)
    if col.dictionary is not None:
        d = ArrowArray()
        _fill_array(d, col.dictionary, keep, count)
        keep.append(d)
        a.dictionary = ctypes.addressof(d)
    else:
        a.dictionary = None
    a.release = _ARRAY_RELEASE_PTR


def _set_key(addr: int, cls, key: int, seen: set | None = None) -> None:
    """Stamp every struct of an exported tree with its registry key."""
    s = cls.from_address(addr)
    s.private_data = key
    kids = ctypes.cast(s.children, ctypes.POINTER(ctypes.POINTER(cls)))
    for i in range(s.n_children if s.children else 0):
        _set_key(ctypes.addressof(kids[i].contents), cls, key)
    if s.dictionary:
        _set_key(s.dictionary, cls, key)


def export_schema(schema: T.Schema, out_addr: int, columns: Sequence | None = None) -> None:
    """Write a record batch's schema (format ``+s``) into the
    ``ArrowSchema*`` at ``out_addr``; ``columns`` (HostArrays) give the
    exact formats, else the canonical ones."""
    keep: list = []
    count = [0]
    cols = list(columns) if columns is not None else [None] * len(schema)
    out = ArrowSchema.from_address(int(out_addr))
    _fill_schema(out, "+s", "", False, [_column_spec(f, c) for f, c in zip(schema, cols)],
                 None, keep, count)
    _set_key(int(out_addr), ArrowSchema, _register(keep, count[0]))


def export_array(batch: HostBatch, out_addr: int) -> None:
    """Write a record batch (a struct array of its columns) into the
    ``ArrowArray*`` at ``out_addr``."""
    keep: list = []
    count = [0]
    top = HostArray("+s", T.NULL, batch.length, 0, 0, (None,), tuple(batch.columns))
    out = ArrowArray.from_address(int(out_addr))
    _fill_array(out, top, keep, count)
    _set_key(int(out_addr), ArrowArray, _register(keep, count[0]))


def export_batch(batch: HostBatch, array_addr: int, schema_addr: int) -> None:
    """``ArrowArray`` + ``ArrowSchema`` of a host batch (the C data
    interface's record batch): the buffers stay alive until the consumer
    releases the structs."""
    export_schema(batch.schema, schema_addr, batch.columns)
    export_array(batch, array_addr)


class _StreamState:
    def __init__(self, schema: T.Schema, batches: Sequence[HostBatch]):
        self.schema = schema
        self.batches = iter(batches)
        self.first = batches[0] if len(batches) else None
        self.error = None


_STREAMS: dict[int, _StreamState] = {}


def _stream_call(p, fn) -> int:
    st = _STREAMS.get(p.contents.private_data)
    try:
        fn(st)
        return 0
    except Exception as e:  # noqa: BLE001 — a C callback reports errors by code
        if st is not None:
            st.error = ctypes.create_string_buffer(f"{type(e).__name__}: {e}".encode())
        return _EIO


@_STREAM_GET_SCHEMA
def _stream_get_schema(p, out):
    return _stream_call(p, lambda st: export_schema(
        st.schema, ctypes.addressof(out.contents),
        st.first.columns if st.first is not None else None))


@_STREAM_GET_NEXT
def _stream_get_next(p, out):
    def nxt(st):
        b = next(st.batches, None)
        if b is None:
            out.contents.release = None  # end of stream
        else:
            export_array(b, ctypes.addressof(out.contents))
    return _stream_call(p, nxt)


@_STREAM_GET_LAST_ERROR
def _stream_get_last_error(p):
    st = _STREAMS.get(p.contents.private_data)
    return ctypes.addressof(st.error) if st is not None and st.error is not None else None


def _stream_released(s) -> None:
    key = s.private_data
    s.release = None
    try:
        with _lock:
            dropped = _STREAMS.pop(key, None)  # freed after the lock, as in _unref
            _STATS["struct_releases"] += 1
        del dropped
    except (TypeError, AttributeError):  # interpreter teardown
        pass


@_STREAM_RELEASE
def _stream_release(p, _body=_stream_released):
    _body(p.contents)


def export_stream(batches: Sequence[HostBatch], out_addr: int,
                  schema: T.Schema | None = None) -> None:
    """An ``ArrowArrayStream`` producer over host batches, written into the
    struct at ``out_addr`` (what a JVM hands ``auron_put_resource_arrow``).
    ``schema`` defaults to the first batch's."""
    if schema is None:
        if not len(batches):
            raise ValueError("an empty stream needs its schema")
        schema = batches[0].schema
    key = next(_keys)
    with _lock:
        _STREAMS[key] = _StreamState(schema, list(batches))
    s = ArrowArrayStream.from_address(int(out_addr))
    s.get_schema = ctypes.cast(_stream_get_schema, ctypes.c_void_p).value
    s.get_next = ctypes.cast(_stream_get_next, ctypes.c_void_p).value
    s.get_last_error = ctypes.cast(_stream_get_last_error, ctypes.c_void_p).value
    s.release = ctypes.cast(_stream_release, ctypes.c_void_p).value
    s.private_data = key


def stream_of(batches: Sequence[HostBatch], schema: T.Schema | None = None) -> ArrowStreamReader:
    """The batches through the C stream interface and back: exported into an
    ``ArrowArrayStream`` and imported, as a host engine's handoff arrives."""
    s = ArrowArrayStream()
    export_stream(batches, ctypes.addressof(s), schema)
    return import_stream(ctypes.addressof(s))
