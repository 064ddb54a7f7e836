"""Arrow IPC streams written and read without pyarrow.

The reference reads and writes IPC with ``pa.ipc`` (``bridge/api.py:25-34``,
``:186-194``); the machine with the card has no pyarrow. The port lays the
flatbuffers out itself (``_Flat`` writes, ``_FlatTable`` reads: the Arrow
``format/Schema.fbs`` and ``format/Message.fbs`` tables), over the host
arrays of ``columnar/arrow_c.py``:

- ``write_stream``: one schema message, then one record batch message per
  batch, then end-of-stream; every buffer 8-byte aligned in the body, a
  dictionary column written decoded. ``pa.ipc.open_stream`` reads it.
- ``read_stream`` / ``iter_stream``: a stream as pyarrow (or any Arrow
  writer) writes it: schema, dictionary batches (delta dictionaries
  append), record batches; the legacy framing without the continuation
  marker too. Buffers are numpy views of the payload; a compressed body
  (LZ4_FRAME or ZSTD, each buffer prefixed by its uncompressed length,
  -1 for a buffer stored raw) decompresses buffer by buffer through
  ``columnar/codecs.py``.
- ``write_stream(..., codec="lz4" | "zstd")`` compresses each body buffer
  the same way (the reference's v1 shuffle blocks and ENC_ARROW columns).
- ``schema_message``: the schema message alone (the shuffle block's
  schema section, ``exec/shuffle/format.py``).

The types are those of ``arrow_c``: null, bool, signed and unsigned ints,
floats, date32, timestamps (s, ms, us), decimal128, utf8/binary (and their
large forms), list (and large list), struct and map, nested in each other.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.arrow_c import (
    HostArray, HostBatch, child_fields, array_from_pylist, dtype_of, format_of,
)

# ---------------------------------------------------------------------------
# flatbuffers
# ---------------------------------------------------------------------------


class _Flat:
    """A forward flatbuffer writer: each table is laid out before the
    objects it points to, so every uoffset is positive; scalars sit at
    their natural alignment from the buffer start."""

    def __init__(self):
        self.buf = bytearray(4)  # root uoffset, patched by finish()

    def _pad(self, align: int) -> None:
        self.buf.extend(b"\0" * (-len(self.buf) % align))

    def table(self, fields: list) -> int:
        """``fields[i]`` is None (absent), (struct format, value) or
        ("off", writer) where writer(self) returns the child's position."""
        layout, pos = [], 4
        present = sorted((i for i, f in enumerate(fields) if f is not None),
                         key=lambda i: -self._size(fields[i][0]))
        for fid in present:
            sz = self._size(fields[fid][0])
            pos += -pos % sz
            layout.append((fid, pos, sz))
            pos += sz
        at = {fid: p for fid, p, _ in layout}
        self._pad(2)
        vt_pos = len(self.buf)
        self.buf += struct.pack(f"<HH{len(fields)}H", 4 + 2 * len(fields), pos,
                                *(at.get(i, 0) for i in range(len(fields))))
        self._pad(max([4] + [sz for _, _, sz in layout]))
        t_pos = len(self.buf)
        body = bytearray(pos)
        struct.pack_into("<i", body, 0, t_pos - vt_pos)
        children = []
        for fid, p, _ in layout:
            fmt, val = fields[fid]
            if fmt == "off":
                children.append((t_pos + p, val))
            else:
                struct.pack_into("<" + fmt, body, p, val)
        self.buf += body
        for ref, writer in children:
            struct.pack_into("<I", self.buf, ref, writer(self) - ref)
        return t_pos

    @staticmethod
    def _size(fmt: str) -> int:
        return 4 if fmt == "off" else struct.calcsize("<" + fmt)

    def string(self, s: str) -> int:
        self._pad(4)
        pos = len(self.buf)
        b = s.encode("utf-8")
        self.buf += struct.pack("<I", len(b)) + b + b"\0"
        return pos

    def tables(self, writers: list) -> int:
        self._pad(4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(writers)) + bytes(4 * len(writers))
        for i, writer in enumerate(writers):
            ref = pos + 4 + 4 * i
            struct.pack_into("<I", self.buf, ref, writer(self) - ref)
        return pos

    def finish(self, root) -> bytes:
        struct.pack_into("<I", self.buf, 0, root(self))
        return bytes(self.buf)

    def structs(self, fmt: str, items: list) -> int:
        """A vector of 8-byte-aligned structs (``fmt`` per item)."""
        self.buf.extend(b"\0" * (-(len(self.buf) + 4) % 8))
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(items))
        for item in items:
            self.buf += struct.pack("<" + fmt, *item)
        return pos


class _FlatTable:
    """Read access to one flatbuffer table of ``buf`` at ``pos``."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        vt = pos - struct.unpack_from("<i", buf, pos)[0]
        vt_len = struct.unpack_from("<H", buf, vt)[0]
        self.slots = struct.unpack_from(f"<{(vt_len - 4) // 2}H", buf, vt + 4)

    def _at(self, field: int) -> int:
        return self.slots[field] if field < len(self.slots) else 0

    def scalar(self, field: int, fmt: str, default=0):
        off = self._at(field)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0] if off else default

    def ref(self, field: int) -> int | None:
        """Position of the object a uoffset field points to (None: absent)."""
        off = self._at(field)
        if not off:
            return None
        p = self.pos + off
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, field: int) -> "_FlatTable | None":
        p = self.ref(field)
        return None if p is None else _FlatTable(self.buf, p)

    def tables(self, field: int) -> list["_FlatTable"]:
        p = self.ref(field)
        if p is None:
            return []
        (n,) = struct.unpack_from("<I", self.buf, p)
        out = []
        for i in range(n):
            at = p + 4 + 4 * i
            out.append(_FlatTable(self.buf, at + struct.unpack_from("<I", self.buf, at)[0]))
        return out

    def string(self, field: int) -> str:
        p = self.ref(field)
        if p is None:
            return ""
        (n,) = struct.unpack_from("<I", self.buf, p)
        return bytes(self.buf[p + 4: p + 4 + n]).decode("utf-8")

    def structs(self, field: int, fmt: str) -> list[tuple]:
        p = self.ref(field)
        if p is None:
            return []
        (n,) = struct.unpack_from("<I", self.buf, p)
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, p + 4 + i * size) for i in range(n)]


# Arrow flatbuffer enums (format/Schema.fbs, format/Message.fbs)
_TYPE_NULL, _TYPE_INT, _TYPE_FLOAT, _TYPE_BINARY, _TYPE_UTF8 = 1, 2, 3, 4, 5
_TYPE_BOOL, _TYPE_DECIMAL, _TYPE_DATE, _TYPE_TIMESTAMP = 6, 7, 8, 10
_TYPE_LIST, _TYPE_STRUCT, _TYPE_MAP = 12, 13, 17
_TYPE_LARGE_BINARY, _TYPE_LARGE_UTF8, _TYPE_LARGE_LIST = 19, 20, 21
HEADER_SCHEMA, HEADER_DICTIONARY, HEADER_RECORD_BATCH = 1, 2, 3
_METADATA_V5 = 4
_CONTINUATION = 0xFFFFFFFF
EOS = struct.pack("<Ii", _CONTINUATION, 0)
_CODECS = {0: "lz4", 1: "zstd"}  # CompressionType: LZ4_FRAME, ZSTD
_CODEC_TYPE = {v: k for k, v in _CODECS.items()}
_TS_UNIT_FMT = {0: "tss", 1: "tsm", 2: "tsu", 3: "tsn"}
_INT_FMT = {(8, True): "c", (16, True): "s", (32, True): "i", (64, True): "l",
            (8, False): "C", (16, False): "S", (32, False): "I", (64, False): "L"}
_PLAIN = {"n": (_TYPE_NULL, []), "b": (_TYPE_BOOL, []), "f": (_TYPE_FLOAT, [("h", 1)]),
          "g": (_TYPE_FLOAT, [("h", 2)]), "tdD": (_TYPE_DATE, [("h", 0)]),
          "u": (_TYPE_UTF8, []), "U": (_TYPE_LARGE_UTF8, []), "z": (_TYPE_BINARY, []),
          "Z": (_TYPE_LARGE_BINARY, []), "+l": (_TYPE_LIST, []), "+L": (_TYPE_LARGE_LIST, []),
          "+s": (_TYPE_STRUCT, []), "+m": (_TYPE_MAP, [("B", 0)])}  # Map: keysSorted false


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _type_of(fmt: str):
    """(Type union id, fields of its table) of an Arrow format string."""
    if fmt in _PLAIN:
        return _PLAIN[fmt]
    for (bits, signed), f in _INT_FMT.items():
        if f == fmt:
            return _TYPE_INT, [("i", bits), ("B", 1 if signed else 0)]
    if fmt[:3] in ("tss", "tsm", "tsu", "tsn") and fmt[3:4] == ":":
        unit = {"tss": 0, "tsm": 1, "tsu": 2, "tsn": 3}[fmt[:3]]
        tz = fmt[4:]
        return _TYPE_TIMESTAMP, [("h", unit), ("off", lambda fb: fb.string(tz)) if tz else None]
    if fmt.startswith("d:"):
        dt = dtype_of(fmt)
        return _TYPE_DECIMAL, [("i", dt.precision), ("i", dt.scale), ("i", 128)]
    dtype_of(fmt)  # raises naming the format
    raise NotImplementedError(f"Arrow IPC type of format {fmt!r}")


def _message(header_type: int, header, body_len: int) -> bytes:
    """One encapsulated IPC message: continuation, metadata length, the
    Message{version V5, header, bodyLength} flatbuffer padded to 8 bytes."""

    def msg(fb: _Flat) -> int:
        return fb.table([
            ("h", _METADATA_V5),                               # version
            ("B", header_type),                                # header_type
            ("off", header),                                   # header
            ("q", body_len),                                   # bodyLength
        ])

    meta = _Flat().finish(msg)
    meta += bytes(-len(meta) % 8)
    return struct.pack("<Ii", _CONTINUATION, len(meta)) + meta


@dataclass
class _FieldSpec:
    """What the schema message says of one field."""

    name: str
    nullable: bool
    fmt: str
    children: tuple = ()
    dict_id: int | None = None  # dictionary-encoded (int32 indices)


def _spec_of(f: T.Field, col: HostArray | None, dict_id: int | None = None,
             entries: bool = False) -> _FieldSpec:
    """A field's spec; a dictionary-encoded one describes its value type
    (with that type's children), as IPC writes dictionary fields."""
    plain = col is not None and col.dictionary is None
    fmt = col.fmt if plain else format_of(f.dtype)
    kids = col.children if plain else [None] * len(child_fields(f.dtype))
    children = tuple(_spec_of(cf, c, entries=f.dtype.kind == T.TypeKind.MAP)
                     for cf, c in zip(child_fields(f.dtype, entries), kids))
    return _FieldSpec(f.name, f.nullable, fmt, children, dict_id)


def _field_writer(spec: _FieldSpec):
    type_id, type_fields = _type_of(spec.fmt)

    def encoding(fb: _Flat) -> int:
        return fb.table([
            ("q", spec.dict_id),                               # id
            ("off", lambda fb: fb.table([("i", 32), ("B", 1)])),  # indexType Int32
            ("B", 0),                                          # isOrdered
            ("h", 0),                                          # DictionaryKind.DenseArray
        ])

    return lambda fb: fb.table([
        ("off", lambda fb: fb.string(spec.name)),              # name
        ("B", 1 if spec.nullable else 0),                      # nullable
        ("B", type_id),                                        # type_type
        ("off", lambda fb: fb.table(type_fields)),             # type
        ("off", encoding) if spec.dict_id is not None else None,  # dictionary
        ("off", lambda fb: fb.tables([_field_writer(c) for c in spec.children])),  # children
    ])


def _schema_bytes(specs: Sequence[_FieldSpec]) -> bytes:
    def schema_table(fb: _Flat) -> int:
        return fb.table([
            ("h", 0),                                          # endianness Little
            ("off", lambda fb: fb.tables([_field_writer(s) for s in specs])),
        ])

    return _message(HEADER_SCHEMA, schema_table, 0)


def schema_message(schema: T.Schema, dict_ids: dict | None = None) -> bytes:
    """The schema message of ``schema`` in the port's canonical formats;
    ``dict_ids`` maps a field index to its dictionary id (int32 indices),
    as pyarrow writes a dictionary-typed field."""
    dict_ids = dict_ids or {}
    return _schema_bytes([_spec_of(f, None, dict_ids.get(i)) for i, f in enumerate(schema)])


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------


def _flatten(arr: HostArray, nodes: list, bufs: list) -> None:
    """The array's field nodes and buffers in IPC order (depth first)."""
    nodes.append((arr.length, arr.null_count))
    if arr.fmt != "n":
        bufs.extend(arr.buffers if arr.null_count else (None,) + tuple(arr.buffers[1:]))
    for c in arr.children:
        _flatten(c, nodes, bufs)


def _record_batch(length: int, columns: Sequence[HostArray], codec: str | None = None) -> bytes:
    from auron_tpu_torch.columnar import codecs

    nodes: list = []
    bufs: list = []
    for c in columns:
        _flatten(c, nodes, bufs)
    body, spans, pos = [], [], 0
    for b in bufs:
        raw = b"" if b is None else np.ascontiguousarray(b).tobytes()
        if codec is not None and raw:  # uncompressed length, then the codec's frame
            raw = struct.pack("<q", len(raw)) + codecs.compress(codec, raw)
        spans.append((pos, len(raw)))
        raw = _pad8(raw)
        body.append(raw)
        pos += len(raw)

    def compression(fb: _Flat) -> int:
        return fb.table([("b", _CODEC_TYPE[codec])])           # codec; method BUFFER

    def rb(fb: _Flat) -> int:
        return fb.table([
            ("q", length),                                     # length
            ("off", lambda fb: fb.structs("qq", nodes)),       # nodes: (length, null_count)
            ("off", lambda fb: fb.structs("qq", spans)),       # buffers: (offset, length)
            ("off", compression) if codec is not None else None,  # compression
        ])

    return _message(HEADER_RECORD_BATCH, rb, pos) + b"".join(body)


def write_stream(batches: Sequence[HostBatch], schema: T.Schema | None = None,
                 codec: str | None = None) -> bytes:
    """An IPC stream: the schema (``schema`` or the first batch's), one record
    batch message per batch (each body buffer compressed with ``codec``,
    "lz4" or "zstd", when one is given), end-of-stream."""
    if codec is not None and codec not in _CODEC_TYPE:
        raise ValueError(f"Arrow IPC body codec must be lz4 or zstd, got {codec!r}")
    if schema is None:
        if not len(batches):
            raise ValueError("an empty stream needs its schema")
        schema = batches[0].schema
    norm = [[c.normalized() for c in b.columns] for b in batches]
    first = norm[0] if norm else [None] * len(schema)
    out = [_schema_bytes([_spec_of(f, c) for f, c in zip(schema, first)])]
    for b, cols in zip(batches, norm):
        if len(cols) != len(schema):
            raise ValueError(f"batch has {len(cols)} columns, the stream's schema {len(schema)}")
        out.append(_record_batch(b.length, cols, codec))
    out.append(EOS)
    return b"".join(out)


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------


@dataclass
class _Field:
    name: str
    nullable: bool
    fmt: str
    children: tuple
    dict_id: int | None
    index_fmt: str

    @property
    def dtype(self) -> T.DataType:
        return dtype_of(self.fmt, [c.dtype for c in self.children],
                        [c.name for c in self.children])


def _fmt_of(type_id: int, t: _FlatTable | None, children: tuple) -> str:
    if type_id == _TYPE_INT:
        return _INT_FMT[(t.scalar(0, "i"), bool(t.scalar(1, "B")))]
    if type_id == _TYPE_FLOAT:
        prec = t.scalar(0, "h")
        if prec == 0:
            raise NotImplementedError("Arrow half floats are not in the port's types")
        return "f" if prec == 1 else "g"
    if type_id == _TYPE_DATE:
        if t is not None and t.scalar(0, "h", 1) == 0:
            return "tdD"
        raise NotImplementedError("Arrow date64 is not in the port's types")
    if type_id == _TYPE_TIMESTAMP:
        unit = t.scalar(0, "h")
        if unit not in _TS_UNIT_FMT:
            raise NotImplementedError(f"Arrow timestamp unit {unit} is not in the port's types")
        return f"{_TS_UNIT_FMT[unit]}:{t.string(1)}"
    if type_id == _TYPE_DECIMAL:
        bits = t.scalar(2, "i", 128)
        if bits != 128:
            raise NotImplementedError(f"Arrow decimal{bits} is not in the port")
        return f"d:{t.scalar(0, 'i')},{t.scalar(1, 'i')}"
    for fmt, (tid, _) in _PLAIN.items():
        if tid == type_id and fmt not in ("f", "g", "tdD"):
            return fmt
    raise NotImplementedError(f"Arrow IPC type {type_id} is not in the port's types")


def _parse_field(f: _FlatTable) -> _Field:
    children = tuple(_parse_field(c) for c in f.tables(5))
    fmt = _fmt_of(f.scalar(2, "B"), f.table(3), children)
    enc = f.table(4)
    dict_id, index_fmt = None, ""
    if enc is not None:
        dict_id = enc.scalar(0, "q")
        it = enc.table(1)
        index_fmt = _INT_FMT[(it.scalar(0, "i"), bool(it.scalar(1, "B")))] if it else "i"
    field = _Field(f.string(0), bool(f.scalar(1, "B")), fmt, children, dict_id, index_fmt)
    field.dtype  # noqa: B018 — refuses a type outside the port's now
    return field


def _buffer(body, span) -> np.ndarray | None:
    off, length = span
    if length == 0:
        return None
    if off + length > len(body):
        raise ValueError("Arrow IPC buffer overruns the message body")
    return np.frombuffer(body, np.uint8, count=length, offset=off)


def _decompressed(body, span, codec: str) -> np.ndarray | None:
    """One buffer of a compressed body: its int64 uncompressed length, then
    the codec's frame (or, for -1, the bytes stored raw)."""
    from auron_tpu_torch.columnar import codecs

    raw = _buffer(body, span)
    if raw is None:
        return None
    (size,) = struct.unpack_from("<q", raw, 0)
    if size == -1:
        return raw[8:]
    if size == 0:
        return None
    return np.frombuffer(codecs.decompress(codec, raw[8:], size), np.uint8)


def _read_array(field: _Field, nodes: Iterator, bufs: Iterator, body, dictionaries: dict,
                as_values: bool = False) -> HostArray:
    """The next array of a record batch body; a dictionary-encoded field's
    indices unless ``as_values`` (a dictionary batch's values)."""
    length, nulls = next(nodes)
    fmt = field.fmt
    if fmt == "n":
        return HostArray(fmt, T.NULL, length, length, 0, ())
    validity = next(bufs)
    if field.dict_id is not None and not as_values:
        values = next(bufs)
        if field.dict_id not in dictionaries:
            raise ValueError(f"Arrow IPC record batch before dictionary {field.dict_id}")
        return HostArray(field.index_fmt, field.dtype, length, nulls, 0, (validity, values),
                         (), dictionaries[field.dict_id])
    if fmt in ("u", "U", "z", "Z"):
        offsets, data = next(bufs), next(bufs)
        return HostArray(fmt, field.dtype, length, nulls, 0,
                         (validity, offsets, data if data is not None else np.zeros(0, np.uint8)))
    if fmt == "+s":  # the validity buffer alone, then the children
        children = tuple(_read_array(c, nodes, bufs, body, dictionaries) for c in field.children)
        return HostArray(fmt, field.dtype, length, nulls, 0, (validity,), children)
    values = next(bufs)
    children = tuple(_read_array(c, nodes, bufs, body, dictionaries) for c in field.children)
    return HostArray(fmt, field.dtype, length, nulls, 0, (validity, values), children)


def _batch_arrays(rb: _FlatTable, body, fields: Sequence[_Field], dictionaries: dict,
                  as_values: bool = False) -> tuple[int, list[HostArray]]:
    comp = rb.table(3)
    spans = rb.structs(2, "qq")
    if comp is None:
        bufs = iter([_buffer(body, sp) for sp in spans])
    else:
        cid = comp.scalar(0, "b")
        if cid not in _CODECS:
            raise NotImplementedError(f"Arrow IPC body compression type {cid}")
        bufs = iter([_decompressed(body, sp, _CODECS[cid]) for sp in spans])
    nodes = iter(rb.structs(1, "qq"))
    cols = [_read_array(f, nodes, bufs, body, dictionaries, as_values) for f in fields]
    return rb.scalar(0, "q"), cols


def _messages(payload) -> Iterator[tuple[_FlatTable, memoryview]]:
    """(Message table, body) of each encapsulated message until end-of-stream."""
    buf = memoryview(payload)
    pos, n = 0, len(buf)
    while pos + 4 <= n:
        (marker,) = struct.unpack_from("<I", buf, pos)
        if marker == _CONTINUATION:
            if pos + 8 > n:
                break
            (mlen,) = struct.unpack_from("<i", buf, pos + 4)
            pos += 8
        else:  # legacy framing: the length alone
            mlen = struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        if mlen == 0:
            return
        meta = bytes(buf[pos: pos + mlen])
        pos += mlen
        msg = _FlatTable(meta, struct.unpack_from("<I", meta, 0)[0])
        body_len = msg.scalar(3, "q")
        if pos + body_len > n:
            raise ValueError("Arrow IPC message body overruns the stream")
        yield msg, buf[pos: pos + body_len]
        pos += body_len


def iter_stream(payload) -> Iterator[HostBatch]:
    """The record batches of an IPC stream, as ``HostBatch``es whose buffers
    are views of ``payload``."""
    fields = None
    schema = None
    dictionaries: dict[int, HostArray] = {}
    for msg, body in _messages(payload):
        header_type = msg.scalar(1, "B")
        header = msg.table(2)
        if header_type == HEADER_SCHEMA:
            fields = [_parse_field(f) for f in header.tables(1)]
            schema = T.Schema(tuple(T.Field(f.name, f.dtype, f.nullable) for f in fields))
            continue
        if fields is None:
            raise ValueError("Arrow IPC stream does not start with a schema")
        if header_type == HEADER_DICTIONARY:
            did = header.scalar(0, "q")
            field = _dict_field(fields, did)
            _, (arr,) = _batch_arrays(header.table(1), body, [field], dictionaries, True)
            if header.scalar(2, "B") and did in dictionaries:  # isDelta: append
                arr = array_from_pylist(dictionaries[did].to_pylist() + arr.to_pylist(),
                                        arr.dtype)
            dictionaries[did] = arr
        elif header_type == HEADER_RECORD_BATCH:
            length, cols = _batch_arrays(header, body, fields, dictionaries)
            yield HostBatch(schema, length, tuple(cols))
        else:
            raise NotImplementedError(f"Arrow IPC message type {header_type} in a stream")


def _dict_field(fields: Sequence[_Field], did: int) -> _Field:
    for f in fields:
        if f.dict_id == did:
            return f
        if f.children:
            try:
                return _dict_field(f.children, did)
            except KeyError:
                pass
    raise KeyError(f"Arrow IPC dictionary {did} belongs to no field")


def read_stream(payload) -> list[HostBatch]:
    return list(iter_stream(payload))
