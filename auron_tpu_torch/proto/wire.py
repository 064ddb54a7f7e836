"""A proto3 codec without google.protobuf: the port's plan IR messages.

``load(path)`` reads a ``.proto`` file (proto3: messages, nested messages
and enums, ``oneof``, ``repeated``, ``map<K, V>``, scalar and enum fields)
and returns a namespace with one message class per message, as
``protoc``'s ``_pb2`` modules name them: ``ns.TaskDefinition``,
``ns.CaseExpr.Branch``, top-level enum values as ``ns.AGG_SUM`` and
nested ones on their message class (``ns.Partitioning.HASH``), each enum
as a wrapper with ``Name``/``Value``. Nothing is written out by hand: the
schema is the file.

The message classes carry the part of the ``google.protobuf`` message API
the port uses:

- keyword construction (sub-messages and repeated sub-messages copied);
- attribute get and set with proto3 defaults and range checks; a
  sub-message read where it is absent is an empty message that becomes
  present when it (or anything below it) is written; assigning a message,
  repeated or map field raises ``AttributeError``;
- ``HasField``, ``WhichOneof``, ``ClearField``, ``CopyFrom``,
  ``MergeFrom``, ``SetInParent``, ``ListFields``, ``ByteSize``, ``==``;
- repeated containers (``add``, ``append``, ``extend``, indexing,
  ``len``) and map containers that behave as dicts;
- ``SerializeToString``, ``ParseFromString`` and the classmethod
  ``FromString``.

Encoding follows the proto3 wire rules, and its bytes are those of
``google.protobuf``'s ``SerializeToString(deterministic=True)``: fields in
field-number order; a scalar at its default left out unless it is the set
member of a ``oneof``; repeated scalars packed; ``sint`` as zigzag;
negative ``int32``/``int64``/enum values as 10-byte varints; each map
entry as its key and value, the entries in the order that
``google.protobuf``'s upb backend gives deterministic output (integer keys
descending; string keys by their UTF-8 bytes, a key before its own
prefixes: "aa", "ab", "a", "b", "").

Decoding accepts packed and unpacked repeated scalars, skips unknown
fields (and known fields sent with another wire type), keeps the last of a
singular scalar sent twice and merges a sub-message sent twice. Malformed
input (a truncated varint or field, a length past the end, a field number
0, an invalid wire type, bad UTF-8 in a string) raises ``DecodeError``, a
``ValueError``; ``ParseFromString`` leaves its message unchanged then.
"""

from __future__ import annotations

import functools
import re
import struct
import types

_MASK64 = (1 << 64) - 1


class DecodeError(ValueError):
    """Malformed wire bytes."""


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------


class FieldDescriptor:
    """A field, with ``google.protobuf``'s numbers for its type (those the
    codec carries) and label."""

    TYPE_DOUBLE, TYPE_INT64, TYPE_UINT64, TYPE_INT32, TYPE_BOOL, TYPE_STRING = 1, 3, 4, 5, 8, 9
    TYPE_MESSAGE, TYPE_BYTES, TYPE_UINT32, TYPE_ENUM, TYPE_SINT64 = 11, 12, 13, 14, 18
    LABEL_OPTIONAL, LABEL_REQUIRED, LABEL_REPEATED = 1, 2, 3

    def __init__(self, name: str, number: int, type_: int, label: int, type_name: str = ""):
        self.name, self.number, self.type, self.label = name, number, type_, label
        self.type_name = type_name  # message or enum name, resolved by ``_resolve``
        self.message_type: Descriptor | None = None
        self.enum_type: EnumDescriptor | None = None
        self.containing_oneof: OneofDescriptor | None = None
        self.full_name = ""

    @property
    def is_map(self) -> bool:
        return self.message_type is not None and self.message_type.is_map_entry

    def __repr__(self) -> str:
        return f"<FieldDescriptor {self.full_name or self.name} = {self.number}>"


class OneofDescriptor:
    def __init__(self, name: str):
        self.name = name
        self.fields: list[FieldDescriptor] = []
        self.full_name = ""


class EnumDescriptor:
    def __init__(self, name: str, values: list[tuple[str, int]]):
        self.name, self.full_name = name, ""
        self.values_by_name = dict(values)
        self.values_by_number: dict[int, str] = {}
        for n, v in values:
            self.values_by_number.setdefault(v, n)


class Descriptor:
    """A message type: fields by name and number, oneofs, nested types."""

    def __init__(self, name: str):
        self.name, self.full_name = name, ""
        self.fields: list[FieldDescriptor] = []
        self.oneofs: list[OneofDescriptor] = []
        self.nested_types: list[Descriptor] = []
        self.enum_types: list[EnumDescriptor] = []
        self.is_map_entry = False
        self.fields_by_name: dict[str, FieldDescriptor] = {}
        self.fields_by_number: dict[int, FieldDescriptor] = {}
        self.oneofs_by_name: dict[str, OneofDescriptor] = {}
        self._class: type | None = None


class FileDescriptor:
    def __init__(self, package: str):
        self.package = package
        self.message_types_by_name: dict[str, Descriptor] = {}
        self.enum_types_by_name: dict[str, EnumDescriptor] = {}


#: the scalar types of proto3 the codec carries (those ``plan.proto`` uses);
#: a file with another (float, fixed32, ...) is refused when it is read
_SCALAR_TYPES = {
    "double": FieldDescriptor.TYPE_DOUBLE, "int64": FieldDescriptor.TYPE_INT64,
    "uint64": FieldDescriptor.TYPE_UINT64, "int32": FieldDescriptor.TYPE_INT32,
    "bool": FieldDescriptor.TYPE_BOOL, "string": FieldDescriptor.TYPE_STRING,
    "bytes": FieldDescriptor.TYPE_BYTES, "uint32": FieldDescriptor.TYPE_UINT32,
    "sint64": FieldDescriptor.TYPE_SINT64,
}
_UNSUPPORTED = ("float", "fixed32", "fixed64", "sfixed32", "sfixed64", "sint32")

# ---------------------------------------------------------------------------
# the .proto parser
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r'\s+|//[^\n]*|/\*.*?\*/|("(?:[^"\\]|\\.)*"|[A-Za-z_][\w.]*|-?\d+|\S)',
                    re.S)


def _tokens(text: str) -> list[str]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m.group(1) is not None:
            out.append(m.group(1))
        pos = m.end()
    return out


class _Parser:
    def __init__(self, text: str):
        self.toks, self.i = _tokens(text), 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self, want: str | None = None) -> str:
        if self.i >= len(self.toks):
            raise ValueError("unexpected end of the .proto file")
        t = self.toks[self.i]
        if want is not None and t != want:
            raise ValueError(f".proto: expected {want!r}, got {t!r} (token {self.i})")
        self.i += 1
        return t

    def file(self) -> tuple[str, list, list]:
        package, messages, enums = "", [], []
        while (t := self.peek()) is not None:
            if t == "syntax":
                self.take()
                self.take("=")
                if self.take() != '"proto3"':
                    raise ValueError("only proto3 files are supported")
                self.take(";")
            elif t == "package":
                self.take()
                package = self.take()
                self.take(";")
            elif t == "message":
                messages.append(self.message())
            elif t == "enum":
                enums.append(self.enum())
            elif t == ";":
                self.take()
            else:
                raise ValueError(f".proto construct {t!r} is not supported")
        return package, messages, enums

    def enum(self) -> EnumDescriptor:
        self.take("enum")
        name = self.take()
        self.take("{")
        values = []
        while self.peek() != "}":
            vname = self.take()
            self.take("=")
            values.append((vname, int(self.take())))
            self.take(";")
        self.take("}")
        return EnumDescriptor(name, values)

    def message(self) -> Descriptor:
        self.take("message")
        d = Descriptor(self.take())
        self.take("{")
        while (t := self.peek()) != "}":
            if t == "message":
                d.nested_types.append(self.message())
            elif t == "enum":
                d.enum_types.append(self.enum())
            elif t == "oneof":
                self.take()
                o = OneofDescriptor(self.take())
                self.take("{")
                while self.peek() != "}":
                    f = self.field(d, self.take())
                    f.containing_oneof = o
                    o.fields.append(f)
                self.take("}")
                d.oneofs.append(o)
            elif t == "map":
                self.map_field(d)
            elif t == ";":
                self.take()
            else:
                self.take()
                if t == "repeated":
                    self.field(d, self.take(), FieldDescriptor.LABEL_REPEATED)
                elif t in ("optional", "required", "group", "extensions", "extend",
                           "reserved", "option"):
                    raise ValueError(f".proto construct {t!r} is not supported")
                else:
                    self.field(d, t)
        self.take("}")
        return d

    def field(self, d: Descriptor, type_name: str,
              label: int = FieldDescriptor.LABEL_OPTIONAL) -> FieldDescriptor:
        name = self.take()
        self.take("=")
        number = int(self.take())
        if self.peek() == "[":
            raise ValueError(f"field options are not supported ({d.name}.{name})")
        if type_name in _UNSUPPORTED:
            raise ValueError(f"scalar type {type_name} is not supported ({d.name}.{name})")
        self.take(";")
        ftype = _SCALAR_TYPES.get(type_name, 0)
        f = FieldDescriptor(name, number, ftype, label, "" if ftype else type_name)
        d.fields.append(f)
        return f

    def map_field(self, d: Descriptor) -> None:
        self.take("map")
        self.take("<")
        ktype = self.take()
        self.take(",")
        vtype = self.take()
        self.take(">")
        name = self.peek()
        entry = Descriptor("".join(p[:1].upper() + p[1:] for p in name.split("_")) + "Entry")
        entry.is_map_entry = True
        if ktype not in _SCALAR_TYPES or ktype in ("double", "bytes"):
            raise ValueError(f"map key type {ktype} is not allowed")
        entry.fields.append(FieldDescriptor("key", 1, _SCALAR_TYPES[ktype],
                                            FieldDescriptor.LABEL_OPTIONAL))
        vt = _SCALAR_TYPES.get(vtype, 0)
        entry.fields.append(FieldDescriptor("value", 2, vt, FieldDescriptor.LABEL_OPTIONAL,
                                            "" if vt else vtype))
        d.nested_types.append(entry)
        f = self.field(d, entry.name, FieldDescriptor.LABEL_REPEATED)
        f.type_name = entry.name


def _index(d: Descriptor, prefix: str, scope: dict) -> None:
    d.full_name = f"{prefix}{d.name}"
    scope[d.full_name] = d
    for e in d.enum_types:
        e.full_name = f"{d.full_name}.{e.name}"
        scope[e.full_name] = e
    for n in d.nested_types:
        _index(n, f"{d.full_name}.", scope)


def _resolve(d: Descriptor, scope: dict) -> None:
    """Resolve every field's type name from the innermost scope outwards,
    and build the lookup tables."""
    for f in d.fields:
        f.full_name = f"{d.full_name}.{f.name}"
        if f.type_name:
            parts = d.full_name.split(".")
            target = None
            for k in range(len(parts), -1, -1):
                target = scope.get(".".join(parts[:k] + [f.type_name]))
                if target is not None:
                    break
            if target is None:
                raise ValueError(f"unknown type {f.type_name} of {f.full_name}")
            if isinstance(target, Descriptor):
                f.type, f.message_type = FieldDescriptor.TYPE_MESSAGE, target
            else:
                f.type, f.enum_type = FieldDescriptor.TYPE_ENUM, target
        if f.number in d.fields_by_number or f.name in d.fields_by_name:
            raise ValueError(f"duplicate field {f.full_name}")
        d.fields_by_name[f.name] = f
        d.fields_by_number[f.number] = f
    d.fields.sort(key=lambda f: f.number)
    for o in d.oneofs:
        o.full_name = f"{d.full_name}.{o.name}"
        d.oneofs_by_name[o.name] = o
    for n in d.nested_types:
        _resolve(n, scope)
        if n.is_map_entry and n.fields[1].type == FieldDescriptor.TYPE_MESSAGE:
            raise ValueError(f"message-valued maps are not supported ({n.full_name})")


# ---------------------------------------------------------------------------
# scalar values: defaults, checks, encoders, decoders
# ---------------------------------------------------------------------------

_FD = FieldDescriptor
_I64, _I32 = (-(1 << 63), (1 << 63) - 1), (-(1 << 31), (1 << 31) - 1)
_RANGES = {_FD.TYPE_INT64: _I64, _FD.TYPE_SINT64: _I64, _FD.TYPE_UINT64: (0, _MASK64),
           _FD.TYPE_INT32: _I32, _FD.TYPE_ENUM: _I32, _FD.TYPE_UINT32: (0, (1 << 32) - 1)}
_WIRE_VARINT, _WIRE_I64, _WIRE_LEN, _WIRE_SGROUP, _WIRE_EGROUP, _WIRE_I32 = 0, 1, 2, 3, 4, 5
_WIRE = {_FD.TYPE_DOUBLE: _WIRE_I64, _FD.TYPE_STRING: _WIRE_LEN, _FD.TYPE_BYTES: _WIRE_LEN,
         _FD.TYPE_MESSAGE: _WIRE_LEN}
_DOUBLE = struct.Struct("<d")


def _default(f: FieldDescriptor):
    t = f.type
    if t == _FD.TYPE_DOUBLE:
        return 0.0
    if t == _FD.TYPE_BOOL:
        return False
    if t == _FD.TYPE_STRING:
        return ""
    if t == _FD.TYPE_BYTES:
        return b""
    return 0


def _check(f: FieldDescriptor, value):
    """``value`` as the field's Python type, or TypeError / ValueError."""
    t = f.type
    if t == _FD.TYPE_DOUBLE:
        if isinstance(value, (str, bytes)) or not hasattr(value, "__float__"):
            raise TypeError(f"{f.full_name}: {type(value).__name__} is not a float")
        return float(value)
    if t == _FD.TYPE_BOOL:
        if value is None or isinstance(value, (str, bytes, float)):
            raise TypeError(f"{f.full_name}: {type(value).__name__} is not a bool")
        return bool(value)
    if t == _FD.TYPE_STRING:
        if isinstance(value, (bytes, bytearray)):
            return bytes(value).decode("utf-8")
        if not isinstance(value, str):
            raise TypeError(f"{f.full_name}: {type(value).__name__} is not a str")
        return value
    if t == _FD.TYPE_BYTES:
        if not isinstance(value, (bytes, bytearray, memoryview)):
            raise TypeError(f"{f.full_name}: expected bytes, {type(value).__name__} found")
        return bytes(value)
    try:
        v = value.__index__()
    except AttributeError:
        raise TypeError(f"{f.full_name}: {type(value).__name__} object cannot be interpreted "
                        "as an integer") from None
    lo, hi = _RANGES[t]
    if not lo <= v <= hi:
        raise ValueError(f"Value out of range: {v}")
    return v


def _is_default(f: FieldDescriptor, v) -> bool:
    if f.type == _FD.TYPE_DOUBLE:
        return _DOUBLE.pack(v) == b"\0" * 8  # -0.0 is not the default
    return not v


def _put_varint(out: bytearray, v: int) -> None:
    v &= _MASK64
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _varint(buf, pos: int, end: int) -> tuple[int, int]:
    if pos >= end:
        raise DecodeError("truncated varint")
    b = buf[pos]
    if b < 0x80:
        return b, pos + 1
    result, shift = b & 0x7F, 7
    while True:
        pos += 1
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & _MASK64, pos + 1
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _put_scalar(out: bytearray, t: int, v) -> None:
    if t == _FD.TYPE_SINT64:
        _put_varint(out, (v << 1) ^ (v >> 63))
    elif t == _FD.TYPE_DOUBLE:
        out += _DOUBLE.pack(v)
    elif t == _FD.TYPE_STRING:
        b = v.encode("utf-8")
        _put_varint(out, len(b))
        out += b
    elif t == _FD.TYPE_BYTES:
        _put_varint(out, len(v))
        out += v
    else:  # int32/int64/uint32/uint64/enum/bool: a negative value takes 10 bytes
        _put_varint(out, int(v))


def _get_scalar(buf, pos: int, end: int, t: int):
    """(value, position after it) of one scalar of type ``t``."""
    if t == _FD.TYPE_DOUBLE:
        if pos + 8 > end:
            raise DecodeError("truncated fixed-width field")
        return _DOUBLE.unpack_from(buf, pos)[0], pos + 8
    if t in (_FD.TYPE_STRING, _FD.TYPE_BYTES):
        n, pos = _varint(buf, pos, end)
        if pos + n > end:
            raise DecodeError("length past the end")
        raw = bytes(buf[pos:pos + n])
        if t == _FD.TYPE_BYTES:
            return raw, pos + n
        try:
            return raw.decode("utf-8"), pos + n
        except UnicodeDecodeError as e:
            raise DecodeError(f"invalid UTF-8 in a string field: {e}") from None
    v, pos = _varint(buf, pos, end)
    if t == _FD.TYPE_BOOL:
        return v != 0, pos
    if t == _FD.TYPE_INT64:
        return v - (1 << 64) if v >> 63 else v, pos
    if t in (_FD.TYPE_INT32, _FD.TYPE_ENUM):
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >> 31 else v, pos
    if t == _FD.TYPE_UINT32:
        return v & 0xFFFFFFFF, pos
    if t == _FD.TYPE_SINT64:
        return (v >> 1) ^ -(v & 1), pos
    return v, pos  # uint64


def _skip(buf, pos: int, end: int, wire: int, number: int) -> int:
    """The position after one field's value of wire type ``wire``."""
    if wire == _WIRE_VARINT:
        return _varint(buf, pos, end)[1]
    if wire in (_WIRE_I64, _WIRE_I32):
        pos += 8 if wire == _WIRE_I64 else 4
    elif wire == _WIRE_LEN:
        n, pos = _varint(buf, pos, end)
        pos += n
    elif wire == _WIRE_SGROUP:
        while True:
            tag, pos = _varint(buf, pos, end)
            if tag & 7 == _WIRE_EGROUP:
                if tag >> 3 != number:
                    raise DecodeError("mismatched end-group tag")
                return pos
            pos = _skip(buf, pos, end, tag & 7, tag >> 3)
    else:
        raise DecodeError(f"invalid wire type {wire}")
    if pos > end:
        raise DecodeError("length past the end")
    return pos


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


class RepeatedScalarContainer:
    """A repeated scalar or enum field: a checked list."""

    __slots__ = ("_owner", "_field", "_values")

    def __init__(self, owner: Message, field: FieldDescriptor):
        self._owner, self._field, self._values = owner, field, []

    def _checked(self, v):
        return _check(self._field, v)

    def append(self, v) -> None:
        self._values.append(self._checked(v))
        self._owner._modified()

    def extend(self, vs) -> None:
        vals = [self._checked(v) for v in vs]
        if vals:
            self._values.extend(vals)
            self._owner._modified()

    def __getitem__(self, i):
        return self._values[i]

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def __eq__(self, other) -> bool:
        if isinstance(other, RepeatedScalarContainer):
            return self._values == other._values
        return isinstance(other, (list, tuple)) and self._values == list(other)

    __hash__ = None

    def __repr__(self) -> str:
        return repr(self._values)


class RepeatedCompositeContainer:
    """A repeated message field."""

    __slots__ = ("_owner", "_field", "_values")

    def __init__(self, owner: Message, field: FieldDescriptor):
        self._owner, self._field, self._values = owner, field, []

    def add(self, **kwargs) -> Message:
        m = self._field.message_type._class(**kwargs)
        self._values.append(m)
        self._owner._modified()
        return m

    def append(self, m: Message) -> None:
        self.add().CopyFrom(m)

    def extend(self, ms) -> None:
        for m in ms:
            self.append(m)

    def __getitem__(self, i):
        return self._values[i]

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def __eq__(self, other) -> bool:
        return list(self) == list(other) if isinstance(
            other, (RepeatedCompositeContainer, list, tuple)) else NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return repr(self._values)


class ScalarMap:
    """A ``map<K, V>`` field with scalar or enum values: a checked dict."""

    __slots__ = ("_owner", "_key", "_value", "_d")

    def __init__(self, owner: Message, field: FieldDescriptor):
        entry = field.message_type
        self._owner, self._key, self._value, self._d = owner, entry.fields[0], entry.fields[1], {}

    def __setitem__(self, k, v) -> None:
        self._d[_check(self._key, k)] = _check(self._value, v)
        self._owner._modified()

    def __getitem__(self, k):
        k = _check(self._key, k)
        if k not in self._d:
            self._d[k] = _default(self._value)
            self._owner._modified()
        return self._d[k]

    def get(self, k, default=None):
        return self._d.get(k, default)

    def update(self, other=(), **kw) -> None:
        for k, v in dict(other, **kw).items():
            self[k] = v

    def __contains__(self, k) -> bool:
        return k in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self):
        return iter(self._d)

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def items(self):
        return self._d.items()

    def __eq__(self, other) -> bool:
        if isinstance(other, ScalarMap):
            return self._d == other._d
        return isinstance(other, dict) and self._d == other

    __hash__ = None

    def __repr__(self) -> str:
        return repr(self._d)


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------


class Message:
    """Base of the generated message classes (``DESCRIPTOR`` per class).

    ``_f`` holds the set fields by name (scalars as set, sub-messages that
    are present, containers once read); ``_lazy`` the empty sub-messages
    handed out for absent fields; ``_parent`` the (message, field) a lazy
    sub-message attaches to when it is first written."""

    __slots__ = ("_f", "_lazy", "_parent")
    DESCRIPTOR: Descriptor

    def __init__(self, **kwargs):
        object.__setattr__(self, "_f", {})
        object.__setattr__(self, "_lazy", None)
        object.__setattr__(self, "_parent", None)
        for name, value in kwargs.items():
            self._init_field(name, value)

    def _init_field(self, name: str, value) -> None:
        f = self._field(name)
        if value is None:
            return
        if f.is_map:
            getattr(self, name).update(value)
        elif f.label == _FD.LABEL_REPEATED:
            getattr(self, name).extend(value)
        elif f.type == _FD.TYPE_MESSAGE:
            getattr(self, name).CopyFrom(value)
        else:
            setattr(self, name, value)

    @classmethod
    def _field(cls, name: str) -> FieldDescriptor:
        f = cls.DESCRIPTOR.fields_by_name.get(name)
        if f is None:
            raise ValueError(f'Protocol message {cls.DESCRIPTOR.name} has no "{name}" field.')
        return f

    # ---- presence ----

    def _modified(self) -> None:
        """Called on every write: a lazy sub-message becomes present in its
        parent (and the parent in its own), clearing a oneof's other member."""
        p = self._parent
        if p is not None:
            object.__setattr__(self, "_parent", None)
            parent, f = p
            parent._attach(f, self)

    def _attach(self, f: FieldDescriptor, child: Message) -> None:
        if f.containing_oneof is not None:
            self._clear_oneof(f.containing_oneof, keep=f.name)
        self._f[f.name] = child
        if self._lazy is not None and self._lazy.get(f.name) is child:
            del self._lazy[f.name]
        self._modified()

    def _clear_oneof(self, o: OneofDescriptor, keep: str | None = None) -> None:
        for m in o.fields:
            if m.name != keep:
                self._f.pop(m.name, None)

    # ---- attributes ----

    def __getattr__(self, name: str):
        f = type(self).DESCRIPTOR.fields_by_name.get(name)
        if f is None:
            raise AttributeError(f"{type(self).DESCRIPTOR.name} has no field {name!r}")
        got = self._f.get(name)
        if got is not None:
            return got
        if f.is_map:
            box = self._f[name] = ScalarMap(self, f)
            return box
        if f.label == _FD.LABEL_REPEATED:
            box = self._f[name] = (RepeatedCompositeContainer(self, f)
                                   if f.type == _FD.TYPE_MESSAGE
                                   else RepeatedScalarContainer(self, f))
            return box
        if f.type == _FD.TYPE_MESSAGE:
            lazy = self._lazy
            if lazy is None:
                lazy = {}
                object.__setattr__(self, "_lazy", lazy)
            sub = lazy.get(name)
            if sub is None:
                sub = lazy[name] = f.message_type._class()
                object.__setattr__(sub, "_parent", (self, f))
            return sub
        return _default(f)

    def __setattr__(self, name: str, value) -> None:
        f = type(self).DESCRIPTOR.fields_by_name.get(name)
        if f is None:
            raise AttributeError(f"{type(self).DESCRIPTOR.name} has no field {name!r}")
        if f.label == _FD.LABEL_REPEATED:
            raise AttributeError(f'Assignment not allowed to map, or repeated field "{name}" '
                                 "in protocol message object.")
        if f.type == _FD.TYPE_MESSAGE:
            raise AttributeError(f'Assignment not allowed to message field "{name}" in '
                                 "protocol message object.")
        v = _check(f, value)
        if f.containing_oneof is not None:
            self._clear_oneof(f.containing_oneof, keep=name)
        self._f[name] = v
        self._modified()

    # ---- the message API ----

    def HasField(self, name: str) -> bool:
        desc = type(self).DESCRIPTOR
        o = desc.oneofs_by_name.get(name)
        if o is not None:
            return self.WhichOneof(name) is not None
        f = self._field(name)
        if f.label == _FD.LABEL_REPEATED or (f.type != _FD.TYPE_MESSAGE
                                             and f.containing_oneof is None):
            raise ValueError(f"Field {f.full_name} does not have presence.")
        return name in self._f

    def WhichOneof(self, oneof: str) -> str | None:
        o = type(self).DESCRIPTOR.oneofs_by_name.get(oneof)
        if o is None:
            raise ValueError(f'Protocol message has no oneof "{oneof}" field.')
        for m in o.fields:
            if m.name in self._f:
                return m.name
        return None

    def ClearField(self, name: str) -> None:
        o = type(self).DESCRIPTOR.oneofs_by_name.get(name)
        if o is not None:
            self._clear_oneof(o)
            return
        self._field(name)
        self._f.pop(name, None)
        if self._lazy is not None:
            self._lazy.pop(name, None)

    def Clear(self) -> None:
        self._f.clear()
        object.__setattr__(self, "_lazy", None)

    def SetInParent(self) -> None:
        self._modified()

    def ListFields(self) -> list:
        out = []
        for f in type(self).DESCRIPTOR.fields:
            v = self._f.get(f.name)
            if v is None:
                continue
            if f.label == _FD.LABEL_REPEATED:
                if len(v):
                    out.append((f, v))
            elif f.type == _FD.TYPE_MESSAGE or f.containing_oneof is not None \
                    or not _is_default(f, v):
                out.append((f, v))
        return out

    def CopyFrom(self, other: Message) -> None:
        if other is self:
            return
        other = self._same_type(other)
        self.Clear()
        self._merge(other)
        self._modified()

    def MergeFrom(self, other: Message) -> None:
        self._merge(self._same_type(other))
        self._modified()

    def _same_type(self, other) -> Message:
        """``other`` as this class: a message of another implementation with
        the same full name (a ``google.protobuf`` message) crosses as bytes."""
        if type(other) is type(self):
            return other
        desc = getattr(other, "DESCRIPTOR", None)
        if getattr(desc, "full_name", None) == type(self).DESCRIPTOR.full_name \
                and hasattr(other, "SerializeToString"):
            return type(self).FromString(other.SerializeToString())
        raise TypeError(f"Parameter to CopyFrom() must be instance of same class: expected "
                        f"{type(self).DESCRIPTOR.full_name} got {type(other).__name__}.")

    def _merge(self, other: Message) -> None:
        for f, v in other.ListFields():
            if f.is_map:
                getattr(self, f.name).update(v)
            elif f.label == _FD.LABEL_REPEATED:
                getattr(self, f.name).extend(v)
            elif f.type == _FD.TYPE_MESSAGE:
                getattr(self, f.name).MergeFrom(v)
            else:
                setattr(self, f.name, v)

    def SerializeToString(self, deterministic: bool = True) -> bytes:
        """The deterministic bytes, always (``deterministic`` is taken for
        ``google.protobuf``'s signature)."""
        out = bytearray()
        _encode(self, out)
        return bytes(out)

    def ByteSize(self) -> int:
        return len(self.SerializeToString())

    def ParseFromString(self, data) -> int:
        fresh = type(self)()
        buf = memoryview(data).cast("B") if not isinstance(data, bytes) else data
        _decode(fresh, buf, 0, len(buf))
        self.Clear()
        self._f.update(fresh._f)
        for v in fresh._f.values():
            if isinstance(v, (RepeatedScalarContainer, RepeatedCompositeContainer, ScalarMap)):
                v._owner = self
        self._modified()
        return len(buf)

    @classmethod
    def FromString(cls, data) -> Message:
        m = cls()
        m.ParseFromString(data)
        return m

    def __eq__(self, other) -> bool:
        if not isinstance(other, Message):
            return NotImplemented
        return type(other).DESCRIPTOR.full_name == type(self).DESCRIPTOR.full_name and \
            self.SerializeToString() == other.SerializeToString()

    __hash__ = None

    def __repr__(self) -> str:
        return _text(self, 0) or f"<{type(self).DESCRIPTOR.name} (empty)>"

    __str__ = __repr__


def _text(m: Message, depth: int) -> str:
    pad, lines = "  " * depth, []
    for f, v in m.ListFields():
        if f.is_map:
            lines += [f"{pad}{f.name} {{ key: {k!r} value: {x!r} }}" for k, x in sorted(v.items())]
            continue
        vals = v if f.label == _FD.LABEL_REPEATED else [v]
        for x in vals:
            if f.type == _FD.TYPE_MESSAGE:
                lines.append(f"{pad}{f.name} {{\n{_text(x, depth + 1)}\n{pad}}}"
                             if x.ListFields() else f"{pad}{f.name} {{\n{pad}}}")
            elif f.type == _FD.TYPE_ENUM:
                lines.append(f"{pad}{f.name}: {f.enum_type.values_by_number.get(x, x)}")
            else:
                lines.append(f"{pad}{f.name}: {x!r}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


def _cmp_str_keys(a: str, b: str) -> int:
    x, y = a.encode("utf-8"), b.encode("utf-8")
    n = min(len(x), len(y))
    if x[:n] != y[:n]:
        return -1 if x[:n] < y[:n] else 1
    return len(y) - len(x)


def _map_order(keys) -> list:
    """Map keys in the order of ``google.protobuf``'s deterministic output."""
    keys = list(keys)
    if keys and isinstance(keys[0], str):
        return sorted(keys, key=functools.cmp_to_key(_cmp_str_keys))
    return sorted(keys, reverse=True)


def _tag(out: bytearray, number: int, wire: int) -> None:
    _put_varint(out, (number << 3) | wire)


def _encode(m: Message, out: bytearray) -> None:
    fields = m._f
    for f in type(m).DESCRIPTOR.fields:
        v = fields.get(f.name)
        if v is None:
            continue
        t = f.type
        if f.is_map:
            kf, vf = f.message_type.fields
            for k in _map_order(v._d):
                entry = bytearray()
                _tag(entry, 1, _WIRE.get(kf.type, _WIRE_VARINT))
                _put_scalar(entry, kf.type, k)
                _tag(entry, 2, _WIRE.get(vf.type, _WIRE_VARINT))
                _put_scalar(entry, vf.type, v._d[k])
                _tag(out, f.number, _WIRE_LEN)
                _put_varint(out, len(entry))
                out += entry
        elif f.label == _FD.LABEL_REPEATED:
            if t == _FD.TYPE_MESSAGE:
                for x in v._values:
                    sub = bytearray()
                    _encode(x, sub)
                    _tag(out, f.number, _WIRE_LEN)
                    _put_varint(out, len(sub))
                    out += sub
            elif t in (_FD.TYPE_STRING, _FD.TYPE_BYTES):
                for x in v._values:
                    _tag(out, f.number, _WIRE_LEN)
                    _put_scalar(out, t, x)
            elif v._values:
                packed = bytearray()
                for x in v._values:
                    _put_scalar(packed, t, x)
                _tag(out, f.number, _WIRE_LEN)
                _put_varint(out, len(packed))
                out += packed
        elif t == _FD.TYPE_MESSAGE:
            sub = bytearray()
            _encode(v, sub)
            _tag(out, f.number, _WIRE_LEN)
            _put_varint(out, len(sub))
            out += sub
        elif f.containing_oneof is not None or not _is_default(f, v):
            _tag(out, f.number, _WIRE.get(t, _WIRE_VARINT))
            _put_scalar(out, t, v)


def _decode(m: Message, buf, pos: int, end: int) -> None:
    desc = type(m).DESCRIPTOR
    fields = m._f
    while pos < end:
        tag, pos = _varint(buf, pos, end)
        number, wire = tag >> 3, tag & 7
        if number == 0:
            raise DecodeError("field number 0")
        if wire in (6, 7) or wire == _WIRE_EGROUP:
            raise DecodeError(f"invalid wire type {wire}")
        f = desc.fields_by_number.get(number)
        t = f.type if f is not None else 0
        want = _WIRE.get(t, _WIRE_VARINT)
        repeated = f is not None and f.label == _FD.LABEL_REPEATED
        packed = repeated and wire == _WIRE_LEN and want != _WIRE_LEN
        if f is None or (wire != want and not packed):
            pos = _skip(buf, pos, end, wire, number)
            continue
        if f.is_map:
            n, pos = _varint(buf, pos, end)
            if pos + n > end:
                raise DecodeError("length past the end")
            entry = f.message_type._class()
            _decode(entry, buf, pos, pos + n)
            pos += n
            box = getattr(m, f.name)
            box._d[entry.key] = entry.value
        elif t == _FD.TYPE_MESSAGE:
            n, pos = _varint(buf, pos, end)
            if pos + n > end:
                raise DecodeError("length past the end")
            if repeated:
                sub = getattr(m, f.name).add()
            else:
                sub = fields.get(f.name)
                if sub is None:
                    if f.containing_oneof is not None:
                        m._clear_oneof(f.containing_oneof)
                    sub = fields[f.name] = f.message_type._class()
            _decode(sub, buf, pos, pos + n)
            pos += n
        elif packed:
            n, pos = _varint(buf, pos, end)
            stop = pos + n
            if stop > end:
                raise DecodeError("length past the end")
            box = getattr(m, f.name)
            while pos < stop:
                v, pos = _get_scalar(buf, pos, stop, t)
                box._values.append(v)
            if pos != stop:
                raise DecodeError("packed field overruns its length")
        else:
            v, pos = _get_scalar(buf, pos, end, t)
            if repeated:
                getattr(m, f.name)._values.append(v)
            else:
                if f.containing_oneof is not None:
                    m._clear_oneof(f.containing_oneof)
                fields[f.name] = v
    if pos != end:
        raise DecodeError("length past the end")


# ---------------------------------------------------------------------------
# classes and enums
# ---------------------------------------------------------------------------


class EnumTypeWrapper:
    """An enum: ``Name(number)``, ``Value(name)``, and its values as attributes."""

    def __init__(self, desc: EnumDescriptor):
        self.DESCRIPTOR = desc
        for n, v in desc.values_by_name.items():
            setattr(self, n, v)

    def Name(self, number: int) -> str:
        try:
            return self.DESCRIPTOR.values_by_number[number]
        except KeyError:
            raise ValueError(f"Enum {self.DESCRIPTOR.name} has no name defined for value "
                             f"{number!r}") from None

    def Value(self, name: str) -> int:
        try:
            return self.DESCRIPTOR.values_by_name[name]
        except KeyError:
            raise ValueError(f"Enum {self.DESCRIPTOR.name} has no value defined for name "
                             f"{name!r}") from None


def _make_class(d: Descriptor) -> type:
    ns: dict = {"__slots__": (), "DESCRIPTOR": d, "__qualname__": d.full_name}
    for n in d.nested_types:
        ns[n.name] = _make_class(n)
    for e in d.enum_types:
        ns[e.name] = EnumTypeWrapper(e)
        ns.update(e.values_by_name)
    cls = type(d.name, (Message,), ns)
    d._class = cls
    return cls


def load(path: str) -> types.SimpleNamespace:
    """The message classes and enums of the proto3 file at ``path``, named as
    ``protoc``'s ``_pb2`` module names them, plus ``DESCRIPTOR`` (the file's
    message and enum descriptors by name)."""
    with open(path, encoding="utf-8") as fh:
        package, messages, enums = _Parser(fh.read()).file()
    prefix = f"{package}." if package else ""
    scope: dict = {}
    for e in enums:
        e.full_name = f"{prefix}{e.name}"
        scope[e.full_name] = e
    for d in messages:
        _index(d, prefix, scope)
    for d in messages:
        _resolve(d, scope)
    fd = FileDescriptor(package)
    ns = types.SimpleNamespace(DESCRIPTOR=fd, DecodeError=DecodeError)
    for e in enums:
        fd.enum_types_by_name[e.name] = e
        setattr(ns, e.name, EnumTypeWrapper(e))
        for n, v in e.values_by_name.items():
            setattr(ns, n, v)
    for d in messages:
        fd.message_types_by_name[d.name] = d
        setattr(ns, d.name, _make_class(d))
    return ns
