"""Minimal Avro container-file codec, reader and writer (port of
``auron_tpu/utils/avro.py``).

Iceberg's and Paimon's manifest lists and manifests are Avro object
container files. This implements the subset of the Avro 1.11 spec they
use: container framing (magic, metadata map, sync markers, the null and
deflate codecs) and the binary encoding of null / boolean / int / long
(zigzag varints) / float / double / bytes / string / fixed / enum / record /
array / map / union. Logical types pass through as their underlying
primitives. The writer produces real container files for tests and
producers.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# binary encoding
# ---------------------------------------------------------------------------


class Decoder:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def long(self) -> int:
        shift = 0
        acc = 0
        while True:
            if self.pos >= len(self.buf):
                raise EOFError("truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def bytes_(self) -> bytes:
        n = self.long()
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError("truncated bytes")
        self.pos += n
        return out

    def string(self) -> str:
        return self.bytes_().decode()

    def fixed(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def read(self, schema) -> object:
        """Decode one value of `schema` (parsed JSON form)."""
        if isinstance(schema, str):
            t = schema
            if t == "null":
                return None
            if t == "boolean":
                v = self.buf[self.pos]
                self.pos += 1
                return bool(v)
            if t in ("int", "long"):
                return self.long()
            if t == "float":
                (v,) = struct.unpack_from("<f", self.buf, self.pos)
                self.pos += 4
                return v
            if t == "double":
                (v,) = struct.unpack_from("<d", self.buf, self.pos)
                self.pos += 8
                return v
            if t == "bytes":
                return self.bytes_()
            if t == "string":
                return self.string()
            raise ValueError(f"unknown avro type {t!r}")
        if isinstance(schema, list):  # union
            idx = self.long()
            return self.read(schema[idx])
        t = schema["type"]
        if t == "record":
            return {
                f["name"]: self.read(f["type"]) for f in schema["fields"]
            }
        if t == "array":
            out = []
            while True:
                n = self.long()
                if n == 0:
                    return out
                if n < 0:
                    self.long()  # block byte size (skippable form)
                    n = -n
                for _ in range(n):
                    out.append(self.read(schema["items"]))
        if t == "map":
            out = {}
            while True:
                n = self.long()
                if n == 0:
                    return out
                if n < 0:
                    self.long()
                    n = -n
                for _ in range(n):
                    k = self.string()
                    out[k] = self.read(schema["values"])
        if t == "enum":
            return schema["symbols"][self.long()]
        if t == "fixed":
            return self.fixed(schema["size"])
        # named/logical passthrough: {"type": "long", "logicalType": ...}
        return self.read(t)


class Encoder:
    def __init__(self):
        self.out = io.BytesIO()

    def long(self, v: int) -> None:
        u = (v << 1) ^ (v >> 63)
        while True:
            b = u & 0x7F
            u >>= 7
            if u:
                self.out.write(bytes([b | 0x80]))
            else:
                self.out.write(bytes([b]))
                return

    def bytes_(self, v: bytes) -> None:
        self.long(len(v))
        self.out.write(v)

    def string(self, v: str) -> None:
        self.bytes_(v.encode())

    def write(self, schema, value) -> None:
        if isinstance(schema, str):
            t = schema
            if t == "null":
                return
            if t == "boolean":
                self.out.write(b"\x01" if value else b"\x00")
            elif t in ("int", "long"):
                self.long(int(value))
            elif t == "float":
                self.out.write(struct.pack("<f", value))
            elif t == "double":
                self.out.write(struct.pack("<d", value))
            elif t == "bytes":
                self.bytes_(value)
            elif t == "string":
                self.string(value)
            else:
                raise ValueError(f"unknown avro type {t!r}")
            return
        if isinstance(schema, list):  # union: pick first matching branch
            for i, branch in enumerate(schema):
                if _matches(branch, value):
                    self.long(i)
                    self.write(branch, value)
                    return
            raise ValueError(f"no union branch for {value!r} in {schema}")
        t = schema["type"]
        if t == "record":
            for f in schema["fields"]:
                self.write(f["type"], value[f["name"]])
        elif t == "array":
            if value:
                self.long(len(value))
                for item in value:
                    self.write(schema["items"], item)
            self.long(0)
        elif t == "map":
            if value:
                self.long(len(value))
                for k, v in value.items():
                    self.string(k)
                    self.write(schema["values"], v)
            self.long(0)
        elif t == "enum":
            self.long(schema["symbols"].index(value))
        elif t == "fixed":
            assert len(value) == schema["size"]
            self.out.write(value)
        else:
            self.write(t, value)


_BRANCH_PY = {
    "boolean": bool, "int": int, "long": int, "float": (float, int),
    "double": (float, int), "bytes": (bytes, bytearray), "string": str,
}


def _matches(branch, value) -> bool:
    if branch == "null":
        return value is None
    if value is None:
        return False
    if isinstance(branch, dict):
        return True  # record/array/map/fixed: caller's responsibility
    return isinstance(value, _BRANCH_PY.get(branch, object))


# ---------------------------------------------------------------------------
# container files
# ---------------------------------------------------------------------------


def read_container(path: str) -> tuple[dict, list]:
    """(writer schema, records) of an Avro object container file."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != MAGIC:
        raise ValueError(f"{path}: not an avro container file")
    d = Decoder(buf, 4)
    meta = d.read({"type": "map", "values": "bytes"})
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    sync = d.fixed(16)
    records = []
    while d.pos < len(buf):
        count = d.long()
        size = d.long()
        block = d.buf[d.pos : d.pos + size]
        d.pos += size
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec!r}")
        bd = Decoder(block)
        for _ in range(count):
            records.append(bd.read(schema))
        if d.fixed(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch")
    return schema, records


def write_container(path: str, schema: dict, records: list,
                    codec: str = "null") -> None:
    """One-block Avro container file (test/producer side)."""
    enc = Encoder()
    for r in records:
        enc.write(schema, r)
    block = enc.out.getvalue()
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        block = comp.compress(block) + comp.flush()
    sync = os.urandom(16)
    head = Encoder()
    head.write({"type": "map", "values": "bytes"}, {
        "avro.schema": json.dumps(schema).encode(),
        "avro.codec": codec.encode(),
    })
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(head.out.getvalue())
        f.write(sync)
        body = Encoder()
        body.long(len(records))
        body.long(len(block))
        f.write(body.out.getvalue())
        f.write(block)
        f.write(sync)
