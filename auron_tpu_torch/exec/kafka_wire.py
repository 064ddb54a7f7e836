"""Kafka client speaking the wire protocol over TCP, with no client library
(port of ``auron_tpu/exec/kafka_wire.py``).

``KafkaWireSource`` implements the ``StreamSource`` protocol of
``exec/streaming.py`` against a broker, speaking the Kafka binary
protocol directly. The subset a partition-assigned reader needs:

- Metadata v1 (api 3): partition discovery and leader addresses;
- ListOffsets v1 (api 2): the earliest/latest startup modes;
- Fetch v4 (api 1): record batches (message format v2, Kafka >= 0.11),
  uncompressed / gzip / zstd, CRC-32C checked; control batches advance
  the offset and carry no records.

No consumer groups: partitions are assigned by the planner (as Flink
assigns splits), offsets surface through ``offsets()`` for checkpointing
and resume through startup_mode="offsets". A dropped connection or a
partial frame reconnects once; an offset past retention resets by the
``offset_reset`` policy.

CRC-32C is the table loop of ``crc32c`` below (the reference's fallback
when its native library is absent).
"""

from __future__ import annotations

import socket
import struct
import threading
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# primitive codec
# ---------------------------------------------------------------------------


class Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise EOFError(f"need {n} bytes at {self.pos}")
        self.pos += n
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self.take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def string(self) -> str | None:
        n = self.i16()
        if n == -1:
            return None
        return self.take(n).decode()

    def bytes_(self) -> bytes | None:
        n = self.i32()
        if n == -1:
            return None
        return self.take(n)

    def varint(self) -> int:
        """Zigzag varint (record fields)."""
        u = self.uvarint()
        return (u >> 1) ^ -(u & 1)

    def uvarint(self) -> int:
        shift = 0
        out = 0
        while True:
            if self.pos >= len(self.buf):
                raise EOFError("truncated varint")
            if shift > 63:
                raise ValueError("varint exceeds 10 bytes")
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7


def enc_str(s: str | None) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def enc_bytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def enc_uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def enc_varint(v: int) -> bytes:
    return enc_uvarint((v << 1) ^ (v >> 63) if v < 0 else (v << 1))


# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli) — record batch checksum; stdlib has only CRC-32
# ---------------------------------------------------------------------------

_CRC32C_TABLE = []


def _crc32c_init():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC32C_TABLE.append(c)


_crc32c_init()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    crc = ~crc & 0xFFFFFFFF
    tbl = _CRC32C_TABLE
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return ~crc & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# record batch v2 (magic 2) codec
# ---------------------------------------------------------------------------

CODEC_NONE, CODEC_GZIP, CODEC_SNAPPY, CODEC_LZ4, CODEC_ZSTD = range(5)


def decode_record_batches(buf: bytes) -> list[tuple[int, bytes | None]]:
    """All (offset, value) records in a fetch response's record set.
    Validates magic + CRC-32C; decompresses gzip/zstd bodies. A trailing
    partial batch (brokers may truncate at max_bytes) is skipped."""
    out: list[tuple[int, bytes | None]] = []
    pos = 0
    while pos + 17 <= len(buf):
        c = Cursor(buf, pos)
        base_offset = c.i64()
        batch_len = c.i32()
        end = c.pos + batch_len
        if end > len(buf):
            break  # partial trailing batch
        c.i32()  # partition leader epoch (not covered by crc)
        magic = c.i8()
        if magic != 2:
            raise ValueError(f"unsupported record magic {magic} (need >=0.11 broker)")
        crc = c.u32()
        crc_data = buf[c.pos : end]
        if crc32c(crc_data) != crc:
            raise ValueError("record batch CRC-32C mismatch")
        attributes = c.i16()
        last_offset_delta = c.i32()
        c.i64()  # base timestamp
        c.i64()  # max timestamp
        c.i64()  # producer id
        c.i16()  # producer epoch
        c.i32()  # base sequence
        n_records = c.i32()
        if attributes & 0x20:
            # control batch (txn commit/abort markers): its records are
            # not user data, but offsets must still advance past them
            out.append((base_offset + last_offset_delta, None))
            pos = end
            continue
        body = buf[c.pos : end]
        codec = attributes & 0x07
        if codec == CODEC_GZIP:
            import gzip

            body = gzip.decompress(body)
        elif codec == CODEC_ZSTD:
            import zstandard

            body = zstandard.ZstdDecompressor().decompress(body)
        elif codec != CODEC_NONE:
            raise ValueError(f"unsupported compression codec {codec}")
        rc = Cursor(body)
        for _ in range(n_records):
            rec_len = rc.varint()
            rec_end = rc.pos + rec_len
            rc.i8()  # attributes
            rc.varint()  # timestamp delta
            offset_delta = rc.varint()
            klen = rc.varint()
            if klen >= 0:
                rc.take(klen)
            vlen = rc.varint()
            value = rc.take(vlen) if vlen >= 0 else None
            out.append((base_offset + offset_delta, value))
            rc.pos = rec_end  # skip headers
        pos = end
    return out


def encode_record_batch(
    base_offset: int, values: list[bytes], codec: int = CODEC_NONE
) -> bytes:
    """One record batch v2 (producer side — the mini broker and tests use
    it; a real producer path would add idempotence fields)."""
    body = bytearray()
    for i, v in enumerate(values):
        rec = bytearray()
        rec += b"\x00"  # attributes
        rec += enc_varint(0)  # timestamp delta
        rec += enc_varint(i)  # offset delta
        rec += enc_varint(-1)  # null key
        rec += enc_varint(len(v))
        rec += v
        rec += enc_uvarint(0)  # headers
        body += enc_varint(len(rec)) + rec
    body = bytes(body)
    if codec == CODEC_GZIP:
        import gzip

        body = gzip.compress(body)
    elif codec == CODEC_ZSTD:
        import zstandard

        body = zstandard.ZstdCompressor().compress(body)
    elif codec != CODEC_NONE:
        raise ValueError(f"unsupported compression codec {codec}")
    after_crc = (
        struct.pack(">h", codec)  # attributes
        + struct.pack(">i", len(values) - 1)  # last offset delta
        + struct.pack(">q", 0)  # base timestamp
        + struct.pack(">q", 0)  # max timestamp
        + struct.pack(">q", -1)  # producer id
        + struct.pack(">h", -1)  # producer epoch
        + struct.pack(">i", -1)  # base sequence
        + struct.pack(">i", len(values))
        + body
    )
    crc = crc32c(after_crc)
    batch = (
        struct.pack(">i", 0)  # partition leader epoch
        + struct.pack(">b", 2)  # magic
        + struct.pack(">I", crc)
        + after_crc
    )
    return struct.pack(">q", base_offset) + struct.pack(">i", len(batch)) + batch


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

API_FETCH, API_LIST_OFFSETS, API_METADATA = 1, 2, 3

TS_EARLIEST = -2
TS_LATEST = -1


class KafkaConnection:
    """One broker TCP connection with request/response framing."""

    def __init__(self, host: str, port: int, client_id: str = "auron-tpu-torch",
                 timeout_s: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def request(self, api_key: int, api_version: int, body: bytes) -> Cursor:
        with self._lock:
            self._corr += 1
            corr = self._corr
            header = (
                struct.pack(">hhi", api_key, api_version, corr)
                + enc_str(self.client_id)
            )
            msg = header + body
            self.sock.sendall(struct.pack(">i", len(msg)) + msg)
            resp = self._read_frame()
        c = Cursor(resp)
        got_corr = c.i32()
        if got_corr != corr:
            raise ValueError(f"correlation id {got_corr} != {corr}")
        return c

    def _read_frame(self) -> bytes:
        from auron_tpu_torch.utils.netio import read_exact

        hdr = read_exact(self.sock, 4)
        (n,) = struct.unpack(">i", hdr)
        return read_exact(self.sock, n)


@dataclass
class _PartitionState:
    leader: tuple[str, int]
    next_offset: int = 0
    end_offset: int | None = None  # latest known high watermark


class KafkaWireSource:
    """StreamSource over a broker: manual partition assignment,
    earliest/latest/offsets startup, offsets() checkpoint surface.

    partitions=None assigns ALL partitions of the topic (single-reader);
    an explicit subset assigns those (an EMPTY list is a valid zero-split
    assignment: poll() drains immediately); assign_mod=(index, parallelism)
    assigns the discovered partitions where pid % parallelism == index —
    the deterministic round-robin split a parallel runtime uses
    (KafkaTopicPartitionAssigner analog)."""

    def __init__(
        self,
        bootstrap: str,
        topic: str,
        startup_mode: str = "earliest",
        start_offsets: dict | None = None,
        partitions: list[int] | None = None,
        client_id: str = "auron-tpu-torch",
        fetch_max_bytes: int = 4 << 20,
        timeout_s: float = 30.0,
        offset_reset: str = "earliest",
        assign_mod: tuple[int, int] | None = None,
    ):
        if startup_mode not in ("earliest", "latest", "offsets"):
            raise ValueError(f"unknown startup_mode {startup_mode!r}")
        if offset_reset not in ("earliest", "latest", "fail"):
            raise ValueError(f"unknown offset_reset {offset_reset!r}")
        host, port_s = bootstrap.rsplit(":", 1)
        self.topic = topic
        self.timeout_s = timeout_s
        self.client_id = client_id
        self.fetch_max_bytes = fetch_max_bytes
        #: policy when a checkpointed offset has aged out of retention
        #: (OFFSET_OUT_OF_RANGE) — rdkafka's auto.offset.reset analog
        self.offset_reset = offset_reset
        self._conns: dict[tuple[str, int], KafkaConnection] = {}
        boot = self._conn((host, int(port_s)))
        self._parts = self._discover(boot, partitions, assign_mod)
        self._init_offsets(startup_mode, start_offsets or {})
        self._rr = 0  # round-robin cursor over assigned partitions

    # -- setup ----------------------------------------------------------

    def _conn(self, addr: tuple[str, int]) -> KafkaConnection:
        if addr not in self._conns:
            self._conns[addr] = KafkaConnection(
                addr[0], addr[1], self.client_id, self.timeout_s
            )
        return self._conns[addr]

    def _leader_request(
        self, addr: tuple[str, int], api: int, ver: int, body: bytes
    ) -> Cursor:
        """One request with reconnect-once on a broken connection (broker
        restart / idle-connection reaping / partial frame under
        congestion). Safe for the read APIs this source issues — metadata,
        list_offsets, fetch are all idempotent; offsets only advance after
        a DECODED response, so a retried fetch can't skip records."""
        for attempt in (0, 1):
            try:
                return self._conn(addr).request(api, ver, body)
            except (ConnectionError, OSError):
                stale = self._conns.pop(addr, None)
                if stale is not None:
                    stale.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _discover(
        self,
        boot: KafkaConnection,
        wanted: list[int] | None,
        assign_mod: tuple[int, int] | None = None,
    ):
        body = struct.pack(">i", 1) + enc_str(self.topic)
        c = boot.request(API_METADATA, 1, body)
        brokers = {}
        for _ in range(c.i32()):
            node = c.i32()
            host = c.string()
            port = c.i32()
            c.string()  # rack
            brokers[node] = (host, port)
        c.i32()  # controller id
        parts: dict[int, _PartitionState] = {}
        for _ in range(c.i32()):
            err = c.i16()
            name = c.string()
            c.i8()  # is_internal
            n_parts = c.i32()
            for _ in range(n_parts):
                perr = c.i16()
                pid = c.i32()
                leader = c.i32()
                for _ in range(c.i32()):
                    c.i32()  # replicas
                for _ in range(c.i32()):
                    c.i32()  # isr
                if name != self.topic:
                    continue
                if wanted is not None and pid not in wanted:
                    continue
                if assign_mod is not None and pid % assign_mod[1] != assign_mod[0]:
                    continue
                if perr:
                    raise RuntimeError(f"partition {pid} metadata error {perr}")
                parts[pid] = _PartitionState(leader=brokers[leader])
            if err:
                raise RuntimeError(f"topic {name} metadata error {err}")
        if not parts and wanted is None and assign_mod is None:
            # an explicit empty/mod assignment is a valid zero-split reader
            # (parallelism > partition count); only ALL-partitions discovery
            # of a partitionless topic is an error
            raise RuntimeError(f"topic {self.topic}: no assignable partitions")
        return parts

    def _init_offsets(self, mode: str, start: dict) -> None:
        if mode == "offsets":
            for pid, st in self._parts.items():
                st.next_offset = int(start.get(pid, 0))
            return
        ts = TS_EARLIEST if mode == "earliest" else TS_LATEST
        for pid, st in self._parts.items():
            st.next_offset = self._list_offset(pid, st, ts)

    def _list_offset(self, pid: int, st: _PartitionState, ts: int) -> int:
        body = (
            struct.pack(">i", -1)  # replica id
            + struct.pack(">i", 1)  # one topic
            + enc_str(self.topic)
            + struct.pack(">i", 1)  # one partition
            + struct.pack(">iq", pid, ts)
        )
        c = self._leader_request(st.leader, API_LIST_OFFSETS, 1, body)
        for _ in range(c.i32()):
            c.string()  # topic
            for _ in range(c.i32()):
                rpid = c.i32()
                err = c.i16()
                c.i64()  # timestamp
                off = c.i64()
                if rpid == pid:
                    if err:
                        raise RuntimeError(f"list_offsets p{pid} error {err}")
                    return off
        raise RuntimeError(f"list_offsets: partition {pid} missing in response")

    # -- StreamSource ----------------------------------------------------

    def poll(self, max_records: int) -> list[bytes] | None:
        """Fetch from assigned partitions round-robin. None = every
        partition is drained to its current high watermark (micro-batch
        boundary; a fresh poll later may return more)."""
        pids = sorted(self._parts)
        out: list[bytes] = []
        drained = 0
        for i in range(len(pids)):
            if len(out) >= max_records:
                break
            pid = pids[(self._rr + i) % len(pids)]
            st = self._parts[pid]
            records, hwm = self._fetch(pid, st)
            st.end_offset = hwm
            if not records and st.next_offset >= hwm:
                drained += 1
                continue
            for off, val in records:
                if off < st.next_offset:  # compacted/rewound duplicates
                    continue
                if val is not None:
                    out.append(val)
                st.next_offset = off + 1
                if len(out) >= max_records:
                    break
        self._rr += 1
        if not out and drained == len(pids):
            return None
        return out

    def _fetch(self, pid: int, st: _PartitionState):
        body = (
            struct.pack(">i", -1)  # replica id
            + struct.pack(">i", 100)  # max wait ms
            + struct.pack(">i", 1)  # min bytes
            + struct.pack(">i", self.fetch_max_bytes)
            + struct.pack(">b", 0)  # isolation: read_uncommitted
            + struct.pack(">i", 1)  # one topic
            + enc_str(self.topic)
            + struct.pack(">i", 1)  # one partition
            + struct.pack(">iqi", pid, st.next_offset, self.fetch_max_bytes)
        )
        c = self._leader_request(st.leader, API_FETCH, 4, body)
        c.i32()  # throttle
        records: list[tuple[int, bytes | None]] = []
        hwm = st.next_offset
        for _ in range(c.i32()):
            c.string()  # topic
            for _ in range(c.i32()):
                rpid = c.i32()
                err = c.i16()
                hwm = c.i64()
                c.i64()  # last stable offset
                n_aborted = c.i32()
                for _ in range(max(n_aborted, 0)):
                    c.i64()
                    c.i64()
                rset = c.bytes_() or b""
                if err == 1 and rpid == pid:
                    # OFFSET_OUT_OF_RANGE: the checkpoint aged out of
                    # retention — apply the reset policy
                    if self.offset_reset == "fail":
                        raise RuntimeError(
                            f"fetch p{pid}: offset {st.next_offset} out of "
                            "range and offset_reset=fail"
                        )
                    ts = TS_EARLIEST if self.offset_reset == "earliest" else TS_LATEST
                    st.next_offset = self._list_offset(pid, st, ts)
                    return [], max(hwm, st.next_offset)
                if err:
                    raise RuntimeError(f"fetch p{rpid} error {err}")
                if rpid == pid:
                    records = decode_record_batches(rset)
        return records, hwm

    def offsets(self) -> dict:
        return {pid: st.next_offset for pid, st in self._parts.items()}

    def close(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()
