"""The port's Kafka wire client (``auron_tpu_torch/exec/kafka_wire.py``)
against an in-process loopback mini broker, beside the JAX package's.

Every case of ``tests/test_kafka_wire.py`` on the port. The broker is this
file's own (the reference test's, serving with the port's encoder: Metadata
v1, ListOffsets v1, Fetch v4, record batches v2), and where the
reference's client can run the same case it does, against the same broker,
with the same answer: the codec's bytes equal the reference's both ways
(CRC-32C, varints, record batches uncompressed, gzip and zstd, control
batches), and the clients read the same records and offsets (startup
modes, resume, subsets, out-of-range reset, reconnect after a dropped
connection or a partial frame). Also: a planned ``kafka_scan`` whose
resource is client config bytes builds its wire client once, caches it in
the executor-shared store, and splits the partitions by task index.
The zstd case skips without the ``zstandard`` package, as the
reference's does.
"""

import json
import socket
import struct
import threading

import pytest

from auron_tpu.exec import kafka_wire as JKW
from auron_tpu_torch import types as T
from auron_tpu_torch.exec import kafka_wire as KW

# ---------------------------------------------------------------------------
# mini broker
# ---------------------------------------------------------------------------


class MiniKafkaBroker:
    def __init__(self, topic: str, n_partitions: int = 2, codec: int = KW.CODEC_NONE,
                 fault_hook=None):
        self.topic = topic
        self.codec = codec
        # fault injection seam: fault_hook(api_key) -> None | "drop_before"
        # | "partial_reply" (truncated header then close) | "delay:<s>"
        self.fault_hook = fault_hook
        self.logs: list[list[bytes]] = [[] for _ in range(n_partitions)]
        self.starts = [0] * n_partitions  # log-start offsets (retention)
        self.fetch_chunk = 100  # records per batch in a fetch response
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.port = self.srv.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def produce(self, partition: int, values: list[bytes]) -> None:
        self.logs[partition].extend(values)

    def trim(self, partition: int, new_start: int) -> None:
        """Retention: delete records below new_start."""
        drop = new_start - self.starts[partition]
        assert 0 <= drop <= len(self.logs[partition])
        self.logs[partition] = self.logs[partition][drop:]
        self.starts[partition] = new_start

    def close(self) -> None:
        self._stop = True
        try:
            self.srv.close()
        except OSError:
            pass

    # -- serving --------------------------------------------------------

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            ).start()

    def _handle(self, conn: socket.socket):
        try:
            while True:
                hdr = self._read_exact(conn, 4)
                if hdr is None:
                    return
                (n,) = struct.unpack(">i", hdr)
                frame = self._read_exact(conn, n)
                c = KW.Cursor(frame)
                api, ver, corr = c.i16(), c.i16(), c.i32()
                c.string()  # client id
                if api == KW.API_METADATA:
                    body = self._metadata(c)
                elif api == KW.API_LIST_OFFSETS:
                    body = self._list_offsets(c)
                elif api == KW.API_FETCH:
                    body = self._fetch(c)
                else:
                    return
                resp = struct.pack(">i", corr) + body
                if self.fault_hook is not None:
                    from auron_tpu_torch.utils.netio import apply_fault

                    if apply_fault(conn, self.fault_hook(api), len(resp)):
                        return
                conn.sendall(struct.pack(">i", len(resp)) + resp)
        except (ConnectionError, OSError):
            return

    @staticmethod
    def _read_exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _metadata(self, c: KW.Cursor) -> bytes:
        n = c.i32()
        for _ in range(n):
            c.string()
        out = struct.pack(">i", 1)  # one broker
        out += struct.pack(">i", 0) + KW.enc_str("127.0.0.1")
        out += struct.pack(">i", self.port) + KW.enc_str(None)  # rack
        out += struct.pack(">i", 0)  # controller
        out += struct.pack(">i", 1)  # one topic
        out += struct.pack(">h", 0) + KW.enc_str(self.topic) + struct.pack(">b", 0)
        out += struct.pack(">i", len(self.logs))
        for pid in range(len(self.logs)):
            out += struct.pack(">hii", 0, pid, 0)
            out += struct.pack(">i", 1) + struct.pack(">i", 0)  # replicas
            out += struct.pack(">i", 1) + struct.pack(">i", 0)  # isr
        return out

    def _list_offsets(self, c: KW.Cursor) -> bytes:
        c.i32()  # replica
        reqs = []
        for _ in range(c.i32()):
            c.string()
            for _ in range(c.i32()):
                pid = c.i32()
                ts = c.i64()
                reqs.append((pid, ts))
        out = struct.pack(">i", 1) + KW.enc_str(self.topic)
        out += struct.pack(">i", len(reqs))
        for pid, ts in reqs:
            off = (
                self.starts[pid]
                if ts == KW.TS_EARLIEST
                else self.starts[pid] + len(self.logs[pid])
            )
            out += struct.pack(">ihqq", pid, 0, -1, off)
        return out

    def _fetch(self, c: KW.Cursor) -> bytes:
        c.i32()  # replica
        c.i32()  # max wait
        c.i32()  # min bytes
        c.i32()  # max bytes
        c.i8()  # isolation
        reqs = []
        for _ in range(c.i32()):
            c.string()
            for _ in range(c.i32()):
                pid = c.i32()
                off = c.i64()
                c.i32()  # partition max bytes
                reqs.append((pid, off))
        out = struct.pack(">i", 0)  # throttle
        out += struct.pack(">i", 1) + KW.enc_str(self.topic)
        out += struct.pack(">i", len(reqs))
        for pid, off in reqs:
            log = self.logs[pid]
            start = self.starts[pid]
            hwm = start + len(log)
            if off < start:
                out += struct.pack(">ihqq", pid, 1, hwm, hwm)  # out of range
                out += struct.pack(">i", 0)
                out += KW.enc_bytes(b"")
                continue
            chunk = log[off - start : off - start + self.fetch_chunk]
            rset = (
                KW.encode_record_batch(off, chunk, self.codec) if chunk else b""
            )
            out += struct.pack(">ihqq", pid, 0, hwm, hwm)
            out += struct.pack(">i", 0)  # no aborted txns
            out += KW.enc_bytes(rset)
        return out


# ---------------------------------------------------------------------------
# codec unit tests
# ---------------------------------------------------------------------------


def test_crc32c_vector():
    # the canonical Castagnoli check value, and the reference's on other bytes
    assert KW.crc32c(b"123456789") == JKW.crc32c(b"123456789") == 0xE3069283
    data = bytes(range(256)) * 7
    assert KW.crc32c(data) == JKW.crc32c(data)
    assert KW.crc32c(data[100:], KW.crc32c(data[:100])) == KW.crc32c(data)
    for v in (0, 1, 63, 64, -1, -64, -65, 300, 1 << 40, -(1 << 62)):
        assert KW.enc_varint(v) == JKW.enc_varint(v)
        assert KW.Cursor(KW.enc_varint(v)).varint() == v


@pytest.mark.parametrize("codec", [KW.CODEC_NONE, KW.CODEC_GZIP, KW.CODEC_ZSTD])
def test_record_batch_roundtrip(codec):
    if codec == KW.CODEC_ZSTD:
        # the wire codec needs the zstandard package, which an image may
        # not ship: skip as the reference's test does
        pytest.importorskip("zstandard")
    values = [f"record-{i}".encode() for i in range(37)]
    buf = KW.encode_record_batch(1000, values, codec)
    if codec != KW.CODEC_GZIP:  # gzip stamps the time into its header
        assert buf == JKW.encode_record_batch(1000, values, codec)
    want = [(1000 + i, v) for i, v in enumerate(values)]
    assert KW.decode_record_batches(buf) == JKW.decode_record_batches(buf) == want
    jbuf = JKW.encode_record_batch(1000, values, codec)
    assert KW.decode_record_batches(jbuf) == want


def test_record_batch_crc_detects_corruption():
    buf = bytearray(KW.encode_record_batch(0, [b"abc", b"def"]))
    buf[-1] ^= 0x01
    for mod in (KW, JKW):
        with pytest.raises(ValueError, match="CRC-32C"):
            mod.decode_record_batches(bytes(buf))


def test_partial_trailing_batch_skipped():
    b1 = KW.encode_record_batch(0, [b"x", b"y"])
    b2 = KW.encode_record_batch(2, [b"z"])
    cut = b1 + b2[: len(b2) - 3]
    assert KW.decode_record_batches(cut) == JKW.decode_record_batches(cut) == \
        [(0, b"x"), (1, b"y")]


# ---------------------------------------------------------------------------
# client <-> broker
# ---------------------------------------------------------------------------


@pytest.fixture()
def broker():
    b = MiniKafkaBroker("events", n_partitions=2)
    yield b
    b.close()


def _drain(src, max_records=1000):
    out = []
    while (vals := src.poll(max_records)) is not None:
        out.extend(vals)
    return out


def _both(broker, *args, **kw):
    """The port's and the reference's client on the same broker."""
    return [mod.KafkaWireSource(f"127.0.0.1:{broker.port}", *args, **kw) for mod in (KW, JKW)]


def test_earliest_consumes_all(broker):
    broker.produce(0, [f"p0-{i}".encode() for i in range(250)])
    broker.produce(1, [f"p1-{i}".encode() for i in range(120)])
    want = sorted([f"p0-{i}".encode() for i in range(250)]
                  + [f"p1-{i}".encode() for i in range(120)])
    srcs = _both(broker, "events", "earliest")
    got = [_drain(s) for s in srcs]
    assert got[0] == got[1] and sorted(got[0]) == want
    for s in srcs:
        assert s.offsets() == {0: 250, 1: 120}
        s.close()


def test_latest_skips_existing_then_sees_new(broker):
    broker.produce(0, [b"old-0", b"old-1"])
    srcs = _both(broker, "events", "latest")
    for s in srcs:
        assert s.poll(100) is None  # nothing past the latest offsets
    broker.produce(0, [b"new-0"])
    for s in srcs:
        assert s.poll(100) == [b"new-0"]
        s.close()


def test_offsets_resume_no_dup_no_loss(broker):
    broker.produce(0, [f"a{i}".encode() for i in range(40)])
    broker.produce(1, [f"b{i}".encode() for i in range(40)])
    want = sorted([f"a{i}".encode() for i in range(40)] + [f"b{i}".encode() for i in range(40)])
    src = KW.KafkaWireSource(f"127.0.0.1:{broker.port}", "events", "earliest")
    first = src.poll(30)  # partial consumption
    ckpt = src.offsets()
    src.close()
    for mod in (KW, JKW):
        src2 = mod.KafkaWireSource(f"127.0.0.1:{broker.port}", "events", "offsets",
                                   start_offsets=ckpt)
        rest = _drain(src2)
        src2.close()
        assert sorted(first + rest) == want


def test_partition_subset_assignment(broker):
    broker.produce(0, [b"keep-0"])
    broker.produce(1, [b"skip-1"])
    for s in _both(broker, "events", "earliest", partitions=[0]):
        assert _drain(s) == [b"keep-0"]
        assert s.offsets() == {0: 1}
        s.close()
    for s in _both(broker, "events", "earliest", assign_mod=(1, 2)):
        assert _drain(s) == [b"skip-1"] and s.offsets() == {1: 1}
        s.close()


def test_control_batch_advances_offset_without_data():
    """Transaction markers (attribute bit 0x20) are not user records, but
    offsets must advance past them."""
    data = KW.encode_record_batch(5, [b"user-record"])
    ctrl = bytearray(KW.encode_record_batch(6, [b"\x00\x00\x00\x00"]))
    # set the isControlBatch bit in attributes and re-CRC
    attr_pos = 8 + 4 + 4 + 1 + 4  # offset+len+epoch+magic+crc
    ctrl[attr_pos + 1] |= 0x20
    crc = KW.crc32c(bytes(ctrl[attr_pos:]))
    ctrl[attr_pos - 4: attr_pos] = struct.pack(">I", crc)
    buf = data + bytes(ctrl)
    assert KW.decode_record_batches(buf) == JKW.decode_record_batches(buf) == \
        [(5, b"user-record"), (6, None)]


def test_offset_out_of_range_resets(broker):
    broker.produce(0, [f"r{i}".encode() for i in range(30)])
    broker.produce(1, [b"other"])
    broker.trim(0, 20)  # retention deleted offsets 0-19
    # a checkpoint that predates retention: the reset policy applies
    for s in _both(broker, "events", "offsets", start_offsets={0: 5, 1: 0},
                   offset_reset="earliest"):
        got = _drain(s)
        assert sorted(got) == sorted([f"r{i}".encode() for i in range(20, 30)] + [b"other"])
        assert s.offsets()[0] == 30
        s.close()
    for s in _both(broker, "events", "offsets", start_offsets={0: 5}, partitions=[0],
                   offset_reset="fail"):
        with pytest.raises(RuntimeError, match="out of range"):
            s.poll(10)
        s.close()


def test_invalid_startup_mode_rejected(broker):
    for mod in (KW, JKW):
        with pytest.raises(ValueError, match="startup_mode"):
            mod.KafkaWireSource(f"127.0.0.1:{broker.port}", "events", "earliset")


def test_gzip_broker_batches(broker):
    broker.codec = KW.CODEC_GZIP
    broker.produce(0, [f"z{i}".encode() for i in range(64)])
    for s in _both(broker, "events", "earliest"):
        assert sorted(_drain(s)) == sorted(f"z{i}".encode() for i in range(64))
        s.close()


def test_kafka_scan_exec_with_wire_source(broker):
    """The kafka_scan operator runs against the wire client (JSON records
    -> Batch) and surfaces resume offsets, as with the mock, in both
    packages."""
    from auron_tpu import types as JT
    from auron_tpu.exec.base import ExecutionContext as JCtx
    from auron_tpu.exec.streaming import KafkaScanExec as JScan
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.streaming import KafkaScanExec

    rows = [{"k": i, "v": f"msg{i}"} for i in range(57)]
    broker.produce(0, [json.dumps(r).encode() for r in rows[:30]])
    broker.produce(1, [json.dumps(r).encode() for r in rows[30:]])

    def provider_of(mod):
        return lambda topic, startup_mode, start_offsets: mod.KafkaWireSource(
            f"127.0.0.1:{broker.port}", topic, startup_mode, start_offsets)

    schema = T.Schema((T.Field("k", T.INT64, False), T.Field("v", T.STRING, True)))
    jschema = JT.Schema((JT.Field("k", JT.INT64, False), JT.Field("v", JT.STRING, True)))
    ctx = ExecutionContext(device="cpu", resources={"kafka_src": provider_of(KW)})
    got = [r for b in KafkaScanExec(schema, "events", "kafka_src").execute(0, ctx)
           for r in zip(*b.to_pydict().values())]
    jctx = JCtx(resources={"kafka_src": provider_of(JKW)})
    want = [r for b in JScan(jschema, "events", "kafka_src").execute(0, jctx)
            for r in zip(*b.to_pydict().values())]
    assert got == want and sorted(got) == sorted((r["k"], r["v"]) for r in rows)
    assert ctx.resources["kafka_src.offsets"] == jctx.resources["kafka_src.offsets"] == \
        {0: 30, 1: 27}


def test_kafka_scan_client_from_config_is_cached_and_split(broker):
    """Client config bytes as the resource: the client an executor builds
    reads the partitions ``partition_assignment`` gives its task's index,
    and is cached in the executor-shared store, so the executor's later
    micro-batch tasks continue from the client's position;
    ``remove_resource`` closes it."""
    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.streaming import KafkaScanExec

    broker.produce(0, [json.dumps({"k": i}).encode() for i in range(5)])
    broker.produce(1, [json.dumps({"k": 100 + i}).encode() for i in range(3)])
    schema = T.Schema.of(T.Field("k", T.INT64))
    cfg = json.dumps({"bootstrap": f"127.0.0.1:{broker.port}",
                      "partition_assignment": {"0": [0], "1": [1]}}).encode()
    executors = [{"cfg": cfg}, {"cfg": cfg}]  # one shared store each
    got = {}
    for task, shared in enumerate(executors):
        ctx = ExecutionContext(device="cpu", resources={"cfg": cfg}, shared=shared)
        got[task] = [k for b in KafkaScanExec(schema, "events", "cfg").execute(task, ctx)
                     for k in b.to_pydict()["k"]]
        assert ctx.resources["cfg.offsets"] == ({0: 5} if task == 0 else {1: 3})
    assert got == {0: list(range(5)), 1: [100, 101, 102]}
    shared = executors[1]
    client = shared["cfg.client"]
    broker.produce(1, [json.dumps({"k": 103}).encode()])
    ctx = ExecutionContext(device="cpu", resources={"cfg": cfg}, shared=shared)
    assert [k for b in KafkaScanExec(schema, "events", "cfg").execute(1, ctx)
            for k in b.to_pydict()["k"]] == [103]  # the cached client's position
    assert shared["cfg.client"] is client and ctx.resources["cfg.offsets"] == {1: 4}
    api.put_resource("cfg", cfg)
    with api._lock:
        api._resources["cfg.client"] = client
    api.remove_resource("cfg")
    assert api.get_resource("cfg.client") is None and not client._conns


# ---------------------------------------------------------------------------
# network fault injection
# ---------------------------------------------------------------------------


def _faulty_run(mod, topic, n_partitions, produce, action):
    """Drain a fresh broker whose first fetch reply meets ``action``."""
    faults = {"n": 0}

    def hook(api):
        if api == KW.API_FETCH and faults["n"] == 0:
            faults["n"] += 1
            return action
        return None

    br = MiniKafkaBroker(topic, n_partitions=n_partitions, fault_hook=hook)
    try:
        for p, vals in produce.items():
            br.produce(p, vals)
        src = mod.KafkaWireSource(f"127.0.0.1:{br.port}", topic, startup_mode="earliest")
        got = []
        while True:
            recs = src.poll(100)
            if not recs:
                break
            got.extend(recs)
        src.close()
        return got, faults["n"]
    finally:
        br.close()


def test_poll_survives_broker_connection_drop():
    """The broker drops the connection before a fetch reply: the source
    reconnects once and resumes from its next offset — no duplicates, no
    gaps."""
    want = [f"m{i}".encode() for i in range(10)]
    for mod in (KW, JKW):
        got, fired = _faulty_run(mod, "faulty", 1, {0: want}, "drop_before")
        assert got == want and fired == 1  # the drop DID happen mid-stream


def test_poll_survives_partial_frame():
    """A truncated reply header fails the frame read cleanly and the
    reconnect delivers the whole stream."""
    for mod in (KW, JKW):
        got, fired = _faulty_run(mod, "halfframe", 2, {0: [b"a0", b"a1"], 1: [b"b0"]},
                                 "partial_reply")
        assert sorted(got) == [b"a0", b"a1", b"b0"] and fired == 1


def test_persistent_broker_outage_is_loud():
    """When every retry meets a dead connection the error propagates
    (reconnect is once, not forever)."""

    def hook(api):
        return "drop_before" if api == KW.API_FETCH else None

    br = MiniKafkaBroker("deadbroker", n_partitions=1, fault_hook=hook)
    try:
        br.produce(0, [b"x"])
        for mod in (KW, JKW):
            src = mod.KafkaWireSource(f"127.0.0.1:{br.port}", "deadbroker",
                                      startup_mode="earliest")
            with pytest.raises((ConnectionError, OSError)):
                src.poll(10)
            src.close()
    finally:
        br.close()
