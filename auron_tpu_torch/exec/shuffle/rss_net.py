"""The remote shuffle service over TCP: server and client (port of
``auron_tpu/exec/shuffle/rss_net.py``), the semantics of
``LocalRssService`` (attempt isolation, first commit wins, replica fan-out,
committed-only fetch) behind a framed protocol:

    frame   := u32 len | u8 opcode | body
    NEW     := shuffle_id str | map_id u32             -> attempt u64
    PUSH    := shuffle_id str | map u32 | attempt u64 | part u32 | block
    COMMIT  := shuffle_id str | map u32 | attempt u64
    ABORT   := shuffle_id str | map u32 | attempt u64
    FETCH   := shuffle_id str | part u32 | replica u64 | start u32
            -> u32 count | u8 has_more | count x (u32 len | block)
    reply   := u8 status (0 ok) | payload

A FETCH reply carries whole blocks up to ``_MAX_REPLY`` bytes (at least
one); ``has_more`` sends the client back for the blocks from ``start +
count``, so a partition's size never bounds a frame. str := u16 len + utf8;
every integer big-endian.

``RssNetServer`` is the daemon (a thread per connection over a
``LocalRssService``). ``RemotePartitionWriter`` and ``RemoteBlockProvider``
stand in for the in-process client objects: the writer goes into
``RssShuffleWriterExec`` through the resource map, the provider into
``IpcReaderExec``. The client retries an idempotent request (FETCH, COMMIT,
ABORT) once on a broken connection; a PUSH never.
"""

from __future__ import annotations

import io
import socket
import struct
import threading
import time
from typing import Iterator

from auron_tpu_torch.exec.shuffle.format import iter_block_payloads
from auron_tpu_torch.exec.shuffle.rss import LocalRssService
from auron_tpu_torch.utils.netio import apply_fault, read_exact

OP_NEW, OP_PUSH, OP_COMMIT, OP_ABORT, OP_FETCH = range(5)
_MAX_FRAME = 256 << 20  # one pushed block never exceeds this
_MAX_REPLY = 64 << 20  # a fetch pages at this budget (whole blocks)


def _enc_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


class _Cursor:
    """A reader over one request or reply frame (one per frame, one thread)."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from(">I", self.buf, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from(">Q", self.buf, self.pos)
        self.pos += 8
        return v

    def string(self) -> str:
        (n,) = struct.unpack_from(">H", self.buf, self.pos)
        self.pos += 2
        s = self.buf[self.pos: self.pos + n].decode()
        self.pos += n
        return s

    def rest(self) -> bytes:
        return self.buf[self.pos:]


class RssNetServer:
    """The TCP daemon around a ``LocalRssService``: one thread per
    connection (a connection is an executor's long-lived client).
    ``fault_hook(opcode)`` (tests) may return "drop_before",
    "partial_reply" or "delay:<seconds>" before a reply (``netio.apply_fault``)."""

    def __init__(self, service: LocalRssService | None = None, host: str = "127.0.0.1",
                 port: int = 0, fault_hook=None):
        self.service = service or LocalRssService()
        self.fault_hook = fault_hook
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind((host, port))
        self.srv.listen(64)
        self.addr = f"{self.srv.getsockname()[0]}:{self.srv.getsockname()[1]}"
        self._stop = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop = True
        try:
            self.srv.close()
        except OSError:
            pass

    def _serve(self) -> None:
        while not self._stop:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                if self._stop:
                    return
                time.sleep(0.05)  # a transient accept failure: keep serving
                continue
            try:
                threading.Thread(target=self._handle, args=(conn,), daemon=True).start()
            except Exception:  # noqa: BLE001 — no thread: shed this connection, keep accepting
                try:
                    conn.close()
                except OSError:
                    pass

    def _handle(self, conn: socket.socket) -> None:
        try:
            while True:
                hdr = read_exact(conn, 4, eof_ok=True)
                if hdr is None:
                    return
                (n,) = struct.unpack(">I", hdr)
                if n > _MAX_FRAME:
                    return
                frame = read_exact(conn, n)
                op = frame[0] if frame else -1
                try:
                    reply = self._dispatch(_Cursor(frame))
                except Exception as e:  # noqa: BLE001 — relayed to the client
                    reply = b"\x01" + f"{type(e).__name__}: {e}".encode()[:1000]
                if self.fault_hook is not None and apply_fault(conn, self.fault_hook(op),
                                                               len(reply)):
                    return
                conn.sendall(struct.pack(">I", len(reply)) + reply)
        except (ConnectionError, OSError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, c: _Cursor) -> bytes:
        op = c.u8()
        if op == OP_NEW:
            return b"\x00" + struct.pack(">Q", self.service.new_attempt(c.string(), c.u32()))
        if op == OP_PUSH:
            self.service.push(c.string(), c.u32(), c.u64(), c.u32(), c.rest())
            return b"\x00"
        if op == OP_COMMIT:
            self.service.commit(c.string(), c.u32(), c.u64())
            return b"\x00"
        if op == OP_ABORT:
            self.service.abort_attempt(c.string(), c.u32(), c.u64())
            return b"\x00"
        if op == OP_FETCH:
            shuffle_id, part, replica, start = c.string(), c.u32(), c.u64(), c.u32()
            blocks = self.service.fetch(shuffle_id, part, replica)
            body = io.BytesIO()
            sent, budget, i = 0, _MAX_REPLY, start
            # whole blocks up to the budget, at least one (an oversized
            # block still pages through)
            while i < len(blocks) and (sent == 0 or budget >= len(blocks[i]) + 4):
                body.write(struct.pack(">I", len(blocks[i])))
                body.write(blocks[i])
                budget -= len(blocks[i]) + 4
                sent += 1
                i += 1
            has_more = b"\x01" if i < len(blocks) else b"\x00"
            return b"\x00" + struct.pack(">I", sent) + has_more + body.getvalue()
        raise ValueError(f"unknown opcode {op}")


class RssNetClient:
    """One long-lived connection to the daemon; requests are framed under a
    lock (the task threads of an executor share one client)."""

    def __init__(self, addr: str, timeout_s: float = 30.0):
        host, port = addr.rsplit(":", 1)
        self.addr = addr
        self._host, self._port = host, int(port)
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection((self._host, self._port), timeout=self.timeout_s)

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def _request(self, body: bytes, retry: bool = False) -> _Cursor:
        """One framed round trip; ``retry`` reconnects once on a broken
        connection (idempotent requests only)."""
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._connect()
                    self._sock.sendall(struct.pack(">I", len(body)) + body)
                    (n,) = struct.unpack(">I", read_exact(self._sock, 4))
                    c = _Cursor(read_exact(self._sock, n))
                    if c.u8() != 0:
                        raise RuntimeError(
                            f"rss server error: {c.rest().decode(errors='replace')}")
                    return c
                except (ConnectionError, OSError):
                    self._sock = None
                    if not retry or attempt:
                        raise
        raise AssertionError("unreachable")

    def new_attempt(self, shuffle_id: str, map_id: int) -> int:
        return self._request(bytes([OP_NEW]) + _enc_str(shuffle_id)
                             + struct.pack(">I", map_id)).u64()

    def push(self, shuffle_id: str, map_id: int, attempt: int, partition: int,
             block: bytes) -> None:
        self._request(bytes([OP_PUSH]) + _enc_str(shuffle_id)
                      + struct.pack(">IQI", map_id, attempt, partition) + block)

    def commit(self, shuffle_id: str, map_id: int, attempt: int) -> None:
        self._request(bytes([OP_COMMIT]) + _enc_str(shuffle_id)
                      + struct.pack(">IQ", map_id, attempt), retry=True)

    def abort_attempt(self, shuffle_id: str, map_id: int, attempt: int) -> None:
        self._request(bytes([OP_ABORT]) + _enc_str(shuffle_id)
                      + struct.pack(">IQ", map_id, attempt), retry=True)

    def fetch(self, shuffle_id: str, partition: int, replica: int = 0) -> list[bytes]:
        out: list[bytes] = []
        while True:
            c = self._request(bytes([OP_FETCH]) + _enc_str(shuffle_id)
                              + struct.pack(">IQI", partition, replica, len(out)), retry=True)
            count, has_more = c.u32(), c.u8()
            for _ in range(count):
                (n,) = struct.unpack_from(">I", c.buf, c.pos)
                c.pos += 4
                out.append(c.buf[c.pos: c.pos + n])
                c.pos += n
            if not has_more:
                return out


class RemotePartitionWriter:
    """The network twin of ``RssPartitionWriterClient``."""

    def __init__(self, client: RssNetClient, shuffle_id: str, map_id: int):
        self.client = client
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.attempt = client.new_attempt(shuffle_id, map_id)

    def write(self, partition: int, block: bytes) -> None:
        self.client.push(self.shuffle_id, self.map_id, self.attempt, partition, block)

    def flush(self) -> None:
        self.client.commit(self.shuffle_id, self.map_id, self.attempt)

    def abort(self) -> None:
        self.client.abort_attempt(self.shuffle_id, self.map_id, self.attempt)


class RemoteBlockProvider:
    """The network twin of ``RssBlockProvider``: fetched blocks cross the
    wire and the reader boundary as bytes."""

    def __init__(self, client: RssNetClient, shuffle_id: str, replica: int = 0):
        self.client = client
        self.shuffle_id = shuffle_id
        self.replica = replica

    def iter_payloads(self, partition: int) -> Iterator[bytes]:
        for block in self.client.fetch(self.shuffle_id, partition, self.replica):
            yield from iter_block_payloads(block)
