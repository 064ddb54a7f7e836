"""Socket framing helpers of the RSS and Kafka wire clients and of their
in-process servers (port of ``auron_tpu/utils/netio.py``)."""

from __future__ import annotations

import io
import socket
import struct
import time


def read_exact(sock: socket.socket, n: int, eof_ok: bool = False) -> bytes | None:
    """Read exactly n bytes. On EOF: None when ``eof_ok`` (a clean close
    between frames), else ConnectionError (a truncated frame)."""
    buf = io.BytesIO()
    while buf.tell() < n:
        chunk = sock.recv(n - buf.tell())
        if not chunk:
            if eof_ok and buf.tell() == 0:
                return None
            raise ConnectionError(f"connection closed mid-frame ({buf.tell()}/{n})")
        buf.write(chunk)
    return buf.getvalue()


def apply_fault(conn: socket.socket, action: str | None, reply_len: int) -> bool:
    """The fault-injection seam of an in-process protocol server. Returns
    True when the fault consumed the reply (the connection is closed and
    the caller stops serving it). Actions: "drop_before" (close, no reply),
    "partial_reply" (half a length header, then close), "delay:<seconds>"
    (stall, then reply as usual)."""
    if action == "drop_before":
        conn.close()
        return True
    if action == "partial_reply":
        conn.sendall(struct.pack(">I", reply_len)[:2])
        conn.close()
        return True
    if action and action.startswith("delay:"):
        time.sleep(float(action.split(":", 1)[1]))
    return False
