"""Checkpoint coordinator: atomic offsets+state snapshots for
exactly-once crash-resume (port of ``auron_tpu/stream/checkpoint.py``;
the same AUCK framing, so a checkpoint's bytes equal the reference's).

A checkpoint is ONE file written with the same attempt-commit protocol
as shuffle map outputs (`exec/shuffle/writer.py`): bytes land in a temp
path (``snapshot_tmp``), fsync, then ``os.replace`` onto the final name
— so ``latest()`` can only ever observe complete checkpoints, and a
kill mid-write leaves the previous checkpoint as the resume point
(which IS the exactly-once story: resume from the last barrier that
fully committed, truncate the sink back to its emit sequence, replay).

The content is captured **synchronously** at the barrier (the pipeline
hands finished bytes in); only the file I/O rides the coordinator
thread, so a slow disk never delays the pump and the snapshot can never
see state mutated past the barrier.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading

_MANIFEST_MAGIC = b"AUCK"


def snapshot_tmp(final_path: str) -> str:
    """Temp path of an in-progress checkpoint write (the value this
    returns reaches ``os.replace`` or ``os.unlink`` on every path)."""
    return final_path + ".inprogress"


def encode_checkpoint(sections: dict[str, bytes]) -> bytes:
    """Named byte sections behind a JSON manifest — canonical bytes for
    canonical inputs (sorted manifest keys, fixed framing)."""
    names = sorted(sections)
    manifest = json.dumps(
        {"sections": [[n, len(sections[n])] for n in names]},
        separators=(",", ":")).encode()
    out = [_MANIFEST_MAGIC, struct.pack("<I", len(manifest)), manifest]
    out += [sections[n] for n in names]
    return b"".join(out)


def decode_checkpoint(data: bytes) -> dict[str, bytes]:
    if data[:4] != _MANIFEST_MAGIC:
        raise ValueError("not a checkpoint file")
    (mlen,) = struct.unpack_from("<I", data, 4)
    manifest = json.loads(data[8:8 + mlen])
    out, off = {}, 8 + mlen
    for name, ln in manifest["sections"]:
        out[name] = data[off:off + ln]
        off += ln
    return out


class CheckpointCoordinator:
    """Writes, prunes, and recovers checkpoint files under one
    directory. ``sync=True`` performs the write inline (the
    fault-injection tests need kill points to be deterministic);
    ``sync=False`` hands finished bytes to a writer thread."""

    def __init__(self, directory: str, keep: int = 2, sync: bool = True):
        self.directory = directory
        self.keep = max(1, keep)
        self.sync = sync
        os.makedirs(directory, exist_ok=True)
        self._queue: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- write path ---------------------------------------------------------

    def path_of(self, seq: int) -> str:
        return os.path.join(self.directory, f"ckpt-{seq:010d}.bin")

    def write(self, seq: int, sections: dict[str, bytes]) -> str:
        """Commit checkpoint ``seq``. The bytes are fully captured by
        the caller at the barrier; this only moves them to disk."""
        if self._error is not None:
            raise self._error
        data = encode_checkpoint(sections)
        final = self.path_of(seq)
        if self.sync:
            self._write_one(final, data)
            self.prune()
        else:
            self._ensure_thread()
            self._queue.put((final, data))
        return final

    def _write_one(self, final: str, data: bytes) -> None:
        tmp = snapshot_tmp(final)
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, name="ckpt-coordinator",
                daemon=True)
            self._thread.start()

    def _writer_loop(self):
        try:
            while True:
                item = self._queue.get()
                if item is None:
                    return
                final, data = item
                self._write_one(final, data)
                self.prune()
        except BaseException as e:  # noqa: BLE001 — relayed to the pump: close() re-raises; a dead writer never silently drops barriers
            self._error = e

    def close(self) -> None:
        """Drain pending writes (async mode) and stop the thread."""
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=30)
        if self._error is not None:
            raise self._error

    # -- recovery -----------------------------------------------------------

    def _committed(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt-") and name.endswith(".bin"):
                out.append((int(name[5:-4]), os.path.join(self.directory, name)))
        return sorted(out)

    def latest(self) -> tuple[int, dict[str, bytes]] | None:
        """Newest complete checkpoint (seq, sections), or None."""
        files = self._committed()
        if not files:
            return None
        seq, path = files[-1]
        with open(path, "rb") as f:
            return seq, decode_checkpoint(f.read())

    def prune(self) -> None:
        """Keep the newest ``keep`` checkpoints; resume only ever reads
        the newest, the rest are operator insurance."""
        files = self._committed()
        for _, path in files[:-self.keep]:
            try:
                os.unlink(path)
            except OSError:
                pass
