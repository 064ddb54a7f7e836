"""Remote-shuffle-service client and in-process service (port of
``auron_tpu/exec/shuffle/rss.py``; the reference's Celeborn/Uniffle
integrations push natively written partition blocks to the service and
fetch them back per reduce partition).

``LocalRssService`` is the in-process service with the semantics the
engine depends on: per-ATTEMPT push streams (a speculative duplicate is
isolated), the first complete attempt's commit wins, committed output is
immutable, each commit fans out to every replica, and a fetch returns the
committed blocks of one reduce partition. ``RssPartitionWriterClient`` goes
into ``RssShuffleWriterExec`` through the resource map and
``RssBlockProvider`` into ``IpcReaderExec``; both move block bytes, never
decoded batches (``iter_payloads``). Called with a partition, the provider
gives that partition's pyarrow RecordBatches instead (``format.
decode_blocks``), the reference's generic consumer path. ``push_payloads``
relays a finished map output's blocks into the service as bytes.
"""

from __future__ import annotations

import struct
import threading
from collections import defaultdict
from typing import Iterator

from auron_tpu_torch.exec.shuffle.format import decode_blocks, iter_block_payloads


class LocalRssService:
    """The in-process service (one node: the replicas are copies, but the
    write path runs the real fan-out)."""

    def __init__(self, num_replicas: int = 2):
        self.num_replicas = max(1, num_replicas)
        self._lock = threading.Lock()
        # in-flight pushes, isolated per attempt:
        # (shuffle, map, attempt) -> partition -> blocks
        self._staging: dict = defaultdict(lambda: defaultdict(list))
        self._next_attempt = 0
        # committed, immutable: replica -> shuffle -> map -> partition -> blocks
        self._replicas = [defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
                          for _ in range(self.num_replicas)]
        self._committed: set[tuple[str, int]] = set()

    def new_attempt(self, shuffle_id: str, map_id: int) -> int:
        with self._lock:
            self._next_attempt += 1
            return self._next_attempt

    def push(self, shuffle_id: str, map_id: int, attempt: int, partition: int,
             block: bytes) -> None:
        with self._lock:
            self._staging[(shuffle_id, map_id, attempt)][partition].append(block)

    def abort_attempt(self, shuffle_id: str, map_id: int, attempt: int) -> None:
        with self._lock:
            self._staging.pop((shuffle_id, map_id, attempt), None)

    def commit(self, shuffle_id: str, map_id: int, attempt: int) -> None:
        """The first complete attempt wins; a later or other attempt is
        dropped, and committed output never changes."""
        with self._lock:
            staged = self._staging.pop((shuffle_id, map_id, attempt), None)
            if (shuffle_id, map_id) in self._committed or staged is None:
                return
            for rep in self._replicas:
                for part, blocks in staged.items():
                    rep[shuffle_id][map_id][part].extend(blocks)
            self._committed.add((shuffle_id, map_id))

    def fetch(self, shuffle_id: str, partition: int, replica: int = 0) -> list[bytes]:
        """The blocks of every committed map output for one reduce partition,
        in map order."""
        with self._lock:
            rep = self._replicas[replica % self.num_replicas]
            out: list[bytes] = []
            for map_id in sorted(rep[shuffle_id]):
                if (shuffle_id, map_id) in self._committed:
                    out.extend(rep[shuffle_id][map_id][partition])
            return out


class RssPartitionWriterClient:
    """The partition writer ``RssShuffleWriterExec`` pushes to: ``write``
    per block, ``flush`` commits, ``abort`` drops the attempt."""

    def __init__(self, service: LocalRssService, shuffle_id: str, map_id: int):
        self.service = service
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.attempt = service.new_attempt(shuffle_id, map_id)

    def write(self, partition: int, block: bytes) -> None:
        self.service.push(self.shuffle_id, self.map_id, self.attempt, partition, block)

    def flush(self) -> None:
        self.service.commit(self.shuffle_id, self.map_id, self.attempt)

    def abort(self) -> None:
        self.service.abort_attempt(self.shuffle_id, self.map_id, self.attempt)


def push_payloads(provider, writer, num_partitions: int, metrics=None) -> int:
    """Relay every block payload of a finished map output (any provider
    with ``iter_payloads``) into a partition writer as bytes: each payload
    re-framed with its length, no decode, so v2 blocks arrive as the file
    held them. A failed relay aborts the attempt. Returns the payloads
    pushed."""
    push = writer if callable(writer) else writer.write
    pushed = 0
    try:
        for pid in range(num_partitions):
            for payload in provider.iter_payloads(pid):
                push(pid, struct.pack("<Q", len(payload)) + payload)
                pushed += 1
        if metrics is not None:
            metrics.add("rss_push_payloads", pushed)
    except BaseException:
        if hasattr(writer, "abort"):
            try:
                writer.abort()
            except Exception:  # noqa: BLE001 — the relay's error is the one raised
                pass
        raise
    if hasattr(writer, "flush"):
        writer.flush()
    return pushed


class RssBlockProvider:
    """The reduce side's block provider over a ``LocalRssService``."""

    def __init__(self, service: LocalRssService, shuffle_id: str, replica: int = 0):
        self.service = service
        self.shuffle_id = shuffle_id
        self.replica = replica

    def __call__(self, partition: int) -> Iterator:
        """The pyarrow RecordBatches of one reduce partition, block by
        block in fetch order (pyarrow is imported here)."""
        for block in self.service.fetch(self.shuffle_id, partition, self.replica):
            yield from decode_blocks(block)

    def iter_payloads(self, partition: int) -> Iterator[bytes]:
        """The raw block payloads of one reduce partition (what the reader's
        bucketed decode takes)."""
        for block in self.service.fetch(self.shuffle_id, partition, self.replica):
            yield from iter_block_payloads(block)
