"""Shuffle writer execs (port of ``auron_tpu/exec/shuffle/writer.py``):
the local-file ``ShuffleWriterExec`` and the push-style
``RssShuffleWriterExec``.

Per batch, on the batch's device: partition ids (``partitioning.py``; K1
for a single int64 key), then ``cluster_rows``'s policy — a stable sort by
pid with dead rows given pid ``n_out`` and sorted last, per-partition
counts by a scatter-add (``writer.py:269-283``; ``torch.sort(stable=True)``
stands in for ``lax.sort``, which is no Pallas kernel). A batch from a
fused writer stage (``plan/fusion.py``) carries both in its
``_shuffle_prep`` payload, computed in the stage's program. The counts start
their copy into pinned host memory when the batch is staged; the live
prefix of the clustered rows then comes to the host, every column plane
copied into pinned memory under one event (``runtime/transfer.py``), is
sliced per partition and staged in host RAM (a dictionary column as codes
beside its batch's vocabulary, merged onto one vocabulary per block); a
partition whose staged bytes reach ``shuffle.compression.target.buf.size`` is encoded into one
block by ``block_encoder`` (``writer.py:40-49``): a v2 block under
``exec.shuffle.encoding`` (auto = on), its planes' general codec the
``fallback_codec``, or with ``=off`` a v1 block, an Arrow IPC stream
compressed with ``spill.compression.codec`` (``format.py``). ``partitioned_stream`` keeps the JAX package's
one-deep stage/finish loop (``writer.py:473-492``): batch i's host copies
are taken after batch i+1's device work was enqueued.

The commit is atomic per attempt (``writer.py:90-130``): data and index
go to attempt temp files, the data file gets the 16-byte pair trailer, the
index the same tag, and both are renamed into place.

The staging is a spillable memory consumer (``writer.py:68-87,149-244``):
the writer ``acquire``s each batch's staged bytes, and a spill encodes
every partition's staged chunks, then parks all encoded blocks in one
``.shuffle.spill`` temp file with per-partition spans. The commit writes a
partition's spilled blocks first (oldest spill first), then its resident
ones, so each partition's bytes stay contiguous. The files go on every
path out of the task, and a released staging never spills again.

``RssShuffleWriterExec`` (``writer.py:313-360``) stages the same way but
pushes each encoded block to a partition writer from the task resource map
(``writer(pid, block)`` or ``writer.write``; ``flush`` commits, ``abort``
drops the attempt on any failure): ``exec/shuffle/rss.py`` and
``rss_net.py`` give the in-process and the TCP service's clients. It counts
``push_time``, ``compress_time`` and the bytes.

Not ported: the ``obs`` spill spans.
"""

from __future__ import annotations

import os
import tempfile
import threading
import uuid
from typing import Iterator

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.shuffle.format import (
    DictCodes, data_trailer, encode_block, encode_v1_block, fallback_codec,
    shuffle_encoding_enabled, v1_codec, write_index,
)
from auron_tpu_torch.exec.shuffle.partitioning import Partitioning
from auron_tpu_torch.memory import memmgr
from auron_tpu_torch.runtime.transfer import harvest, start_host_transfer
from auron_tpu_torch.utils.config import (
    SHUFFLE_COMPRESSION_TARGET_BUF_SIZE, SHUFFLE_ENCODING_DICT_MAX,
)


def block_encoder(schema: T.Schema, conf, metrics=None):
    """THE writer-side block encoder (``writer.py:encode_shuffle_block``):
    ``cols -> block bytes``, a v2 block under ``exec.shuffle.encoding``
    (its general codec resolved once, warning once per unavailable name),
    a compressed v1 Arrow IPC block with ``=off``."""
    if shuffle_encoding_enabled(conf):
        codec, dict_max = fallback_codec(conf), conf.get(SHUFFLE_ENCODING_DICT_MAX)
        return lambda cols: encode_block(schema, cols, metrics, codec, dict_max)
    codec = v1_codec(conf)
    return lambda cols: encode_v1_block(schema, cols, codec)


def concat_chunks(schema: T.Schema, chunks: list) -> list:
    """One (values, validity or None) per column over staged chunks (a
    dictionary column's onto one vocabulary)."""
    cols = []
    for ci, f in enumerate(schema):
        planes = [c[ci][0] for c in chunks]
        vals = (DictCodes.concat(planes, f.dtype.is_nested) if f.dtype.is_dict_encoded
                else np.concatenate(planes))
        masks = [c[ci][1] for c in chunks]
        if all(m is None for m in masks):
            valid = None
        else:
            valid = np.concatenate([np.ones(len(c[ci][0]), bool) if m is None else m
                                    for c, m in zip(chunks, masks)])
        cols.append((vals, valid))
    return cols


class ShuffleWriterExec(ExecOperator):
    """Writes the child's partition stream to (data_file, index_file);
    yields nothing (the exchange reports map status to the host engine)."""

    def __init__(self, child: ExecOperator, partitioning: Partitioning, data_file: str,
                 index_file: str):
        super().__init__([child], child.schema)
        self.partitioning = partitioning
        self.data_file = data_file
        self.index_file = index_file

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        n_out = self.partitioning.num_partitions
        staging = _ShuffleStaging(n_out, self.schema, ctx)
        mm = memmgr.register(ctx, staging)
        try:
            for parts in partitioned_stream(self.child_stream(0, partition, ctx),
                                            self.partitioning, ctx):
                mm.acquire(staging, sum(_chunk_bytes(cols) for _, cols in parts))
                staging.add_all(parts)
            offsets = [0]
            with ctx.metrics.timer("write_time"):
                attempt = uuid.uuid4()
                suffix = f".attempt-{attempt.hex[:8]}"
                pair_tag = attempt.int & ((1 << 64) - 1)
                tmp_data, tmp_index = self.data_file + suffix, self.index_file + suffix
                committed = False
                try:
                    with open(tmp_data, "wb") as f:
                        for pid in range(n_out):
                            for blk in staging.blocks_of(pid):
                                f.write(blk)
                            offsets.append(f.tell())
                        f.write(data_trailer(pair_tag))
                    write_index(tmp_index, offsets, pair_tag=pair_tag)
                    os.replace(tmp_data, self.data_file)
                    os.replace(tmp_index, self.index_file)
                    committed = True
                finally:
                    if not committed:
                        for p in (tmp_data, tmp_index):
                            try:
                                os.unlink(p)
                            except OSError:
                                pass
        finally:
            mm.unregister(staging)
            staging.release()
        ctx.metrics.add("data_size", offsets[-1])
        return
        yield  # pragma: no cover — a generator with no items


def _chunk_bytes(cols) -> int:
    """Host bytes of one staged chunk: value planes plus packed validity."""
    return sum(v.nbytes + (0 if m is None else (len(m) + 7) // 8) for v, m in cols)


class _ShuffleStaging:
    """Per-partition host staging as a spillable memory consumer:
    ``staged`` raw column chunks awaiting an encode, ``regions`` encoded
    blocks in RAM, ``_spill_files`` (path, per-partition [(offset, length)])
    blocks a spill parked on disk. The manager may spill it from another
    task's thread; the lock order is manager, then this lock."""

    def __init__(self, n_out: int, schema: T.Schema, ctx: ExecutionContext):
        self.name = f"shuffle-staging-{id(self):x}"
        self.n_out = n_out
        self.schema = schema
        self.ctx = ctx
        self.target = ctx.conf.get(SHUFFLE_COMPRESSION_TARGET_BUF_SIZE)
        self.encode = block_encoder(schema, ctx.conf, ctx.metrics)
        self.staged: list[list[list]] = [[] for _ in range(n_out)]
        self.staged_bytes = [0] * n_out
        self.regions: list[list[bytes]] = [[] for _ in range(n_out)]
        self._region_bytes = 0
        self._closed = False
        self._spill_files: list[tuple[str, list[list[tuple[int, int]]]]] = []
        self._lock = threading.RLock()

    def add_all(self, parts) -> None:
        with self._lock:
            for pid, cols in parts:
                self.staged[pid].append(cols)
                self.staged_bytes[pid] += _chunk_bytes(cols)
                if self.staged_bytes[pid] >= self.target:
                    self._flush(pid)

    def _flush(self, pid: int) -> None:
        """Encode a partition's staged chunks into one block (lock held)."""
        chunks = self.staged[pid]
        if not chunks:
            return
        with self.ctx.metrics.timer("compress_time"):
            blk = self.encode(concat_chunks(self.schema, chunks))
        self.ctx.metrics.add("shuffle_bytes_raw", self.staged_bytes[pid])
        self.ctx.metrics.add("shuffle_bytes_written", len(blk))
        self.regions[pid].append(blk)
        self._region_bytes += len(blk)
        self.staged[pid], self.staged_bytes[pid] = [], 0

    def mem_used(self) -> int:
        with self._lock:
            return sum(self.staged_bytes) + self._region_bytes

    def spill(self) -> int:
        """Encode every staged chunk, park every resident block on disk."""
        with self._lock:
            # a released staging never spills: the file would outlive the task
            if self._closed:
                return 0
            freed = self.mem_used()
            if freed == 0:
                return 0
            with self.ctx.metrics.timer("spill_time"):
                for pid in range(self.n_out):
                    self._flush(pid)
                fd, path = tempfile.mkstemp(suffix=".shuffle.spill")
                spans: list[list[tuple[int, int]]] = []
                try:
                    with os.fdopen(fd, "wb") as f:
                        for pid in range(self.n_out):
                            pid_spans = []
                            for blk in self.regions[pid]:
                                pid_spans.append((f.tell(), len(blk)))
                                f.write(blk)
                            spans.append(pid_spans)
                except BaseException:
                    os.unlink(path)  # a failed write leaves no file; it raises
                    raise
                self._spill_files.append((path, spans))
                memmgr.count_spill(disk_bytes=self._region_bytes)
                self.regions = [[] for _ in range(self.n_out)]
                self._region_bytes = 0
            self.ctx.metrics.add("spilled_shuffle_runs", 1)
            return freed

    def blocks_of(self, pid: int) -> list[bytes]:
        """A partition's blocks: spilled runs first (oldest first), then the
        resident ones, after a final flush of its staged chunks."""
        with self._lock:
            self._flush(pid)
            out: list[bytes] = []
            for path, spans in self._spill_files:
                with open(path, "rb") as f:
                    for off, ln in spans[pid]:
                        f.seek(off)
                        out.append(f.read(ln))
            out.extend(self.regions[pid])
            return out

    def release(self) -> None:
        """Delete the spill files; no spill after this."""
        with self._lock:
            files, self._spill_files = self._spill_files, []
            self._closed = True
            self.staged = [[] for _ in range(self.n_out)]
            self.regions = [[] for _ in range(self.n_out)]
            self.staged_bytes, self._region_bytes = [0] * self.n_out, 0
        for path, _ in files:
            try:
                os.unlink(path)
            except OSError:
                pass


class RssShuffleWriterExec(ExecOperator):
    """Push-style shuffle writer for a remote shuffle service (reference
    ``writer.py:313-360``): blocks go to the partition writer registered
    under ``rss_resource_id`` instead of local files; yields nothing."""

    def __init__(self, child: ExecOperator, partitioning: Partitioning, rss_resource_id: str):
        super().__init__([child], child.schema)
        self.partitioning = partitioning
        self.rss_resource_id = rss_resource_id

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        writer = ctx.resources[self.rss_resource_id]
        push = writer if callable(writer) else writer.write
        n_out = self.partitioning.num_partitions
        staged: list[list] = [[] for _ in range(n_out)]
        staged_bytes = [0] * n_out
        target = ctx.conf.get(SHUFFLE_COMPRESSION_TARGET_BUF_SIZE)
        encode = block_encoder(self.schema, ctx.conf, ctx.metrics)

        def flush(pid: int) -> None:
            if not staged[pid]:
                return
            with ctx.metrics.timer("compress_time"):
                blk = encode(concat_chunks(self.schema, staged[pid]))
            ctx.metrics.add("shuffle_bytes_raw", staged_bytes[pid])
            ctx.metrics.add("shuffle_bytes_written", len(blk))
            with ctx.metrics.timer("push_time"):
                push(pid, blk)
            ctx.metrics.add("data_size", len(blk))
            staged[pid], staged_bytes[pid] = [], 0

        try:
            for parts in partitioned_stream(self.child_stream(0, partition, ctx),
                                            self.partitioning, ctx):
                for pid, cols in parts:
                    staged[pid].append(cols)
                    staged_bytes[pid] += _chunk_bytes(cols)
                    if staged_bytes[pid] >= target:
                        flush(pid)
            for pid in range(n_out):
                flush(pid)
        except BaseException:
            # a failed map attempt aborts, so the service drops what it
            # pushed (a retry then starts from a clean slate)
            if hasattr(writer, "abort"):
                try:
                    writer.abort()
                except Exception:  # noqa: BLE001 — the stream's error is the one raised
                    pass
            raise
        if hasattr(writer, "flush"):
            writer.flush()
        return
        yield  # pragma: no cover — a generator with no items


# ---------------------------------------------------------------------------
# the pid-clustering policy (writer.py:269-283) and the stage/finish loop
# ---------------------------------------------------------------------------


def cluster_rows(sel: torch.Tensor, pids: torch.Tensor, n_out: int):
    """(row order, counts[n_out + 1]): a stable sort by pid, dead rows with
    pid ``n_out`` last, counts by a scatter-add (``torch.bincount`` sizes
    its output from a host read, which a CUDA-graph capture refuses)."""
    sort_pid = torch.where(sel, pids.to(torch.int32), n_out).to(torch.int32)
    s_pid, order = torch.sort(sort_pid, stable=True)
    counts = torch.zeros(n_out + 1, dtype=torch.int64, device=sel.device)
    counts.index_add_(0, s_pid.to(torch.int64), torch.ones_like(s_pid, dtype=torch.int64))
    return order, counts


def stage_partition_batch(b: Batch, partitioning: Partitioning, ctx: ExecutionContext):
    """Dispatch half: partition ids and the clustering order, enqueued on
    the batch's device (or taken from the ``_shuffle_prep`` payload of a
    fused writer stage, which computed them in its program), and the copy of
    the counts into pinned host memory started (``runtime/transfer.py``)."""
    n_out = partitioning.num_partitions
    prep = getattr(b, "_shuffle_prep", None)
    if prep is not None and prep.n_out == n_out:
        order, counts = prep.order, prep.counts
    else:
        pids = partitioning.partition_ids(b, ctx)
        order, counts = cluster_rows(b.device.sel, pids, n_out)
    return b, order, start_host_transfer(counts)


def finish_partition_batch(staged, partitioning: Partitioning, ctx: ExecutionContext):
    """Harvest half: the counts (their copy started a batch ago), then the
    live prefix of the clustered rows, every column plane copied into
    pinned host memory under one event, sliced into [(pid, [(values,
    validity or None)])]."""
    b, order, counts_tr = staged
    n_out = partitioning.num_partitions
    (counts,) = harvest(counts_tr, ctx.metrics)
    counts = counts[:n_out]
    total = int(counts.sum())
    if total == 0:
        return []
    live = order[:total]
    planes = []
    for i in range(len(b.schema)):
        planes += [b.col_values(i)[live], b.col_validity(i)[live]]
    host = harvest(start_host_transfer(*planes), ctx.metrics)
    cols = []
    for i, f in enumerate(b.schema):
        vals, valid = host[2 * i], host[2 * i + 1]
        if f.dtype.is_dict_encoded:
            vals = DictCodes(vals, b.dicts[i])
        cols.append((vals, None if valid.all() else valid))
    out, start = [], 0
    for pid in range(n_out):
        c = int(counts[pid])
        if c:
            out.append((pid, [(v[start:start + c], None if m is None else m[start:start + c])
                              for v, m in cols]))
        start += c
    return out


def partitioned_stream(child_iter, partitioning: Partitioning, ctx: ExecutionContext):
    """One-deep stage/finish pipeline over a batch stream: batch i's host
    copies are taken once batch i+1's device work is enqueued."""
    pending = None
    for b in child_iter:
        ctx.check_cancelled()
        with ctx.metrics.timer("repart_time", count=True):
            cur = stage_partition_batch(b, partitioning, ctx)
            parts = (finish_partition_batch(pending, partitioning, ctx)
                     if pending is not None else None)
        pending = cur
        if parts is not None:
            yield parts
    if pending is not None:
        with ctx.metrics.timer("repart_time"):
            parts = finish_partition_batch(pending, partitioning, ctx)
        yield parts
