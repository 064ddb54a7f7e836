"""Sinks (port of ``auron_tpu/exec/sink.py``): the Parquet and ORC file
sinks and ``IpcWriterExec``.

``ParquetSinkExec`` (reference ``sink.py:35``, parquet_sink_exec.rs) writes
the partition's rows under ``output_path`` as ``part-<partition>.parquet``
(``compression`` prop, zstd by default; a partition with no row writes a
schema-only file). With ``partition_by`` the output is Hive-style:
``<path>/c1=v1/c2=v2/part-<partition>.parquet``, one writer per key tuple,
the partition columns dropped from the files, NULL keys under
``__HIVE_DEFAULT_PARTITION__`` and NaN keys grouped as one (Arrow's
dictionary semantics), names escaped as Hive escapes them
(``_hive_escape``). ``OrcSinkExec`` (``sink.py:158``) writes the
partition's rows as one ``part-<partition>.orc``. Both yield nothing (the
host commits the files); rows leave the device through ``Batch.to_arrow``
(pinned copies and the C data interface), timed as ``egress_time``, and
pyarrow writes them, imported inside the functions that write. Their
metrics keep the reference's names: ``rows_written``,
``partitions_written``, ``io_time``.

``IpcWriterExec`` (reference ``sink.py:193-213``) streams the partition's
non-empty batches as length-prefixed blocks into a host channel registered
in the resource map (list-like with ``.append``, or a callable). A block is
the port's v2 shuffle block (``exec/shuffle/format.encode_block``), which
the JAX package's ``decode_blocks`` reads, as the port's ``decode_block``
reads the JAX package's. ``egress_time`` covers the live rows' copy to the
host and the encode, ``encode_time`` the encode and the push.
"""

from __future__ import annotations

import os
from typing import Iterator

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.shuffle.format import encode_block, host_planes


def _arrow_batches(op: ExecOperator, partition: int, ctx: ExecutionContext):
    """The child's batches as pyarrow RecordBatches (``Batch.to_arrow``);
    ``egress_time`` covers the copies off the device and the export."""
    for b in op.child_stream(0, partition, ctx):
        with ctx.metrics.timer("egress_time"):
            rb = b.to_arrow()
        yield rb


def _hive_escape(v) -> str:
    """Hive partition-path encoding of a partition value."""
    if v is None:
        return "__HIVE_DEFAULT_PARTITION__"
    out = []
    for ch in str(v):
        # the characters Hive escapes in partition directory names
        if ch in '"#%\'*/:=?\\{}[]^' or ord(ch) < 0x20:
            out.append(f"%{ord(ch):02X}")
        else:
            out.append(ch)
    return "".join(out)


class ParquetSinkExec(ExecOperator):
    """Writes the partition stream under ``output_path``; yields nothing.
    With ``partition_by`` columns the output is Hive-style, the partition
    columns dropped from the files (reference parquet_sink_exec.rs and
    NativeParquetSinkUtils.java's dynamic partitioning)."""

    def __init__(self, child: ExecOperator, output_path: str, props: dict | None = None,
                 partition_by: list[str] | None = None):
        super().__init__([child], child.schema)
        self.output_path = output_path
        self.props = props or {}
        self.partition_by = list(partition_by or [])

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        compression = self.props.get("compression", "zstd")
        name = f"part-{partition:05d}.parquet"
        if not self.partition_by:
            os.makedirs(self.output_path, exist_ok=True)
            self._write_stream(_arrow_batches(self, partition, ctx),
                               os.path.join(self.output_path, name), self.schema.to_arrow(),
                               compression, ctx)
        else:
            self._write_partitioned(partition, name, compression, ctx)
        return
        yield  # pragma: no cover — a generator with no items

    def _write_partitioned(self, partition: int, name: str, compression: str,
                           ctx: ExecutionContext) -> None:
        """Each batch split by its partition-key tuple, one open writer per
        partition directory seen."""
        import numpy as np
        import pyarrow as pa
        import pyarrow.compute as pc
        import pyarrow.parquet as pq

        part_idx = [self.schema.names.index(c) for c in self.partition_by]
        data_idx = [i for i in range(len(self.schema)) if i not in part_idx]
        out_schema = pa.schema([self.schema.to_arrow().field(i) for i in data_idx])
        writers: dict = {}
        rows = 0
        try:
            for rb in _arrow_batches(self, partition, ctx):
                ctx.check_cancelled()
                if rb.num_rows == 0:
                    continue
                tbl = pa.Table.from_batches([rb])
                # per-column dictionary codes combined into one group id
                # (NaN keys unify through Arrow's dictionary semantics, so
                # nan != nan makes no duplicate writers)
                code_cols, dicts = [], []
                for i in part_idx:
                    enc = pc.dictionary_encode(tbl.column(i).combine_chunks())
                    code_cols.append(enc.indices.fill_null(-1).to_numpy(zero_copy_only=False)
                                     .astype(np.int64))
                    dicts.append(enc.dictionary.to_pylist())
                combo = code_cols[0].copy()
                for codes, d in zip(code_cols[1:], dicts[1:]):
                    combo = combo * (len(d) + 1) + (codes + 1)
                for gid in np.unique(combo):
                    mask = combo == gid
                    first = int(np.nonzero(mask)[0][0])
                    key = tuple(d[codes[first]] if codes[first] >= 0 else None
                                for codes, d in zip(code_cols, dicts))
                    sub = tbl.filter(pa.array(mask)).select(data_idx)
                    w = writers.get(key)
                    if w is None:
                        d = os.path.join(self.output_path,
                                         *(f"{c}={_hive_escape(v)}"
                                           for c, v in zip(self.partition_by, key)))
                        os.makedirs(d, exist_ok=True)
                        with ctx.metrics.timer("io_time"):
                            w = pq.ParquetWriter(os.path.join(d, name), out_schema,
                                                 compression=compression)
                        writers[key] = w
                    with ctx.metrics.timer("io_time"):
                        w.write_table(sub)
                    rows += sub.num_rows
        finally:
            for w in writers.values():
                w.close()
        ctx.metrics.add("rows_written", rows)
        ctx.metrics.add("partitions_written", len(writers))

    def _write_stream(self, rbs, path: str, schema, compression: str,
                      ctx: ExecutionContext) -> None:
        """The batches into one file; a stream with no row writes a
        schema-only file."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        writer = None
        rows = 0
        try:
            for rb in rbs:
                ctx.check_cancelled()
                if rb.num_rows == 0:
                    continue
                with ctx.metrics.timer("io_time"):
                    if writer is None:
                        writer = pq.ParquetWriter(path, rb.schema, compression=compression)
                    writer.write_batch(rb)
                rows += rb.num_rows
        finally:
            if writer is not None:
                writer.close()
        if writer is None:
            pq.write_table(pa.Table.from_batches([], schema=schema), path,
                           compression=compression)
        ctx.metrics.add("rows_written", rows)


class OrcSinkExec(ExecOperator):
    """ORC writer (reference orc_sink_exec.rs): the partition's rows as one
    file."""

    def __init__(self, child: ExecOperator, output_path: str, props: dict | None = None):
        super().__init__([child], child.schema)
        self.output_path = output_path
        self.props = props or {}

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        import pyarrow as pa
        import pyarrow.orc as orc

        os.makedirs(self.output_path, exist_ok=True)
        path = os.path.join(self.output_path, f"part-{partition:05d}.orc")
        tables = []
        rows = 0
        for rb in _arrow_batches(self, partition, ctx):
            ctx.check_cancelled()
            if rb.num_rows:
                tables.append(pa.Table.from_batches([rb]))
                rows += rb.num_rows
        with ctx.metrics.timer("io_time"):
            tbl = (pa.concat_tables(tables) if tables
                   else pa.Table.from_batches([], schema=self.schema.to_arrow()))
            orc.write_table(tbl, path)
        ctx.metrics.add("rows_written", rows)
        return
        yield  # pragma: no cover — a generator with no items


class IpcWriterExec(ExecOperator):
    """Streams the partition's batches as length-prefixed blocks into a host
    channel registered in the resource map (list-like with ``.append`` or
    callable)."""

    def __init__(self, child: ExecOperator, resource_id: str):
        super().__init__([child], child.schema)
        self.resource_id = resource_id

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        channel = ctx.resources[self.resource_id]
        push = channel if callable(channel) else channel.append
        for b in self.child_stream(0, partition, ctx):
            ctx.check_cancelled()
            with ctx.metrics.timer("egress_time"):
                nrows, cols = host_planes(b, ctx.metrics)
                if nrows == 0:
                    continue
                with ctx.metrics.timer("encode_time"):
                    push(encode_block(b.schema, cols))
        return
        yield  # pragma: no cover — a generator with no items
