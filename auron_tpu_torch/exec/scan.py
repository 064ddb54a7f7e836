"""Scans (port of ``auron_tpu/exec/scan.py``): the Parquet and ORC file
scans and ``FFIReaderExec``.

``ParquetScanExec`` and ``OrcScanExec`` decode files on the host with
pyarrow, imported inside the functions that read and never when the module
is imported. Their pruning is the reference's: row-group statistics
(``_rg_stats``, ``_pred_false_for_stats``) before any decode; then late
materialization (the predicate columns decoded first, a group or stripe
with no match skips the wide decode, a surviving one reuses the probe's
planes); then the exact arrow filter of the predicates that convert
(``pruning_to_arrow_filter``). Reads go through an optional opener in the
resource map (``fs_resource_id``, the host's file-system callback), behind
``CoalescedReadFile``'s over-read windows. Files written before a column
existed, or with narrower types, read through ``adapt_table``. Decoded
chunks of ``batch.size`` rows come onto the task's device through
``Batch.from_arrow``, the pinned staging ingest, so
``batch.ingest_stats()`` counts file scans too. A ``cuda`` task never
yields a CPU batch. The metric names are the reference's.

``FFIReaderExec`` pulls host-exported Arrow batches from the task's
resource map (reference ``scan.py:523-543``): the per-partition key
``<rid>.<partition>`` first (what a host executor registers when several
tasks of one stage share the process), then the shared ``<rid>``; a
callable exporter is called with the partition; an imported C stream
(``bridge/api.put_resource_c_stream``) is one-shot; ``Batch`` items pass
through (on the task's device: a ``cuda`` task handed a CPU batch raises);
empty batches are skipped and cancellation is checked per batch. Host
batches (``columnar/arrow_c.HostBatch``, or any object with Arrow's
``_export_to_c``, taken through the C data interface) ingest onto the
task's device (``Batch.from_host_arrow``).
"""

from __future__ import annotations

from typing import Iterator

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar import arrow_c
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.device import resolve_device
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.utils.config import (
    IGNORE_CORRUPTED_FILES,
    PARQUET_LATE_MATERIALIZATION,
    PARQUET_MAX_OVER_READ_SIZE,
)


def pruning_to_arrow_filter(e: ir.Expr, schema: T.Schema):
    """A pruning predicate subtree as a pyarrow dataset expression, or None
    for a shape that does not convert (pruning is best-effort; the exact
    filter is the plan's FilterExec, as in the reference's pushdown
    toggles, parquet_exec.rs:172-197)."""
    import pyarrow.compute as pc

    if isinstance(e, ir.BinaryOp):
        if e.op in ("and", "or"):
            left = pruning_to_arrow_filter(e.left, schema)
            right = pruning_to_arrow_filter(e.right, schema)
            if left is None or right is None:
                # an AND keeps the side that converts; an OR of a side that
                # does not convert prunes nothing
                return (left if right is None else right) if e.op == "and" else None
            return (left & right) if e.op == "and" else (left | right)
        ops = ("eq", "neq", "lt", "lteq", "gt", "gteq")
        if e.op in ops and isinstance(e.left, ir.Column) and isinstance(e.right, ir.Literal):
            f = pc.field(schema[e.left.index].name)
            v = e.right.value
            if v is None:
                return None
            return {"eq": f == v, "neq": f != v, "lt": f < v, "lteq": f <= v, "gt": f > v,
                    "gteq": f >= v}[e.op]
    if isinstance(e, ir.IsNotNull) and isinstance(e.child, ir.Column):
        return pc.field(schema[e.child.index].name).is_valid()
    if isinstance(e, ir.In) and isinstance(e.child, ir.Column) and not e.negated:
        items = [i for i in e.items if i is not None]
        if items:
            return pc.field(schema[e.child.index].name).isin(items)
    return None


class CoalescedReadFile:
    """File-like wrapper that serves small reads from over-read windows.

    Parquet metadata and page reads are many tiny ranges; through a
    remote-FS opener each would be one host round trip. Reads are served
    from window-aligned cached chunks (``parquet.max.over.read.size``), the
    reference's read coalescing (scan/internal_file_reader.rs:47-52,
    conf.rs:44)."""

    _MAX_CACHED_CHUNKS = 4  # footer + dictionary + current data window(s)

    def __init__(self, raw, window: int):
        self._raw = raw
        self._window = max(window, 1 << 16)
        raw.seek(0, 2)
        self._size = raw.tell()
        self._pos = 0
        self._chunks: dict[int, bytes] = {}  # insertion-ordered LRU
        self.raw_reads = 0
        self.bytes_fetched = 0
        self.closed = False

    # -- the python file protocol (what pyarrow needs) --

    def readable(self):
        return True

    def seekable(self):
        return True

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        else:
            self._pos = self._size + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def size(self) -> int:
        return self._size

    def _chunk(self, idx: int) -> bytes:
        c = self._chunks.pop(idx, None)
        if c is None:
            start = idx * self._window
            want = min(self._window, self._size - start)
            self._raw.seek(start)
            parts = []
            got = 0
            while got < want:  # the io protocol permits short reads
                piece = self._raw.read(want - got)
                if not piece:
                    break
                parts.append(piece)
                got += len(piece)
            c = b"".join(parts)
            self.raw_reads += 1
            self.bytes_fetched += len(c)
            # a bounded cache: whole-file residency would defeat the point
            while len(self._chunks) >= self._MAX_CACHED_CHUNKS:
                self._chunks.pop(next(iter(self._chunks)))
        self._chunks[idx] = c  # (re)inserted as the most recent
        return c

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self._size - self._pos
        n = max(0, min(n, self._size - self._pos))
        out = bytearray()
        while n > 0:
            idx, ofs = divmod(self._pos, self._window)
            c = self._chunk(idx)
            take = min(n, len(c) - ofs)
            if take <= 0:
                break
            out += c[ofs:ofs + take]
            self._pos += take
            n -= take
        return bytes(out)

    def close(self) -> None:
        self.closed = True
        if hasattr(self._raw, "close"):
            self._raw.close()


def _rg_stats(md_rg, name_to_idx) -> dict:
    """{column name: (min, max, null_count, num_values)} where statistics
    exist."""
    out = {}
    for name, j in name_to_idx.items():
        cc = md_rg.column(j)
        st = cc.statistics
        if st is None:
            continue
        mn = st.min if st.has_min_max else None
        mx = st.max if st.has_min_max else None
        nc = st.null_count if st.has_null_count else None
        out[name] = (mn, mx, nc, cc.num_values)
    return out


def _pred_false_for_stats(e: ir.Expr, schema: T.Schema, stats: dict) -> bool:
    """True when the row-group statistics prove that the predicate matches
    no row: the skip decision of the reference's row-group pruning
    (parquet_exec.rs:172-197)."""
    if isinstance(e, ir.BinaryOp):
        if e.op == "and":
            return (_pred_false_for_stats(e.left, schema, stats)
                    or _pred_false_for_stats(e.right, schema, stats))
        if e.op == "or":
            return (_pred_false_for_stats(e.left, schema, stats)
                    and _pred_false_for_stats(e.right, schema, stats))
        if (e.op in ("eq", "lt", "lteq", "gt", "gteq") and isinstance(e.left, ir.Column)
                and isinstance(e.right, ir.Literal) and e.right.value is not None):
            st = stats.get(schema[e.left.index].name)
            if st is None or st[0] is None or st[1] is None:
                return False
            mn, mx = st[0], st[1]
            v = e.right.value
            try:
                if e.op == "eq":
                    return v < mn or v > mx
                if e.op == "lt":
                    return mn >= v
                if e.op == "lteq":
                    return mn > v
                if e.op == "gt":
                    return mx <= v
                return mx < v  # gteq
            except TypeError:
                return False  # incomparable statistic types: never skip
    if isinstance(e, ir.IsNotNull) and isinstance(e.child, ir.Column):
        st = stats.get(schema[e.child.index].name)
        # num_values counts every value with the NULLs: an all-NULL group
        return st is not None and st[2] is not None and st[2] == st[3]
    if isinstance(e, ir.In) and isinstance(e.child, ir.Column) and not e.negated:
        st = stats.get(schema[e.child.index].name)
        if st is None or st[0] is None or st[1] is None:
            return False
        mn, mx = st[0], st[1]
        try:
            return (all(i is not None and (i < mn or i > mx) for i in e.items)
                    and not any(i is None for i in e.items))
        except TypeError:
            return False
    return False


def adapt_table(tbl, want):
    """Schema adaption (the reference's AuronSchemaAdapterFactory): the
    file's table projected onto the requested pyarrow schema ``want``;
    columns missing from the file become NULL, compatible physical types
    widen through a cast (an int32 file read as an int64 column).
    Incompatible columns raise."""
    import pyarrow as pa

    arrays = []
    for f in want:
        if f.name in tbl.column_names:
            c = tbl.column(f.name)
            if c.type != f.type:
                c = c.cast(f.type)  # widening and safe casts only
            arrays.append(c)
        else:
            arrays.append(pa.nulls(tbl.num_rows, type=f.type))
    return pa.Table.from_arrays(arrays, schema=want)


def _assemble_probed(want, pred_cols: list[int], ptbl, rtbl):
    """The full-schema table from the late-materialization probe's already
    decoded predicate columns (``ptbl``, adapted to the target types) and
    the decode of the rest (``rtbl``: only the non-predicate columns the
    file has, or None): a surviving group or stripe decodes no predicate
    column twice. Casts and NULL fills go through ``adapt_table``."""
    import pyarrow as pa

    pred_pos = {i: j for j, i in enumerate(pred_cols)}
    rest_fields = [f for i, f in enumerate(want) if i not in pred_pos]
    rest = None
    if rest_fields:
        rest = (adapt_table(rtbl, pa.schema(rest_fields)) if rtbl is not None else
                pa.Table.from_arrays([pa.nulls(ptbl.num_rows, type=f.type)
                                      for f in rest_fields], schema=pa.schema(rest_fields)))
    arrays = [ptbl.column(pred_pos[i]) if i in pred_pos else rest.column(f.name)
              for i, f in enumerate(want)]
    return pa.Table.from_arrays(arrays, schema=want)


def _pred_columns(preds: list[ir.Expr]) -> set[int]:
    out: set[int] = set()

    def rec(e: ir.Expr) -> None:
        if isinstance(e, ir.Column):
            out.add(e.index)
        for c in e.children():
            rec(c)

    for p in preds:
        rec(p)
    return out


def _arrow_filter(preds: list[ir.Expr], schema: T.Schema):
    """The AND of the predicates that convert, or None."""
    filt = None
    for p in preds:
        f = pruning_to_arrow_filter(p, schema)
        if f is not None:
            filt = f if filt is None else (filt & f)
    return filt


def _upload(tbl, ctx: ExecutionContext, dev) -> Iterator[Batch]:
    """A decoded table onto the task's device in chunks of ``batch.size``
    rows."""
    bs = ctx.batch_size()
    for i in range(0, tbl.num_rows, bs):
        chunk = tbl.slice(i, bs).combine_chunks()
        if chunk.num_rows:
            with ctx.metrics.timer("upload_time"):
                b = Batch.from_arrow(chunk.to_batches()[0], device=dev, conf=ctx.conf)
            yield b


class ParquetScanExec(ExecOperator):
    """Parquet scan (reference ``scan.py:286``): host decode with column
    projection and the three pruning tiers, device upload."""

    def __init__(self, schema: T.Schema, file_paths: list[str],
                 pruning_predicates: list[ir.Expr] | None = None,
                 fs_resource_id: str | None = None,
                 partitions: list[list[str]] | None = None):
        super().__init__([], schema)
        self.file_paths = file_paths
        self.pruning_predicates = pruning_predicates or []
        self.fs_resource_id = fs_resource_id
        # host-decided per-task placement: task p reads partitions[p]
        self.partitions = partitions or None

    def _task_files(self, partition: int) -> list[str]:
        if self.partitions is not None:
            # an over-provisioned host (more tasks than file groups) reads
            # nothing in the extra tasks; fewer tasks would drop groups,
            # which no task can see: the conversion response pins the task
            # count (task_partitions) and the host honours it
            return self.partitions[partition] if partition < len(self.partitions) else []
        return self.file_paths

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        import pyarrow as pa
        import pyarrow.parquet as pq

        cols = self.schema.names
        preds = self.pruning_predicates
        filt = _arrow_filter(preds, self.schema)
        dev = resolve_device(ctx.device)
        opener = ctx.resources.get(self.fs_resource_id) if self.fs_resource_id else None
        tolerate = ctx.conf.get(IGNORE_CORRUPTED_FILES)
        late_enabled = ctx.conf.get(PARQUET_LATE_MATERIALIZATION) and filt is not None
        pred_cols = sorted(_pred_columns(preds)) if late_enabled else []
        pred_names = [self.schema[i].name for i in pred_cols]
        want_arrow = self.schema.to_arrow()

        for path in self._task_files(partition):
            ctx.check_cancelled()
            try:
                if opener is not None:
                    src = CoalescedReadFile(opener(path), ctx.conf.get(PARQUET_MAX_OVER_READ_SIZE))
                else:
                    src = path
                with ctx.metrics.timer("io_time"):
                    pf = pq.ParquetFile(src)
            except (OSError, pa.ArrowInvalid):
                # files.ignore.corrupted (conf.rs:37): skip an unreadable input
                if tolerate:
                    ctx.metrics.add("corrupted_files_skipped", 1)
                    continue
                raise
            md = pf.metadata
            name_to_idx = {md.row_group(0).column(j).path_in_schema: j
                           for j in range(md.num_columns)} if md.num_row_groups else {}
            file_names = pf.schema_arrow.names
            ctx.metrics.add("row_groups_total", md.num_row_groups)

            for rg in range(md.num_row_groups):
                ctx.check_cancelled()
                # 1) statistics pruning before any decode
                if preds:
                    stats = _rg_stats(md.row_group(rg), name_to_idx)
                    if any(_pred_false_for_stats(p, self.schema, stats) for p in preds):
                        ctx.metrics.add("row_groups_pruned", 1)
                        continue
                # 2) late materialization: only the predicate columns first;
                #    a group with no match skips the wide decode, a surviving
                #    one reuses the probe's planes
                ptbl = None
                if late_enabled and pred_names:
                    with ctx.metrics.timer("pruning_time"):
                        present = [n for n in pred_names if n in file_names]
                        ptbl = adapt_table(pf.read_row_group(rg, columns=present),
                                           pa.schema([want_arrow.field(i) for i in pred_cols]))
                        ctx.metrics.add("bytes_scanned", ptbl.nbytes)
                        if ptbl.filter(filt).num_rows == 0:
                            ctx.metrics.add("row_groups_pruned_late", 1)
                            continue
                with ctx.metrics.timer("io_time"):
                    if ptbl is not None:
                        pred_set = set(pred_names)
                        rest = [n for n in cols if n in file_names and n not in pred_set]
                        rtbl = pf.read_row_group(rg, columns=rest) if rest else None
                        tbl = _assemble_probed(want_arrow, pred_cols, ptbl, rtbl)
                        if rtbl is not None:
                            ctx.metrics.add("bytes_scanned", rtbl.nbytes)
                    else:
                        present = [n for n in cols if n in file_names]
                        tbl = adapt_table(pf.read_row_group(rg, columns=present), want_arrow)
                        ctx.metrics.add("bytes_scanned", tbl.nbytes)
                # 3) the exact filter of the predicates that convert
                if filt is not None:
                    with ctx.metrics.timer("pruning_time"):
                        tbl = tbl.filter(filt)
                if tbl.num_rows == 0:
                    continue
                yield from _upload(tbl, ctx, dev)
            if isinstance(src, CoalescedReadFile):
                ctx.metrics.add("fs_raw_reads", src.raw_reads)
                ctx.metrics.add("fs_bytes_fetched", src.bytes_fetched)


class OrcScanExec(ExecOperator):
    """ORC scan (reference ``scan.py:425``, orc_exec.rs): host decode with
    pyarrow.orc, column projection and late materialization per stripe
    (pyarrow exposes no stripe statistics), device upload."""

    def __init__(self, schema: T.Schema, file_paths: list[str],
                 pruning_predicates: list[ir.Expr] | None = None,
                 fs_resource_id: str | None = None,
                 partitions: list[list[str]] | None = None):
        super().__init__([], schema)
        self.file_paths = file_paths
        self.pruning_predicates = pruning_predicates or []
        self.fs_resource_id = fs_resource_id
        self.partitions = partitions or None

    _task_files = ParquetScanExec._task_files

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        import pyarrow as pa
        import pyarrow.orc as orc

        cols = self.schema.names
        preds = self.pruning_predicates
        filt = _arrow_filter(preds, self.schema)
        dev = resolve_device(ctx.device)
        late_enabled = ctx.conf.get(PARQUET_LATE_MATERIALIZATION) and filt is not None
        pred_cols = sorted(_pred_columns(preds)) if late_enabled else []
        want_arrow = self.schema.to_arrow()
        opener = ctx.resources.get(self.fs_resource_id) if self.fs_resource_id else None
        for path in self._task_files(partition):
            ctx.check_cancelled()
            src = opener(path) if opener is not None else path
            with ctx.metrics.timer("io_time"):
                of = orc.ORCFile(src)
            file_names = set(of.schema.names)
            present_cols = [n for n in cols if n in file_names]
            pred_names = [self.schema[i].name for i in pred_cols
                          if self.schema[i].name in file_names]
            for stripe in range(of.nstripes):
                ctx.check_cancelled()
                # late materialization, the ORC pruning tier: the predicate
                # columns first; a stripe with no match skips the wide
                # decode, a surviving one reuses the probe's planes
                ptbl = None
                if late_enabled and pred_names:
                    with ctx.metrics.timer("pruning_time"):
                        ptbl = adapt_table(
                            pa.Table.from_batches([of.read_stripe(stripe, columns=pred_names)]),
                            pa.schema([want_arrow.field(i) for i in pred_cols]))
                        ctx.metrics.add("bytes_scanned", ptbl.nbytes)
                        if ptbl.filter(filt).num_rows == 0:
                            ctx.metrics.add("stripes_pruned_late", 1)
                            continue
                with ctx.metrics.timer("io_time"):
                    if ptbl is not None:
                        pred_set = set(pred_names)
                        rest = [n for n in present_cols if n not in pred_set]
                        rtbl = (pa.Table.from_batches([of.read_stripe(stripe, columns=rest)])
                                if rest else None)
                        tbl = _assemble_probed(want_arrow, pred_cols, ptbl, rtbl)
                        if rtbl is not None:
                            ctx.metrics.add("bytes_scanned", rtbl.nbytes)
                    else:
                        tbl = adapt_table(
                            pa.Table.from_batches([of.read_stripe(stripe, columns=present_cols)]),
                            want_arrow)
                        ctx.metrics.add("bytes_scanned", tbl.nbytes)
                if filt is not None:
                    tbl = tbl.filter(filt)
                yield from _upload(tbl, ctx, dev)


class FFIReaderExec(ExecOperator):
    """Pulls host-exported Arrow batches from the resource map."""

    def __init__(self, schema: T.Schema, resource_id: str):
        super().__init__([], schema)
        self.resource_id = resource_id

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        exporter = ctx.resources.get(f"{self.resource_id}.{partition}")
        if exporter is None:
            exporter = ctx.resources[self.resource_id]
        stream = exporter(partition) if callable(exporter) else exporter
        dev = resolve_device(ctx.device)
        for item in stream:
            ctx.check_cancelled()
            if isinstance(item, Batch):
                if item.torch_device.type != dev.type:
                    raise RuntimeError(
                        f"ffi_reader {self.resource_id!r} of a {dev.type} task yielded a "
                        f"batch on {item.torch_device}")
                yield item
                continue
            if not isinstance(item, arrow_c.HostBatch):
                item = arrow_c.import_from(item)
            if item.length:
                with ctx.metrics.timer("ingest_time"):
                    b = Batch.from_host_arrow(item, device=dev, conf=ctx.conf)
                yield b
