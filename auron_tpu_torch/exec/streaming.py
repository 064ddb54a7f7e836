"""Streaming front end: micro-batch sources and the Calc pipeline (port of
``auron_tpu/exec/streaming.py``).

- ``StreamingCalcExec`` applies one (predicates, projections) fragment to
  every polled micro-batch through the evaluator the batch engine uses,
  the push-based drain loop of a Flink Calc operator fed by a reader;
- ``MockKafkaSource`` is a deterministic partitioned record stream with
  the Kafka startup modes (earliest, latest, offsets);
- the record deserializers (JSON, and protobuf wire format without
  generated classes) apply a skip / null / fail policy to bad records;
- ``KafkaScanExec`` is the ``kafka_scan`` plan node's operator: a source
  and a deserializer planned like any other scan, whose offsets surface
  in ``ctx.resources["<id>.offsets"]`` and in ``kafka_offset_p*`` metrics
  on every exit path (the resume point of an aborted stream).

Micro-batches reach the device through ``upload_batch`` (``Batch.from_arrow``
with strings dictionary-encoded by pyarrow). pyarrow is imported only
inside the functions that build record batches, never when this module is
imported.
"""

from __future__ import annotations

import json
import re
import sys
from dataclasses import dataclass, field
from typing import Iterator, Protocol

import numpy as np

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.basic import FilterExec, ProjectExec, batch_from_columns
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import Evaluator

# record-level error policies
ON_ERROR_SKIP = "skip"  # drop the bad record, count it
ON_ERROR_NULL = "null"  # emit an all-null row, count it
ON_ERROR_FAIL = "fail"  # raise (the task's error relay surfaces it)


class DeserializeError(Exception):
    pass


class RecordDeserializer(Protocol):
    def deserialize(self, payloads: list[bytes]): ...

    errors: int  # running count of bad records (metric source)


class _RowDeserializerBase:
    """Shared record loop: a subclass parses ONE payload into a field dict;
    the base applies the error policy and builds the Arrow columns."""

    def __init__(self, schema: T.Schema, on_error: str = ON_ERROR_SKIP):
        assert on_error in (ON_ERROR_SKIP, ON_ERROR_NULL, ON_ERROR_FAIL)
        self.schema = schema
        self.on_error = on_error
        self.errors = 0  # bad records
        self.coerce_errors = 0  # bad field values within good records

    def _parse_one(self, payload: bytes) -> dict:
        raise NotImplementedError

    def deserialize(self, payloads: list[bytes]):
        """A pyarrow RecordBatch of the payloads' rows (imports pyarrow)."""
        from auron_tpu_torch.utils.arrowlib import pyarrow

        pa = pyarrow()

        rows: list[dict | None] = []
        for p in payloads:
            try:
                rows.append(self._parse_one(p))
            except Exception as e:  # noqa: BLE001 — the policy decides
                self.errors += 1
                if self.on_error == ON_ERROR_FAIL:
                    raise DeserializeError(f"cannot deserialize record: {e}") from e
                if self.on_error == ON_ERROR_NULL:
                    rows.append(None)  # all-null row
                # skip: drop the record
        arrays = []
        for f in self.schema:
            vals = [r.get(f.name) if r is not None else None for r in rows]
            try:
                arrays.append(pa.array(vals, type=f.dtype.to_arrow()))
            except (pa.ArrowInvalid, pa.ArrowTypeError):
                coerced = []
                for v in vals:
                    try:
                        coerced.append(pa.scalar(v, type=f.dtype.to_arrow()).as_py())
                    except Exception:  # noqa: BLE001 — a bad value becomes NULL
                        self.coerce_errors += 1
                        coerced.append(None)
                arrays.append(pa.array(coerced, type=f.dtype.to_arrow()))
        return pa.RecordBatch.from_arrays(arrays, schema=self.schema.to_arrow())


#: field kinds the columnar JSON read is held to the record loop on; a
#: schema with any other kind (FLOAT32 too: its double rounding can differ)
#: always takes the loop
_COLUMNAR_KINDS = frozenset((T.TypeKind.STRING, T.TypeKind.INT32, T.TypeKind.INT64,
                             T.TypeKind.FLOAT64, T.TypeKind.BOOL))
#: a JSON escape of a UTF-16 surrogate (a pair, or a lone one json.loads keeps)
_SURROGATE_ESCAPE = re.compile(rb"\\u[dD][89a-fA-F]")
#: a NaN or infinity literal (pyarrow's parser takes Inf, -NaN, ... that
#: json.loads refuses); may match inside a string, which only costs the loop
_NONFINITE_LITERAL = re.compile(rb"[:,\[]\s*-?(?:Inf|NaN)")
#: nesting below which json.loads cannot run out of recursion
_MAX_NESTING = 256
#: doubles from which an integer literal may have been rounded (the loop
#: refuses an inexact int -> double; pyarrow's reader rounds)
_EXACT_INT_BOUND = float(1 << 53)
#: the integer literal -0 (the loop reads 0.0 into a double, the reader
#: -0.0); may match inside a string, which only costs the loop
_NEG_ZERO_INT = re.compile(rb"-0(?![.eE0-9])")
_NEG_ZERO_BITS = 1 << 63


class JsonRowDeserializer(_RowDeserializerBase):
    """JSON payloads -> Arrow rows.

    A poll is read in one columnar parse (``pyarrow.json.read_json`` over
    the payloads joined by newlines, with the schema explicit) when that
    is provably the record loop's result: every payload one object on
    one line, valid UTF-8 without NUL, no surrogate escape, no NaN or
    infinity literal, shallow nesting, no integer past ``int``'s digit
    limit, one row a payload, and every FLOAT64 value finite and below
    2^53 in magnitude (an integer literal past it the loop refuses) and
    -0.0 only where no integer literal -0 (the loop's 0.0) is. Any other
    poll, and any poll the reader refuses, goes through the record loop
    unchanged: the same rows, counters and raises, only slower.
    ``columnar_polls`` and ``loop_polls`` count the two paths."""

    def __init__(self, schema: T.Schema, on_error: str = ON_ERROR_SKIP):
        super().__init__(schema, on_error)
        self.columnar_polls = 0
        self.loop_polls = 0
        self._columnar = all(f.dtype.kind in _COLUMNAR_KINDS for f in schema)
        self._reader = None  # (Arrow schema, read options, parse options), made once

    def deserialize(self, payloads: list[bytes]):
        rb = None
        if self._columnar and payloads:
            try:
                rb = self._read_columnar(payloads)
            except Exception:  # noqa: BLE001 — the record loop decides
                rb = None
        if rb is None:
            self.loop_polls += 1
            return super().deserialize(payloads)
        self.columnar_polls += 1
        return rb

    def _read_columnar(self, payloads: list[bytes]):
        """The poll's RecordBatch from one columnar parse, or None where it
        could differ from the record loop's (a raise, the reader's refusal
        too, means the same)."""
        buf = b"\n".join(payloads)
        n = len(payloads)
        if not buf or b"\r" in buf or b"\x00" in buf or len(buf) >= 1 << 30:
            return None
        # the bytes as numpy: one pass for each guard, not a Python loop
        a = np.frombuffer(buf, np.uint8)
        nl = np.flatnonzero(a == 10)
        if len(nl) != n - 1 or a[-1] == 10:  # a payload holds a newline, or one is empty
            return None
        if not (a[0] == 123 and (a[nl + 1] == 123).all()) and not all(
                p.lstrip(b" \t").startswith(b"{") for p in payloads):
            return None
        if not buf.isascii():
            try:
                buf.decode("utf-8")  # strict: json.loads lets an encoded surrogate through
            except UnicodeDecodeError:
                return None
        if (b"\\u" in buf and _SURROGATE_ESCAPE.search(buf)) or (
                (b"Inf" in buf or b"NaN" in buf) and _NONFINITE_LITERAL.search(buf)):
            return None
        if np.count_nonzero((a == 123) | (a == 91)) - n >= _MAX_NESTING and max(
                p.count(b"{") + p.count(b"[") for p in payloads) >= _MAX_NESTING:
            return None
        digits = sys.get_int_max_str_digits()
        if digits and int(np.diff(nl, prepend=-1, append=len(buf)).max()) - 1 > digits \
                and re.search(rb"[0-9]{%d}" % (digits + 1), buf):
            return None
        from auron_tpu_torch.utils.arrowlib import pyarrow

        pa = pyarrow()
        import pyarrow.json as pj

        if self._reader is None:
            schema = self.schema.to_arrow()
            self._reader = (schema, pj.ReadOptions(use_threads=False, block_size=1 << 22),
                            pj.ParseOptions(explicit_schema=schema,
                                            unexpected_field_behavior="ignore"))
        schema, read_options, parse_options = self._reader
        tbl = pj.read_json(pa.BufferReader(buf), read_options=read_options,
                           parse_options=parse_options)
        if tbl.num_rows != n or tbl.schema.names != schema.names:
            return None
        arrays = []
        for f, col in zip(self.schema, tbl.columns):
            c = col.chunk(0) if col.num_chunks == 1 else col.combine_chunks()
            if f.dtype.kind == T.TypeKind.FLOAT64:
                v = np.asarray(c.fill_null(0.0) if c.null_count else c)
                # NaN, an infinity or a magnitude past 2^53 fails the compare
                if not np.abs(v).max() < _EXACT_INT_BOUND:
                    return None
                if (v.view(np.uint64) == _NEG_ZERO_BITS).any() and _NEG_ZERO_INT.search(buf):
                    return None
            arrays.append(c)
        return pa.RecordBatch.from_arrays(arrays, schema=schema)

    def _parse_one(self, payload: bytes) -> dict:
        obj = json.loads(payload)
        if not isinstance(obj, dict):
            raise DeserializeError(f"expected a JSON object, got {type(obj).__name__}")
        return obj


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise DeserializeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise DeserializeError("varint too long")


class ProtobufRowDeserializer(_RowDeserializerBase):
    """Decodes protobuf-encoded rows without generated classes: schema
    column i maps to message field number ``field_ids[i]`` (default i+1).
    Wire/type pairs: varint -> int8..64/bool (two's complement), sint via
    zigzag when the column is listed in ``zigzag_cols``, fixed64 ->
    double/int64, fixed32 -> float/int32, length-delimited ->
    string/binary. Missing fields are NULL; unknown fields are skipped
    (proto3 semantics)."""

    def __init__(self, schema: T.Schema, on_error: str = ON_ERROR_SKIP,
                 field_ids: list[int] | None = None,
                 zigzag_cols: set[int] | None = None):
        super().__init__(schema, on_error)
        self.field_ids = list(field_ids) if field_ids else [i + 1 for i in range(len(schema))]
        self._by_field = {fid: i for i, fid in enumerate(self.field_ids)}
        self.zigzag = zigzag_cols or set()

    def _parse_one(self, payload: bytes) -> dict:
        import struct

        out: dict = {}
        pos = 0
        buf = payload
        while pos < len(buf):
            tag, pos = _read_varint(buf, pos)
            field_no, wire = tag >> 3, tag & 7
            ci = self._by_field.get(field_no)
            f = self.schema[ci] if ci is not None else None
            if wire == 0:  # varint
                v, pos = _read_varint(buf, pos)
                if f is None:
                    continue
                if ci in self.zigzag:
                    v = (v >> 1) ^ -(v & 1)
                elif v >= 1 << 63:
                    v -= 1 << 64  # two's complement int64
                out[f.name] = bool(v) if f.dtype.kind == T.TypeKind.BOOL else v
            elif wire == 1:  # fixed64
                if pos + 8 > len(buf):
                    raise DeserializeError("truncated fixed64")
                raw = buf[pos:pos + 8]
                pos += 8
                if f is None:
                    continue
                out[f.name] = (struct.unpack("<d", raw)[0] if f.dtype.is_float
                               else struct.unpack("<q", raw)[0])
            elif wire == 2:  # length-delimited
                n, pos = _read_varint(buf, pos)
                if pos + n > len(buf):
                    raise DeserializeError("truncated length-delimited field")
                raw = buf[pos:pos + n]
                pos += n
                if f is None:
                    continue
                out[f.name] = raw if f.dtype.kind == T.TypeKind.BINARY else raw.decode("utf-8")
            elif wire == 5:  # fixed32
                if pos + 4 > len(buf):
                    raise DeserializeError("truncated fixed32")
                raw = buf[pos:pos + 4]
                pos += 4
                if f is None:
                    continue
                out[f.name] = (struct.unpack("<f", raw)[0] if f.dtype.is_float
                               else struct.unpack("<i", raw)[0])
            else:
                raise DeserializeError(f"unsupported wire type {wire}")
        return out


def upload_batch(rb, device, conf=None) -> Batch:
    """A deserialized micro-batch on ``device``: ``Batch.from_arrow`` with
    each plain STRING column dictionary-encoded by pyarrow first, so the
    ingest takes its codes and vocabulary as they are (the same codes and
    first-occurrence vocabulary it would build from the strings)."""
    from auron_tpu_torch.utils.arrowlib import pyarrow

    pa = pyarrow()
    if any(t == pa.string() for t in rb.schema.types):
        import pyarrow.compute as pc

        cols = [pc.dictionary_encode(c) if c.type == pa.string() else c for c in rb.columns]
        rb = pa.RecordBatch.from_arrays(cols, schema=pa.schema(
            [f.with_type(c.type) for f, c in zip(rb.schema, cols)], metadata=rb.schema.metadata))
    return Batch.from_arrow(rb, device=device, conf=conf)


class StreamSource(Protocol):
    def poll(self, max_records: int) -> list[bytes] | None:
        """Next payload batch, or None when the (mock) stream is exhausted."""
        ...

    def offsets(self) -> dict:
        """Current offsets for checkpointing."""
        ...


EARLIEST = "earliest"
LATEST = "latest"
OFFSETS = "offsets"


@dataclass
class MockKafkaSource:
    """Deterministic partitioned record stream with startup modes: polls
    take each assigned partition's records in turn, up to ``max_records``.
    ``partitions`` assigns a subset (the split of one task of a parallel
    scan, as ``KafkaWireSource``'s); None assigns every partition."""

    records_per_partition: list[list[bytes]]
    startup_mode: str = EARLIEST
    start_offsets: dict = field(default_factory=dict)
    partitions: list[int] | None = None

    def __post_init__(self):
        recs = self.records_per_partition
        pids = range(len(recs)) if self.partitions is None else sorted(self.partitions)
        if self.startup_mode == EARLIEST:
            self._pos = {p: 0 for p in pids}
        elif self.startup_mode == LATEST:
            self._pos = {p: len(recs[p]) for p in pids}
        else:
            self._pos = {p: self.start_offsets.get(p, 0) for p in pids}

    def poll(self, max_records: int) -> list[bytes] | None:
        out: list[bytes] = []
        progressed = False
        for p in self._pos:
            recs = self.records_per_partition[p]
            take = min(max_records - len(out), len(recs) - self._pos[p])
            if take > 0:
                out += recs[self._pos[p]:self._pos[p] + take]
                self._pos[p] += take
                progressed = True
            if len(out) >= max_records:
                break
        if not progressed:
            return None
        return out

    def offsets(self) -> dict:
        return dict(self._pos)


def stream_calc_fused(conf) -> bool:
    """Resolve the stream.calc.fuse tri-state (auto = on)."""
    from auron_tpu_torch.utils.config import STREAM_CALC_FUSE, resolve_tri

    return resolve_tri(conf.get(STREAM_CALC_FUSE), True)


class _MicroBatchSlotSource(ExecOperator):
    """One-micro-batch-at-a-time source under a streaming Calc chain: the
    pipeline drops each deserialized batch into ``slot`` and re-drives the
    chain built above it. The chain is built once per stream and passed
    through plan/fusion.py, whose graph cache keys on (segment signature,
    capacity bucket, input shapes): a long-running stream captures once
    per key and every later micro-batch costs one replay. One slot source
    per chain, loaded and drained by the single thread pumping it."""

    def __init__(self, schema: T.Schema):
        super().__init__([], schema)
        self.slot: Batch | None = None

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        b, self.slot = self.slot, None
        if b is not None:
            yield b


def _slot_of(op: ExecOperator) -> _MicroBatchSlotSource:
    """The slot source at the bottom of a (possibly fused) Calc chain: the
    fusion pass rewrites a copy of the tree, so the slot to load is the
    copy's leaf, not the one the chain was built over."""
    while not isinstance(op, _MicroBatchSlotSource):
        (op,) = op.children
    return op


@dataclass
class StreamingCalcExec:
    """Calc (filter + project) over a record stream, micro-batch at a time:
    poll -> deserialize -> device batch -> Calc chain -> emit. Under
    stream.calc.fuse (auto = on) the chain is a real exec tree
    (_MicroBatchSlotSource -> FilterExec -> ProjectExec) passed through
    ``fuse_exec_tree``, so on the card the predicates and projections run
    as one captured graph per key; off keeps the eager per-op evaluator
    loop, bit-identically. Stateless either way: checkpointing passes
    through ``source.offsets()``."""

    source: StreamSource
    deserializer: RecordDeserializer
    in_schema: T.Schema
    predicates: list[ir.Expr]
    projections: list[tuple[ir.Expr, str]]
    max_batch_records: int = 8192
    device: str = "cuda"

    def run(self, ctx: ExecutionContext | None = None) -> Iterator[Batch]:
        ctx = ctx or ExecutionContext(device=self.device)
        try:
            yield from self._run(ctx)
        finally:
            # error counters must survive abnormal exits (fail policy, limit)
            errs = getattr(self.deserializer, "errors", 0)
            if errs:
                ctx.metrics.add("deserialize_errors", errs)

    def build_chain(self, conf) -> tuple[_MicroBatchSlotSource, ExecOperator]:
        """(slot source, Calc chain over it), fused for ``device`` when
        stream.calc.fuse resolves on. The continuous-query pipeline
        (``auron_tpu_torch/stream``) drives the same chain."""
        from auron_tpu_torch.plan.fusion import fuse_exec_tree

        plan: ExecOperator = _MicroBatchSlotSource(self.in_schema)
        if self.predicates:
            plan = FilterExec(plan, list(self.predicates))
        plan = ProjectExec(plan, [e for e, _ in self.projections],
                           [n for _, n in self.projections])
        if stream_calc_fused(conf):
            plan = fuse_exec_tree(plan, conf, self.device)
        return _slot_of(plan), plan

    def _run(self, ctx: ExecutionContext) -> Iterator[Batch]:
        if stream_calc_fused(ctx.conf):
            src, chain = self.build_chain(ctx.conf)
            ev = None
        else:
            src = chain = None
            ev = Evaluator(self.in_schema)
        while (payloads := self.source.poll(self.max_batch_records)) is not None:
            ctx.check_cancelled()
            rb = self.deserializer.deserialize(payloads)
            if rb.num_rows == 0:
                continue
            b = upload_batch(rb, self.device, ctx.conf)
            if chain is not None:
                src.slot = b
                outs = list(chain.execute(0, ctx))
            else:
                sel = b.device.sel
                for p in self.predicates:
                    cv = ev.evaluate(b, [p])[0]
                    sel = sel & cv.validity & cv.values.bool()
                vals = ev.evaluate(b, [e for e, _ in self.projections])
                outs = [batch_from_columns(vals, [n for _, n in self.projections], sel)]
            for out in outs:
                ctx.metrics.add("stream_batches", 1)
                ctx.metrics.add("stream_rows", out.num_rows())
                yield out


class KafkaScanExec(ExecOperator):
    """The kafka_scan plan node's operator: a stream source and a record
    deserializer planned like any other source. The resource under
    ``source_resource_id`` is a source, a factory ``(topic, startup_mode,
    start_offsets) -> source``, or client config bytes (a wire client,
    cached in the executor-shared store)."""

    def __init__(
        self,
        schema: T.Schema,
        topic: str,
        source_resource_id: str,
        startup_mode: str = EARLIEST,
        start_offsets: dict | None = None,
        data_format: str = "json",
        on_error: str = ON_ERROR_SKIP,
        pb_field_ids: list[int] | None = None,
        max_batch_records: int = 8192,
        zigzag_cols: set[int] | None = None,
    ):
        super().__init__([], schema)
        self.topic = topic
        self.source_resource_id = source_resource_id
        self.startup_mode = startup_mode
        self.start_offsets = start_offsets or {}
        self.data_format = data_format
        self.on_error = on_error
        self.pb_field_ids = pb_field_ids
        self.max_batch_records = max_batch_records
        self.zigzag_cols = zigzag_cols

    def _make_deserializer(self) -> RecordDeserializer:
        if self.data_format == "protobuf":
            return ProtobufRowDeserializer(self.schema, self.on_error, self.pb_field_ids,
                                           zigzag_cols=self.zigzag_cols)
        if self.data_format == "json":
            return JsonRowDeserializer(self.schema, self.on_error)
        raise ValueError(f"unsupported streaming format {self.data_format!r}")

    def _execute(self, partition: int, ctx: ExecutionContext) -> Iterator[Batch]:
        de = self._make_deserializer()  # validate the format BEFORE connecting
        provider = ctx.resources[self.source_resource_id]
        if isinstance(provider, (bytes, bytearray)):
            source = self._client_from_config(bytes(provider), partition, ctx)
        elif callable(provider):
            source = provider(self.topic, self.startup_mode, dict(self.start_offsets))
        else:
            source = provider
        try:
            while (payloads := source.poll(self.max_batch_records)) is not None:
                ctx.check_cancelled()
                with ctx.metrics.timer("deserialize_time"):
                    rb = de.deserialize(payloads)
                ctx.metrics.add("stream_batches", 1)
                if rb.num_rows:
                    yield upload_batch(rb, ctx.device, ctx.conf)
        finally:
            # an aborted stream is exactly when resume offsets matter: the
            # checkpoint state and the error count surface on every exit
            # path, the offsets also in the metric tree (a C-ABI host reads
            # only the finalize JSON)
            if de.errors:
                ctx.metrics.add("deserialize_errors", de.errors)
            offsets = source.offsets()
            ctx.resources[f"{self.source_resource_id}.offsets"] = offsets
            for pid, off in offsets.items():
                ctx.metrics.set(f"kafka_offset_p{pid}", int(off))

    def _client_from_config(self, config: bytes, partition: int, ctx: ExecutionContext):
        """Host-registered client config (``put_resource`` bytes) -> a wire
        client, cached in the executor-shared store so successive
        micro-batch tasks reuse the TCP connections and the client's own
        position (``bridge/api.remove_resource`` closes it).

        Config keys: bootstrap (required); start_offsets {pid: next}
        (overrides the plan's startup for restores); partition_assignment
        {task_index: [pids]} (a missing index is a zero split) or
        assign_mod [index, parallelism] (the round-robin split);
        offset_reset."""
        from auron_tpu_torch.exec.kafka_wire import KafkaWireSource

        store = ctx.shared if ctx.shared is not None else ctx.resources
        cache_key = f"{self.source_resource_id}.client"
        cached = store.get(cache_key)
        if cached is not None:
            return cached  # continue from the client's own position
        cfg = json.loads(config)
        assigned = cfg.get("partition_assignment")
        cfg_offsets = cfg.get("start_offsets")
        if cfg_offsets:
            mode = OFFSETS
            offsets = {int(k): int(v) for k, v in cfg_offsets.items()}
        else:
            mode = self.startup_mode
            offsets = dict(self.start_offsets)
        source = KafkaWireSource(
            cfg["bootstrap"], self.topic, mode, offsets,
            partitions=list(assigned.get(str(partition), [])) if assigned else None,
            assign_mod=tuple(cfg["assign_mod"]) if cfg.get("assign_mod") else None,
            offset_reset=cfg.get("offset_reset", "earliest"),
        )
        store[cache_key] = source
        return source
