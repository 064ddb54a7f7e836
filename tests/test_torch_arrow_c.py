"""The Arrow C data interface of the port (``columnar/arrow_c.py``) against
pyarrow's, and the host ingest and egress of ``columnar/batch.py``.

Every type of the port's format list, with NULLs, sliced and zero-length:
pyarrow's exported arrays and streams import into the port (and
``Batch.from_arrow``, the same ingest) equal to a reference ingest that
decodes with pyarrow and encodes with ``Batch.from_numpy``
(``torch_arrow.pyarrow_ingest``; exactly: the same codes, vocabularies,
values and validity), under ``exec.scan.zerocopy`` on and off; the port's
exports (``Batch.to_arrow``) read back in pyarrow equal to a reference
egress that builds each column with pyarrow (``torch_arrow.pyarrow_egress``;
exactly); every release callback runs exactly once. Inputs come from a
seeded numpy generator."""

import ctypes
import datetime
import decimal
import gc

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar import arrow_c as C
from auron_tpu_torch.columnar import batch as PB
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.utils.config import Configuration
from torch_arrow import (
    COLUMNS, SLICES, assert_batches_equal, columns, export, pyarrow_egress, pyarrow_ingest,
    record_batch,
)

@pytest.mark.parametrize("sl", SLICES, ids=["whole", "sliced", "empty"])
@pytest.mark.parametrize("name", COLUMNS)
def test_pyarrow_array_imports_equal_to_from_arrow(name, sl):
    """Exact: codes, vocabularies, values, validity and selection."""
    rb = record_batch(name, sl)
    want = pyarrow_ingest(rb)
    assert_batches_equal(Batch.from_arrow(rb, device="cpu"), want)
    for zc in ("on", "off"):
        got = Batch.from_host_arrow(export(rb), device="cpu",
                                    conf=Configuration({"exec.scan.zerocopy": zc}))
        assert_batches_equal(got, want)


@pytest.mark.parametrize("sl", SLICES, ids=["whole", "sliced", "empty"])
@pytest.mark.parametrize("name", COLUMNS)
def test_port_export_reads_in_pyarrow(name, sl):
    """A port batch's ``to_host_arrow`` exported through C structs reads in
    ``pa.RecordBatch._import_from_c`` equal to the reference egress (exact),
    and ``Batch.to_arrow`` gives the same batch."""
    b = Batch.from_arrow(record_batch(name, sl), device="cpu")
    arr, sch = C.ArrowArray(), C.ArrowSchema()
    C.export_batch(b.to_host_arrow(), ctypes.addressof(arr), ctypes.addressof(sch))
    got = pa.RecordBatch._import_from_c(ctypes.addressof(arr), ctypes.addressof(sch))
    assert got.to_pylist() == pyarrow_egress(b).to_pylist()
    assert got.schema.equals(b.schema.to_arrow())
    assert b.to_arrow().equals(got)


def test_whole_record_batch_round_trips_through_the_port():
    """Every column at once, sliced: pyarrow -> port C import -> host values
    equal pyarrow's ``to_pylist`` (a timestamp with a zone as naive UTC),
    -> port C export -> pyarrow equal to the slice."""
    rb = pa.RecordBatch.from_pydict(columns()).slice(11, 201)
    hb = export(rb)
    want = rb.to_pydict()
    want["tsu_tz"] = [None if x is None else x.replace(tzinfo=None) for x in want["tsu_tz"]]
    assert hb.to_pydict() == want
    arr, sch = C.ArrowArray(), C.ArrowSchema()
    C.export_batch(hb, ctypes.addressof(arr), ctypes.addressof(sch))
    back = pa.RecordBatch._import_from_c(ctypes.addressof(arr), ctypes.addressof(sch))
    assert back.equals(rb)


def test_zero_copy_counts_clean_full_planes_only():
    """With the key on, a fixed-width plane whose Arrow layout is the device
    plane's (with NULLs or not, of a full or a padded batch) is staged
    straight from the producer's buffer (``zerocopy_planes``); a plane the
    host converts (bit-packed bools) is copied either way; with the key off
    every plane is copied into an owned array first."""
    rng = np.random.default_rng(8)
    full = pa.RecordBatch.from_pydict({
        "a": pa.array(rng.integers(0, 9, 256)),
        "b": pa.array(rng.random(256), mask=rng.random(256) < 0.1),
        "c": pa.array(rng.integers(0, 9, 256).astype(np.int32)),
        "d": pa.array(rng.random(256) < 0.5)})
    counts = {}
    for zc in ("on", "off"):
        PB.reset_ingest_stats()
        got = Batch.from_host_arrow(export(full), device="cpu",
                                    conf=Configuration({"exec.scan.zerocopy": zc}))
        assert_batches_equal(got, pyarrow_ingest(full))
        counts[zc] = PB.ingest_stats()
    assert (counts["on"]["zerocopy_planes"], counts["on"]["copied_planes"]) == (3, 1)
    assert (counts["off"]["zerocopy_planes"], counts["off"]["copied_planes"]) == (0, 4)
    # values 256 x (8 + 8 + 4 + 1) bytes; the NULL column's bitmap crosses packed
    assert counts["on"]["ingest_bytes"] == 256 * 21 + 32
    assert counts["on"]["ingest_s"] > 0
    PB.reset_ingest_stats()
    Batch.from_host_arrow(export(full.slice(0, 200)), device="cpu")
    assert (PB.ingest_stats()["zerocopy_planes"], PB.ingest_stats()["copied_planes"]) == (3, 1)


def test_null_count_unknown_and_null_validity_buffer():
    """``null_count`` -1 with a bitmap, and a NULL validity buffer."""
    vals = np.arange(40, dtype=np.int64)
    bitmap = np.packbits(np.arange(40) % 3 != 0, bitorder="little")
    arr = pa.Array.from_buffers(pa.int64(), 40, [pa.py_buffer(bitmap), pa.py_buffer(vals)],
                                null_count=-1)
    rb = pa.RecordBatch.from_arrays([arr], ["x"])
    col = export(rb).columns[0]
    unknown = C.HostBatch(T.Schema((T.Field("x", T.INT64),)), 40,
                          (C.HostArray(col.fmt, col.dtype, 40, -1, 0, col.buffers),))
    a, sch = C.ArrowArray(), C.ArrowSchema()
    C.export_batch(unknown, ctypes.addressof(a), ctypes.addressof(sch))
    hb = C.import_batch(ctypes.addressof(a), ctypes.addressof(sch))
    assert hb.columns[0].null_count == -1
    assert hb.columns[0].nulls() == 14
    assert_batches_equal(Batch.from_host_arrow(hb, device="cpu"), pyarrow_ingest(rb))
    a, sch = C.ArrowArray(), C.ArrowSchema()
    C.export_batch(unknown, ctypes.addressof(a), ctypes.addressof(sch))
    assert pa.RecordBatch._import_from_c(ctypes.addressof(a), ctypes.addressof(sch)).equals(rb)
    clean = pa.Array.from_buffers(pa.int64(), 40, [None, pa.py_buffer(vals)])
    hb = export(pa.RecordBatch.from_arrays([clean], ["x"]))
    assert hb.columns[0].buffers[0] is None and hb.columns[0].nulls() == 0
    assert hb.to_pydict()["x"] == vals.tolist()


def test_nanosecond_timestamps_and_tables_ingest():
    """A timestamp in nanoseconds ingests as microseconds (exact, whole
    microseconds), and a chunked Table through ``from_arrow`` as one batch
    of its combined chunks, equal to the pyarrow-decoded reference; pandas
    frames (``datetime64[ns]``) ingest through the same path (the port's
    timestamps are int64 microseconds)."""
    import pandas as pd

    rng = np.random.default_rng(12)
    us = rng.integers(-10**15, 10**15, 200)
    null = rng.random(200) < 0.2
    rb = pa.RecordBatch.from_pydict({
        "t": pa.array(us * 1000, pa.timestamp("ns"), mask=null),
        "x": pa.array(rng.integers(0, 9, 200))})
    want = pyarrow_ingest(rb)
    assert_batches_equal(Batch.from_host_arrow(export(rb), device="cpu"), want)
    table = pa.Table.from_batches([rb.slice(0, 70), rb.slice(70)])
    assert_batches_equal(Batch.from_arrow(table, device="cpu"), want)
    frame = pd.DataFrame({"t": pd.to_datetime(us[:50] * 1000, unit="ns"), "x": us[:50]})
    assert Batch.from_pandas(frame, device="cpu").to_pydict()["t"] == us[:50].tolist()


def test_null_type_imports_as_all_null():
    rb = pa.RecordBatch.from_arrays([pa.nulls(5), pa.array(range(5))], ["n", "x"])
    b = Batch.from_host_arrow(export(rb), device="cpu")
    assert b.schema[0].dtype == T.NULL
    assert not b.device.validity[0].any() and not b.device.values[0].any()
    assert b.to_pydict() == {"n": [None] * 5, "x": list(range(5))}


@pytest.mark.parametrize("arr", [
    pa.array([{"a": 1}, None], pa.struct([("a", pa.int64())])),
    pa.array([[("k", 1)]], pa.map_(pa.string(), pa.int64())),
], ids=["struct", "map"])
def test_map_and_struct_raise_naming_the_roadmap_item(arr):
    """MAP and STRUCT columns (ROADMAP Queue 1 item 2) import through the C
    structs and ingest: the rows come back as pyarrow gives them."""
    hb = export(pa.RecordBatch.from_arrays([arr], ["m"]))
    assert hb.columns[0].to_pylist() == arr.to_pylist()
    assert Batch.from_host_arrow(hb, device="cpu").to_pydict() == {"m": arr.to_pylist()}
    assert C.format_of(T.DataType(T.TypeKind.MAP, inner=(T.STRING, T.INT64))) == "+m"


def test_each_release_runs_exactly_once():
    """Imports: the port releases each imported array once, when its views
    are gone, and pyarrow's memory comes back. Exports: every struct of an
    exported tree is released once (by pyarrow), and nothing stays alive."""
    gc.collect()
    base_mem = pa.total_allocated_bytes()
    s0 = C.stats()
    rb = pa.RecordBatch.from_pydict(columns())
    arr, sch = C.ArrowArray(), C.ArrowSchema()
    rb._export_to_c(ctypes.addressof(arr), ctypes.addressof(sch))
    del rb
    hb = C.import_batch(ctypes.addressof(arr), ctypes.addressof(sch))
    assert not arr.release and not sch.release  # moved and released
    b = Batch.from_host_arrow(hb, device="cpu")
    s1 = C.stats()
    assert s1["arrays_imported"] - s0["arrays_imported"] == 1
    assert s1["arrays_released"] == s0["arrays_released"]  # views alive
    assert pa.total_allocated_bytes() > base_mem
    del hb
    gc.collect()
    s2 = C.stats()
    assert s2["arrays_released"] - s0["arrays_released"] == 1
    assert pa.total_allocated_bytes() == base_mem

    out = b.to_host_arrow()
    n_structs = 1 + len(out.columns) + sum(1 for c in out.columns if c.children)
    arr, sch = C.ArrowArray(), C.ArrowSchema()
    C.export_batch(out, ctypes.addressof(arr), ctypes.addressof(sch))
    assert C.stats()["exports_live"] == s2["exports_live"] + 2  # the schema and the array
    got = pa.RecordBatch._import_from_c(ctypes.addressof(arr), ctypes.addressof(sch))
    assert C.stats()["struct_releases"] - s2["struct_releases"] == n_structs  # the schema
    del got
    gc.collect()
    s3 = C.stats()
    assert s3["struct_releases"] - s2["struct_releases"] == 2 * n_structs
    assert s3["exports_live"] == s2["exports_live"]


def test_streams_both_ways_and_one_shot():
    rb = pa.RecordBatch.from_pydict(columns())
    parts = [rb.slice(0, 100), rb.slice(100, 0), rb.slice(100, 200)]
    reader = pa.RecordBatchReader.from_batches(rb.schema, parts)
    st = C.ArrowArrayStream()
    reader._export_to_c(ctypes.addressof(st))
    port = C.import_stream(ctypes.addressof(st))
    assert not st.release
    assert port.schema.names == rb.schema.names
    got = list(port)
    assert [b.length for b in got] == [100, 0, 200]
    assert list(port) == []  # one-shot
    s0 = C.stats()
    st2 = C.ArrowArrayStream()
    C.export_stream(got, ctypes.addressof(st2))
    back = pa.RecordBatchReader._import_from_c(ctypes.addressof(st2)).read_all()
    assert back.equals(pa.Table.from_batches(parts))
    del back
    gc.collect()
    assert C.stats()["exports_live"] == s0["exports_live"]
    # the port's producer read by the port's importer
    again = [b.to_pydict() for b in C.stream_of(got)]
    assert again == [b.to_pydict() for b in got]


def test_stream_producer_error_reaches_the_consumer():
    hb = export(pa.RecordBatch.from_arrays([pa.array([1, 2])], ["x"]))
    broken = C.HostBatch(hb.schema, 2, None)  # its export raises inside get_next
    st = C.ArrowArrayStream()
    C.export_stream([hb, broken], ctypes.addressof(st))
    reader = pa.RecordBatchReader._import_from_c(ctypes.addressof(st))
    reader.read_next_batch()
    with pytest.raises(OSError, match="TypeError"):
        reader.read_next_batch()


def test_host_batch_from_numpy_views_fixed_widthcolumns():
    schema = T.Schema((T.Field("a", T.INT64), T.Field("s", T.STRING), T.Field("d", T.DATE32),
                       T.Field("m", T.decimal(9, 2))))
    a = np.arange(10, dtype=np.int64)
    s = np.array([f"x{i % 3}" for i in range(10)], dtype=object)
    valid = np.arange(10) % 4 != 0
    hb = C.HostBatch.from_numpy([a, s, a.astype(np.int32), a * 7], schema,
                                [None, valid, None, valid])
    assert np.shares_memory(hb.columns[0].buffers[1], a)
    got = hb.to_pydict()
    assert got["a"] == a.tolist()
    assert got["s"] == [x if ok else None for x, ok in zip(s, valid)]
    assert got["d"] == [datetime.date(1970, 1, 1) + datetime.timedelta(days=i) for i in range(10)]
    assert got["m"] == [decimal.Decimal(7 * i).scaleb(-2) if ok else None
                        for i, ok in zip(range(10), valid)]
    want = Batch.from_numpy([a, s, a.astype(np.int32), a * 7], schema,
                            [None, valid, None, valid], device="cpu")
    assert_batches_equal(Batch.from_host_arrow(hb, device="cpu"), want)
