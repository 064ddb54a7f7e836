"""Arrow IPC streams of the port (``columnar/arrow_ipc.py``) against
``pa.ipc``, both ways, over every type of the port's format list with
NULLs, sliced inputs and zero-length batches; dictionary batches and delta
dictionaries; the legacy framing; compressed bodies (lz4 frame, zstd) both
ways; the v1 (IPC) shuffle blocks of the JAX package's ``IpcWriterExec`` read by
the port's ``decode_block``. Comparisons are exact (equal rows and values).
Inputs come from a seeded numpy generator."""

import io

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu.exec.shuffle import format as jf
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar import arrow_c as C
from auron_tpu_torch.columnar import arrow_ipc as I
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exec.shuffle import format as pf
from torch_arrow import (
    COLUMNS, SLICES, assert_batches_equal, columns, export, pyarrow_ingest,
)


def _pa_stream(batches, schema, **opts) -> bytes:
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, schema, options=pa.ipc.IpcWriteOptions(**opts)) as w:
        for b in batches:
            w.write_batch(b)
    return sink.getvalue()


def _naive(d: dict) -> dict:
    """pyarrow's rows with a zoned timestamp as naive UTC (the port's value)."""
    if "tsu_tz" in d:
        d["tsu_tz"] = [None if x is None else x.replace(tzinfo=None) for x in d["tsu_tz"]]
    return d


@pytest.mark.parametrize("sl", SLICES, ids=["whole", "sliced", "empty"])
@pytest.mark.parametrize("name", COLUMNS)
def test_port_stream_opens_in_pyarrow(name, sl):
    rb = pa.RecordBatch.from_arrays([columns()[name]], [name]).slice(*sl)
    hb = export(rb)
    payload = I.write_stream([hb, hb])
    with pa.ipc.open_stream(payload) as r:
        got = r.read_all()
    assert got.num_rows == 2 * rb.num_rows
    want = rb.to_pydict()[name] * 2
    if pa.types.is_dictionary(rb.schema.field(0).type):  # written decoded
        assert got.column(0).to_pylist() == want
    else:
        assert got.schema.field(0).type == rb.schema.field(0).type
        assert got.column(0).to_pylist() == want


@pytest.mark.parametrize("sl", SLICES, ids=["whole", "sliced", "empty"])
@pytest.mark.parametrize("name", COLUMNS)
def test_pyarrow_stream_reads_in_port(name, sl):
    """Read back as host batches equal to pyarrow's rows, and ingested equal
    to the pyarrow-decoded reference ingest (codes, vocabularies, values,
    validity)."""
    rb = pa.RecordBatch.from_arrays([columns()[name]], [name]).slice(*sl)
    batches = I.read_stream(_pa_stream([rb, rb], rb.schema))
    assert len(batches) == 2
    for hb in batches:
        assert _naive(hb.to_pydict()) == _naive(rb.to_pydict())
        assert_batches_equal(Batch.from_host_arrow(hb, device="cpu"),
                             pyarrow_ingest(rb))


def test_whole_batch_both_ways_and_schema():
    rb = pa.RecordBatch.from_pydict(columns()).slice(5, 250)
    hb = export(rb)
    payload = I.write_stream([hb])
    assert I.read_stream(payload)[0].schema == hb.schema
    with pa.ipc.open_stream(payload) as r:
        got = r.read_all().to_batches()[0]
    for f in rb.schema:
        if not pa.types.is_dictionary(f.type):
            assert got.schema.field(f.name).type == f.type, f.name
    assert got.to_pylist() == rb.to_pylist()
    back = I.read_stream(_pa_stream([rb], rb.schema))[0]
    assert _naive(back.to_pydict()) == _naive(rb.to_pydict())


def test_dictionary_batches_and_deltas():
    """Dictionary messages before the batches; with deltas the dictionary
    grows between batches and earlier codes keep their entries."""
    a = pa.DictionaryArray.from_arrays(pa.array([0, 1, None, 0], pa.int32()),
                                       pa.array(["p", "q"]))
    b = pa.DictionaryArray.from_arrays(pa.array([2, 0, 3], pa.int32()),
                                       pa.array(["p", "q", "r", "s"]))
    schema = pa.schema([("d", a.type)])
    rbs = [pa.RecordBatch.from_arrays([a], schema=schema),
           pa.RecordBatch.from_arrays([b], schema=schema)]
    for deltas in (True, False):
        payload = _pa_stream(rbs, schema, emit_dictionary_deltas=deltas)
        got = I.read_stream(payload)
        assert [g.to_pydict()["d"] for g in got] == [["p", "q", None, "p"], ["r", "p", "s"]]
        assert got[1].columns[0].dictionary.to_pylist() == ["p", "q", "r", "s"]
        for g, rb in zip(got, rbs):
            assert_batches_equal(Batch.from_host_arrow(g, device="cpu"),
                                 pyarrow_ingest(rb))


def test_legacy_framing_and_zero_batches():
    rb = pa.RecordBatch.from_pydict({"x": pa.array([1, None, 3]), "s": ["a", "b", None]})
    legacy = _pa_stream([rb], rb.schema, use_legacy_format=True)
    assert I.read_stream(legacy)[0].to_pydict() == rb.to_pydict()
    empty = _pa_stream([], rb.schema)
    assert I.read_stream(empty) == []
    port_empty = I.write_stream([], T.Schema.from_arrow(rb.schema))
    with pa.ipc.open_stream(port_empty) as r:
        assert r.read_all().num_rows == 0 and r.schema.names == ["x", "s"]


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_compressed_stream_reads_and_writes(codec):
    """pyarrow's compressed stream reads in the port (a buffer stored raw,
    length -1, too), and the port's reads in pyarrow, to the same rows."""
    rb = pa.RecordBatch.from_pydict({"x": pa.array(np.arange(1000)),
                                     "s": pa.array([f"v{i % 13}" if i % 7 else None
                                                    for i in range(1000)]),
                                     "e": pa.array([None] * 1000, pa.int64())})
    payload = _pa_stream([rb], rb.schema, compression=codec)
    assert I.read_stream(payload)[0].to_pydict() == rb.to_pydict()
    port = I.write_stream([C.import_from(rb)], codec=codec)
    assert len(port) < rb.nbytes
    with pa.ipc.open_stream(port) as r:
        assert r.read_all().to_batches()[0].equals(rb)


def test_map_and_struct_streams_raise_naming_the_roadmap_item():
    """A STRUCT stream (ROADMAP Queue 1 item 2) reads: the rows pyarrow
    wrote."""
    rb = pa.RecordBatch.from_arrays([pa.array([{"a": 1}], pa.struct([("a", pa.int64())]))],
                                    ["st"])
    (hb,) = I.read_stream(_pa_stream([rb], rb.schema))
    assert hb.columns[0].to_pylist() == [{"a": 1}]


def _jax_blocks(codec: str) -> tuple[list, pa.RecordBatch]:
    """v1 blocks as the JAX package's IpcWriterExec makes them."""
    rng = np.random.default_rng(4)
    rb = pa.RecordBatch.from_pydict({
        "k": pa.array(rng.integers(0, 50, 700), mask=rng.random(700) < 0.2),
        "s": pa.array([f"t{x}" for x in rng.integers(0, 9, 700)]),
        "v": pa.array(rng.random(700))})
    conf = JConf({"spill.compression.codec": codec})
    return [jf.encode_block(rb.slice(0, 300), conf=conf),
            jf.encode_block(rb.slice(300), conf=conf)], rb


def test_reference_v1_blocks_decode_in_the_port():
    """v1 blocks, uncompressed and under the reference's default codec
    (lz4) and zstd, decode to the same rows."""
    for codec in ("none", "lz4", "zstd"):
        blocks, rb = _jax_blocks(codec)
        schema = T.Schema.from_arrow(rb.schema)
        keys, valid, strs, vals = [], [], [], []
        for blk in blocks:
            for payload in pf.iter_block_payloads(blk):
                n, ((k, m), (s, _), (v, _)) = pf.decode_block(payload, schema)
                keys.append(k)
                valid.append(np.ones(n, bool) if m is None else m)
                strs += [s.vocab[c] for c in s.codes]
                vals.append(v)
        want = rb.to_pydict()
        k, m = np.concatenate(keys), np.concatenate(valid)
        assert [int(x) if ok else None for x, ok in zip(k, m)] == want["k"], codec
        assert not k[~m].any()  # NULL lanes zeroed
        assert strs == want["s"]
        assert np.concatenate(vals).tolist() == want["v"]


def test_vocabulary_streams_write_through_the_ipc_writer():
    """The shuffle block's vocabulary streams are ``write_stream``'s."""
    vocab = np.array(["", "a", "héllo"], dtype=object)
    stream = pf.arrow_column_stream(vocab, T.STRING)
    assert I.read_stream(stream)[0].to_pydict() == {"": ["", "a", "héllo"]}
    hb = C.HostBatch.from_numpy([vocab], T.Schema((T.Field("", T.STRING, False),)))
    assert I.write_stream([hb]) == stream
