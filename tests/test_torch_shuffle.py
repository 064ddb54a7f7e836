"""The port's file shuffle against auron_tpu's: every plane encoder's bytes
(the JAX ``_encode_column`` with fallback codec none), the schema section
(read by ``pa.ipc.read_schema``), shuffle files read across the two
packages in both directions, and the loud failures (pair mismatch,
corrupt blocks, encodings outside the slice)."""

import os
import struct
import zlib

import numpy as np
import pyarrow as pa
import pytest
import torch

from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.shuffle import format as jf
from auron_tpu.exec.shuffle.partitioning import HashPartitioning as JHash
from auron_tpu.exec.shuffle.reader import IpcReaderExec as JReader
from auron_tpu.exec.shuffle.reader import MultiMapBlockProvider as JProvider
from auron_tpu.exec.shuffle.writer import ShuffleWriterExec as JWriter
from auron_tpu.exprs.ir import col as jcol
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch import types as T
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.shuffle import format as pf
from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning as PHash
from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec as PReader
from auron_tpu_torch.exec.shuffle.reader import LocalFileBlockProvider, MultiMapBlockProvider
from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec as PWriter
from auron_tpu_torch.exprs.ir import col as pcol
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import carry, jax_batch, port_schema, rows

_ARROW = {"int8": pa.int8(), "int16": pa.int16(), "int32": pa.int32(), "int64": pa.int64(),
          "float32": pa.float32(), "float64": pa.float64(), "bool": pa.bool_(),
          "date32": pa.date32(), "timestamp": pa.timestamp("us")}
_PORT = {"int8": T.INT8, "int16": T.INT16, "int32": T.INT32, "int64": T.INT64,
         "float32": T.FLOAT32, "float64": T.FLOAT64, "bool": T.BOOL, "date32": T.DATE32,
         "timestamp": T.TIMESTAMP}


def _case(name, n, rng):
    """(type, values, validity or None, expected encoding) of one case."""
    prices = np.round(rng.gamma(2.0, 25.0, n), 2)
    cases = {
        "int64_raw": ("int64", rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64), None,
                      pf.ENC_RAW),
        "int32_bitpack": ("int32", rng.integers(-100, 100, n).astype(np.int32), None,
                          pf.ENC_BITPACK),
        "int64_rle": ("int64", np.repeat(rng.integers(0, 2**40, n // 64 + 1), 64)[:n],
                      None, pf.ENC_RLE),
        "int16_nulls_bitpack": ("int16", rng.integers(-100, 100, n).astype(np.int16),
                                rng.random(n) > 0.3, pf.ENC_BITPACK),
        "int64_half_null_sparse": ("int64", rng.integers(1, 100_000, n, dtype=np.int64),
                                   np.arange(n) % 2 == 0, pf.ENC_SPARSE),
        "int64_skew_sparse": ("int64", rng.integers(1, 100_000, n, dtype=np.int64),
                              rng.random(n) > 0.85, pf.ENC_SPARSE),
        "int64_all_null": ("int64", np.zeros(n, np.int64), np.zeros(n, bool), pf.ENC_SPARSE),
        "float64_scaled": ("float64", prices, None, pf.ENC_SCALED),
        "float32_scaled": ("float32", np.round(rng.random(n) * 100, 1).astype(np.float32),
                           None, pf.ENC_SCALED),
        "float64_negzero_refuses": ("float64", np.where(np.arange(n) % 3 == 0, -0.0, prices),
                                    None, None),
        "float64_nan_refuses": ("float64", np.where(np.arange(n) % 5 == 0, np.nan, prices),
                                None, None),
        "float64_rle": ("float64", np.repeat(rng.normal(size=n // 50 + 1), 50)[:n], None,
                        pf.ENC_RLE),
        "float64_raw": ("float64", rng.normal(size=n), None, pf.ENC_RAW),
        "float64_half_null_sparse": ("float64", prices, np.arange(n) % 2 == 1, pf.ENC_SPARSE),
        "float64_nulls_scaled": ("float64", prices, rng.random(n) > 0.2, pf.ENC_SCALED),
        "bool": ("bool", rng.random(n) < 0.3, None, pf.ENC_PACKBITS),
        "bool_nulls": ("bool", rng.random(n) < 0.3, rng.random(n) > 0.6, pf.ENC_PACKBITS),
        "date32": ("date32", rng.integers(10_000, 12_000, n).astype(np.int32),
                   rng.random(n) > 0.1, pf.ENC_BITPACK),
        "timestamp": ("timestamp", rng.integers(0, 2**60, n, dtype=np.int64), None,
                      pf.ENC_RAW),
    }
    return cases[name]


_CASES = ["int64_raw", "int32_bitpack", "int64_rle", "int16_nulls_bitpack",
          "int64_half_null_sparse", "int64_skew_sparse", "int64_all_null", "float64_scaled",
          "float32_scaled", "float64_negzero_refuses", "float64_nan_refuses", "float64_rle",
          "float64_raw", "float64_half_null_sparse", "float64_nulls_scaled", "bool",
          "bool_nulls", "date32", "timestamp"]


def _arrow(typ, vals, valid):
    arr = pa.array(vals, mask=None if valid is None else ~valid)
    if typ in ("date32", "timestamp"):
        arr = arr.cast(_ARROW[typ])
    return arr


@pytest.mark.parametrize("n", [1, 1000, 4096])
@pytest.mark.parametrize("name", _CASES)
def test_column_bytes_match_reference(name, n):
    rng = np.random.default_rng(zlib.crc32(name.encode()) + n)
    typ, vals, valid, want_enc = _case(name, n, rng)
    want = jf._encode_column(_arrow(typ, vals, valid), "c", None, 4096)
    got = pf.encode_column(vals, valid, _PORT[typ])
    assert got == want
    if n >= 1000 and want_enc is not None:
        assert got[0] == want_enc, (pf.ENC_NAMES[got[0]], name)
    if name.endswith("refuses"):
        assert got[0] != pf.ENC_SCALED
    # the port's decode gives back the plane (NULL lanes zero)
    enc, vbytes, payload = got
    v = None if vbytes is None else np.unpackbits(
        np.frombuffer(vbytes, np.uint8), count=n, bitorder="little").astype(bool)
    dec = pf.decode_column(enc, payload, v, n, _PORT[typ])
    exp = np.asarray(vals, dtype=_PORT[typ].numpy_dtype())
    if v is not None:
        exp = np.where(v, exp, exp.dtype.type(0))
    np.testing.assert_array_equal(dec.view(np.uint8), exp.view(np.uint8))


def test_empty_block_and_column():
    assert pf.encode_column(np.zeros(0, np.int64), None, T.INT64) == \
        jf._encode_column(pa.array(np.zeros(0, np.int64)), "c", None, 4096)
    s = T.Schema((T.Field("a", T.INT64), T.Field("b", T.FLOAT64)))
    blk = pf.encode_block(s, [(np.zeros(0, np.int64), None), (np.zeros(0), None)])
    (payload,) = pf.iter_block_payloads(blk)
    assert pf.decode_block(payload, s)[0] == 0
    assert jf.decode_block_v2(payload).nrows == 0


_SCHEMA = T.Schema(tuple(T.Field(n, t, nl) for n, t, nl in [
    ("i8", T.INT8, True), ("i16", T.INT16, False), ("i32", T.INT32, True),
    ("i64", T.INT64, True), ("f32", T.FLOAT32, True), ("f64", T.FLOAT64, True),
    ("b", T.BOOL, True), ("d", T.DATE32, True), ("ts", T.TIMESTAMP, False),
    ("näme with spaces", T.INT64, True)]))


def test_schema_section_reads_as_arrow_schema():
    msg = pf.arrow_schema_message(_SCHEMA)
    assert len(msg) % 8 == 0
    assert pa.ipc.read_schema(pa.BufferReader(msg)).equals(_SCHEMA.to_arrow())
    empty = pf.arrow_schema_message(T.Schema(()))
    assert len(pa.ipc.read_schema(pa.BufferReader(empty))) == 0


def test_port_block_decodes_in_reference():
    rng = np.random.default_rng(9)
    n = 3000
    cols = []
    for f in _SCHEMA:
        typ = f.dtype.kind.value
        vals = (rng.integers(-50, 50, n) if typ not in ("float32", "float64", "bool")
                else (rng.random(n) < 0.5 if typ == "bool" else np.round(rng.random(n), 2)))
        cols.append((np.asarray(vals).astype(f.dtype.numpy_dtype()),
                     None if not f.nullable else rng.random(n) > 0.4))
    (payload,) = pf.iter_block_payloads(pf.encode_block(_SCHEMA, cols))
    bc = jf.decode_block_v2(payload)
    assert bc.schema.equals(_SCHEMA.to_arrow()) and bc.nrows == n
    nrows, mine = pf.decode_block(payload, _SCHEMA)
    assert nrows == n
    for (tag, vals, valid), (pv, pm) in zip(bc.cols, mine):
        assert tag == "plane"
        np.testing.assert_array_equal(vals, pv)
        assert (valid is None and pm is None) or np.array_equal(valid, pm)


# ---------------------------------------------------------------------------
# writer / reader across the two packages
# ---------------------------------------------------------------------------

_J_CONF = {"exec.shuffle.encoding.fallback.codec": "none", "batch.size": 1000}


def _inputs(seed=4, n_batches=3, n=1500):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        k = rng.integers(1, 100_000, n, dtype=np.int64)
        out.append(jax_batch(
            {"k": k, "price": np.round(rng.gamma(2.0, 25.0, n), 2),
             "q": rng.integers(1, 100, n).astype(np.int32), "flag": rng.random(n) < 0.5},
            {"k": rng.random(n) > 0.85, "q": rng.random(n) > 0.1}))
    return out


def _write(side, batches, tmp_path, n_map, n_out, tag):
    pairs = []
    for m in range(n_map):
        d, i = str(tmp_path / f"{tag}{m}.data"), str(tmp_path / f"{tag}{m}.index")
        if side == "jax":
            w = JWriter(JScan([batches], batches[0].schema), JHash([jcol(0)], n_out), d, i)
            list(w.execute(0, JCtx(conf=JConf(dict(_J_CONF)))))
        else:
            pbs = [carry(b) for b in batches]
            w = PWriter(PScan([pbs], pbs[0].schema), PHash([pcol(0)], n_out), d, i)
            list(w.execute(0, PCtx(conf=PConf(dict(_J_CONF)), device="cpu")))
        pairs.append((d, i))
    return pairs


def _read(side, pairs, schema, partition):
    if side == "jax":
        r = JReader(schema, "blocks")
        ctx = JCtx(conf=JConf(dict(_J_CONF)), resources={"blocks": JProvider(pairs)})
    else:
        r = PReader(port_schema(schema), "blocks")
        ctx = PCtx(conf=PConf(dict(_J_CONF)), resources={"blocks": MultiMapBlockProvider(pairs)},
                   device="cpu")
    return rows(list(r.execute(partition, ctx)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_read_across_packages(writer, tmp_path):
    """JAX writer -> port reader and port writer -> JAX reader: the same
    rows per partition, in the same order, as each package's own pair."""
    batches = _inputs()
    schema = batches[0].schema
    n_out = 4
    mine = _write(writer, batches, tmp_path, 2, n_out, writer)
    other = "port" if writer == "jax" else "jax"
    theirs = _write(other, batches, tmp_path, 2, n_out, other)
    total = 0
    for p in range(n_out):
        want = _read(writer, mine, schema, p)
        assert _read(other, mine, schema, p) == want
        assert _read(writer, theirs, schema, p) == want
        total += len(want)
    assert total == 2 * sum(len(rows([b])) for b in batches)


def test_block_columns_byte_identical_to_reference(tmp_path):
    """Below the flush target each partition is one block per map task, so
    the two writers' blocks match byte for byte past the schema section."""
    batches = _inputs(seed=5)
    (jd, ji), = _write("jax", batches, tmp_path, 1, 3, "j")
    (pd_, pi), = _write("port", batches, tmp_path, 1, 3, "p")
    for p in range(3):
        jp = list(LocalFileBlockProvider(jd, ji).iter_payloads(p))
        pp = list(LocalFileBlockProvider(pd_, pi).iter_payloads(p))
        assert len(jp) == len(pp) == 1
        (jslen,), (pslen,) = struct.unpack_from("<I", jp[0], 12), struct.unpack_from("<I", pp[0], 12)
        assert jp[0][:12] == pp[0][:12]
        assert jp[0][16 + jslen:] == pp[0][16 + pslen:]


def test_pair_mismatch_raises(tmp_path):
    batches = _inputs(n_batches=1, n=300)
    (d1, i1), = _write("port", batches, tmp_path, 1, 2, "a")
    (d2, i2), = _write("port", batches, tmp_path, 1, 2, "b")
    os.replace(d2, d1)  # data of attempt b beside the index of attempt a
    with pytest.raises(RuntimeError, match="pair mismatch"):
        list(LocalFileBlockProvider(d1, i1).iter_payloads(0))


def test_corrupt_blocks_raise_value_error():
    s = T.Schema((T.Field("a", T.INT64), T.Field("b", T.FLOAT64)))
    n = 200
    blk = pf.encode_block(s, [(np.arange(n, dtype=np.int64), None),
                              (np.round(np.linspace(0, 9, n), 2), np.arange(n) % 3 > 0)])
    (payload,) = pf.iter_block_payloads(blk)
    with pytest.raises(ValueError, match="overruns"):
        list(pf.iter_block_payloads(blk[:-5]))
    with pytest.raises(ValueError):
        pf.decode_block(payload[:-7], s)
    bad = bytearray(payload)
    bad[4] = 3  # block version
    with pytest.raises(ValueError, match="version"):
        pf.decode_block(bytes(bad), s)
    with pytest.raises(ValueError, match="columns"):
        pf.decode_block(payload, T.Schema((T.Field("a", T.INT64),)))


def test_reference_codec_arrow_and_v1_blocks_decode_in_the_port():
    """A JAX block with an lz4 plane (ENC_CODEC), one with a string column
    (ENC_ARROW) and a v1 IPC block, compressed and not, decode in the port
    to the JAX reader's values."""
    rng = np.random.default_rng(1)
    vals = rng.choice(np.sqrt(np.arange(2, 18)), 4096)
    rb = pa.RecordBatch.from_arrays([pa.array(vals)], names=["x"])
    blk = jf.encode_block_v2([rb], conf=JConf({"exec.shuffle.encoding.fallback.codec": "lz4"}))
    (payload,) = pf.iter_block_payloads(blk)
    assert payload[16 + struct.unpack_from("<I", payload, 12)[0]] == pf.ENC_CODEC
    n, [(got, valid)] = pf.decode_block(payload, T.Schema((T.Field("x", T.FLOAT64),)))
    assert n == 4096 and valid is None
    np.testing.assert_array_equal(got, vals)
    rb = pa.RecordBatch.from_arrays([pa.array(["a", None, "b"])], names=["s"])
    (payload,) = pf.iter_block_payloads(jf.encode_block_v2([rb], conf=JConf({})))
    assert payload[16 + struct.unpack_from("<I", payload, 12)[0]] == pf.ENC_ARROW
    n, [(codes, valid)] = pf.decode_block(payload, T.Schema((T.Field("s", T.STRING),)))
    assert [codes.vocab[c] if ok else None for c, ok in zip(codes.codes, valid)] == \
        ["a", None, "b"]
    for codec in ("none", "lz4", "zstd"):
        (payload,) = pf.iter_block_payloads(
            jf.encode_block(rb, conf=JConf({"spill.compression.codec": codec})))
        n, [(codes, valid)] = pf.decode_block(payload, T.Schema((T.Field("s", T.STRING),)))
        assert [codes.vocab[c] if ok else None for c, ok in zip(codes.codes, valid)] == \
            ["a", None, "b"], codec


def test_writer_counts_and_fallback_codec_warns_once(tmp_path, capsys, monkeypatch):
    """The default fallback codec (lz4) writes codec planes; a codec the
    process cannot have degrades with one warning per name and writes none;
    ``exec.shuffle.encoding=off`` writes v1 blocks both readers read."""
    from auron_tpu_torch.columnar import codecs

    rng = np.random.default_rng(8)
    jbs = [jax_batch({"k": rng.integers(1, 100_000, 4000, dtype=np.int64),
                      "x": rng.choice(np.sqrt(np.arange(2, 18)), 4000)}) for _ in range(2)]
    batches = [carry(b) for b in jbs]
    schema = port_schema(jbs[0].schema)

    def write(m, conf):
        ctx = PCtx(conf=PConf(conf), device="cpu")
        w = PWriter(PScan([batches], batches[0].schema), PHash([pcol(0)], 3),
                    str(tmp_path / f"m{m}.data"), str(tmp_path / f"m{m}.index"))
        list(w.execute(0, ctx))
        assert ctx.metrics.values["data_size"] == os.path.getsize(tmp_path / f"m{m}.data") - 16
        return ctx.metrics.values

    assert write(0, {}).get("shuffle_enc_codec", 0) > 0
    pf._codec_warned.clear()
    monkeypatch.setattr(codecs, "available", lambda name: False)
    for m in (1, 2):
        assert "shuffle_enc_codec" not in write(m, {})
    assert capsys.readouterr().err.count("unavailable") == 1  # lz4: once per process
    monkeypatch.undo()
    write(3, {"exec.shuffle.encoding": "off"})
    want = [r for p in range(3) for r in rows(list(PReader(schema, "b").execute(
        p, PCtx(device="cpu", resources={"b": MultiMapBlockProvider(
            [(str(tmp_path / "m0.data"), str(tmp_path / "m0.index"))])}))))]
    pairs = [(str(tmp_path / "m3.data"), str(tmp_path / "m3.index"))]
    assert not pf.is_v2_payload(next(LocalFileBlockProvider(*pairs[0]).iter_payloads(0)))
    got = [r for p in range(3) for r in rows(list(PReader(schema, "b").execute(
        p, PCtx(device="cpu", resources={"b": MultiMapBlockProvider(pairs)}))))]
    jgot = [r for p in range(3) for r in rows(list(JReader(jbs[0].schema, "b").execute(
        p, JCtx(resources={"b": JProvider(pairs)}))))]
    assert got == want == jgot and len(got) == 8000


def test_reader_honours_batch_size_and_places_on_device(tmp_path):
    batches = _inputs(n_batches=3, n=1500)
    pairs = _write("port", batches, tmp_path, 1, 1, "s")
    r = PReader(port_schema(batches[0].schema), "blocks")
    ctx = PCtx(conf=PConf({"batch.size": 1000}), resources={"blocks": MultiMapBlockProvider(pairs)},
               device="cpu")
    out = list(r.execute(0, ctx))
    assert sum(b.num_rows() for b in out) == 4500
    assert all(b.torch_device == torch.device("cpu") for b in out)
    assert ctx.metrics.values["shuffle_bytes_read"] > 0


# ---------------------------------------------------------------------------
# dictionary-encoded string columns (ENC_DICT)
# ---------------------------------------------------------------------------


def _string_inputs(seed=6, n_batches=3, n=700):
    """Batches whose string column has a different vocabulary each."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        pool = np.array([f"key_{i}" for i in range(b * 5, b * 5 + 40)] + ["", "héllo"],
                        dtype=object)
        out.append(jax_batch(
            {"s": pool[rng.integers(0, len(pool), n)], "v": rng.integers(0, 9, n)},
            {"s": rng.random(n) > 0.1}))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dictionary_string_files_read_across_packages(writer, tmp_path):
    """Hash-partitioned on a dictionary string column: either package reads
    the other's ENC_DICT blocks (the port writes and reads the vocabulary's
    Arrow IPC stream without pyarrow) and gets its own rows, in order."""
    batches = _string_inputs()
    schema = batches[0].schema
    n_out = 3
    mine = _write(writer, batches, tmp_path, 1, n_out, writer)
    other = "port" if writer == "jax" else "jax"
    theirs = _write(other, batches, tmp_path, 1, n_out, other)
    total = 0
    for p in range(n_out):
        want = _read(writer, mine, schema, p)
        assert _read(other, mine, schema, p) == want
        assert _read(writer, theirs, schema, p) == want
        total += len(want)
    assert total == sum(len(rows([b])) for b in batches)
    (d, i), = mine
    enc = [struct.unpack_from("<B", pl, 16 + struct.unpack_from("<I", pl, 12)[0])[0]
           for pl in LocalFileBlockProvider(d, i).iter_payloads(0)]
    assert enc and set(enc) == {pf.ENC_DICT}


def test_vocabulary_stream_round_trips_through_pyarrow():
    import io

    for dtype, vocab in ((T.STRING, ["", "a", "héllo", "x" * 41]),
                         (T.BINARY, [b"", b"\x00\xff", b"abc"]), (T.STRING, [])):
        arr = np.empty(len(vocab), dtype=object)
        arr[:] = vocab
        stream = pf.arrow_column_stream(arr, dtype)
        with pa.ipc.open_stream(stream) as r:
            assert r.read_all().column(0).to_pylist() == vocab
        assert pf.read_arrow_column_stream(stream, dtype).tolist() == vocab
        rb = pa.RecordBatch.from_arrays(
            [pa.array(vocab, type=pa.binary() if dtype == T.BINARY else pa.string())], ["d"])
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, rb.schema) as w:
            w.write_batch(rb)
        assert pf.read_arrow_column_stream(sink.getvalue(), dtype).tolist() == vocab


def test_dict_codes_merge_onto_one_vocabulary():
    a = pf.DictCodes(np.array([0, 1, 1], np.int32), np.array(["x", "y"], dtype=object))
    b = pf.DictCodes(np.array([1, 0], np.int32), np.array(["y", "z"], dtype=object))
    m = pf.DictCodes.concat([a, b[0:2]])
    assert m.vocab.tolist() == ["x", "y", "z"]
    assert [m.vocab[c] for c in m.codes] == ["x", "y", "y", "z", "y"]
    assert len(m) == 5 and m.nbytes == 20
