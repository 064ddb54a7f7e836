"""MAP and STRUCT in the port against the JAX package and the Arrow
standard: the types' Arrow forms; the Arrow C data interface (round trips
with pyarrow's, nested in LIST and in each other, sliced) and Arrow IPC;
the nested casts; the MAP and STRUCT functions, each case through both
packages' ``Evaluator`` (the cases where the reference raises raise in the
port too); and LIST, MAP and STRUCT columns through shuffle files written
by one package and read by the other, the JAX writer's ENC_ARROW form of
a nested column (with and without its codec) among them."""

import ctypes
import io

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu import types as JT
from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.shuffle import format as jf
from auron_tpu.exec.shuffle.partitioning import HashPartitioning as JHash
from auron_tpu.exec.shuffle.reader import IpcReaderExec as JReader
from auron_tpu.exec.shuffle.reader import MultiMapBlockProvider as JProvider
from auron_tpu.exec.shuffle.writer import ShuffleWriterExec as JWriter
from auron_tpu.exprs import ir as jir
from auron_tpu.exprs.eval import Evaluator as JEval
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch import types as PT
from auron_tpu_torch.columnar import arrow_c as C
from auron_tpu_torch.columnar import arrow_ipc as I
from auron_tpu_torch.columnar.batch import Batch as PBatch
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.shuffle import format as pf
from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning as PHash
from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec as PReader
from auron_tpu_torch.exec.shuffle.reader import LocalFileBlockProvider, MultiMapBlockProvider
from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec as PWriter
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.exprs.eval import Evaluator as PEval
from auron_tpu_torch.utils.config import Configuration as PConf
import torch_function_cases as FC
from torch_carry import carry, port_dtype, port_schema, rows

MAP_SI = pa.map_(pa.string(), pa.int64())
STRUCT = pa.struct([pa.field("x", pa.int64()), pa.field("s", pa.string()),
                    pa.field("l", pa.list_(pa.int32()))])
NESTED = pa.struct([pa.field("m", MAP_SI), pa.field("ls", pa.list_(STRUCT))])

#: the nested frame of ``torch_function_cases`` as pyarrow arrays
FRAME = {name: pa.array(vals, type=dt.to_arrow())
         for name, (dt, vals) in FC.nested_rows(JT).items()}
JB = JBatch.from_arrow(pa.RecordBatch.from_arrays(list(FRAME.values()), names=list(FRAME)))
PB = carry(JB)
COL = {n: i for i, n in enumerate(FRAME)}


def _column(typ, pool, n, seed):
    rng = np.random.default_rng(seed)
    return pa.array([pool[int(i)] for i in rng.integers(0, len(pool), n)], type=typ)


def _export(rb) -> C.HostBatch:
    return C.import_from(rb)


def _to_pyarrow(hb: C.HostBatch) -> pa.RecordBatch:
    arr, sch = C.ArrowArray(), C.ArrowSchema()
    C.export_batch(hb, ctypes.addressof(arr), ctypes.addressof(sch))
    return pa.RecordBatch._import_from_c(ctypes.addressof(arr), ctypes.addressof(sch))


def test_types_take_the_arrow_forms_of_the_reference():
    for name, arr in FRAME.items():
        pt = PT.DataType.from_arrow(arr.type)
        assert pt == port_dtype(JT.DataType.from_arrow(arr.type)), name
        assert pt.to_arrow() == JT.DataType.from_arrow(arr.type).to_arrow() == arr.type, name
    assert PT.DataType.from_arrow(MAP_SI).is_nested and PT.DataType.from_arrow(STRUCT).is_nested


@pytest.mark.parametrize("name", ["m", "st", "nst", "lm", "ent"])
def test_c_data_interface_round_trips_with_pyarrow(name):
    """pyarrow's export read by the port (whole and sliced: a struct's
    offset reaches its children), the port's export read by pyarrow, and
    the column through a CPU batch and ``Batch.to_arrow``."""
    rb = pa.RecordBatch.from_arrays([FRAME[name]], names=[name])
    for part in (rb, rb.slice(3, 20), rb.slice(7)):
        hb = _export(part)
        assert hb.columns[0].to_pylist() == part.column(0).to_pylist()
        back = _to_pyarrow(hb)
        assert back.schema == part.schema and back.column(0).to_pylist() == \
            part.column(0).to_pylist()
        b = PBatch.from_host_arrow(hb, device="cpu")
        out = b.to_arrow()
        assert out.schema.field(0).type == part.schema.field(0).type
        assert out.column(0).to_pylist() == part.column(0).to_pylist()
    dt = PT.DataType.from_arrow(rb.schema.field(0).type)
    built = C.array_from_pylist(rb.column(0).to_pylist(), dt)
    assert _to_pyarrow(C.HostBatch(PT.Schema((PT.Field(name, dt),)), rb.num_rows,
                                   (built,))).column(0).equals(rb.column(0))


def test_a_null_map_key_raises_as_arrow():
    dt = PT.DataType.from_arrow(MAP_SI)
    with pytest.raises(ValueError, match="key"):
        C.array_from_pylist([[(None, 1)]], dt)
    with pytest.raises(ValueError, match="key"):
        PBatch.from_numpy([[[(None, 1)]]], PT.Schema((PT.Field("m", dt),)), device="cpu")
    with pytest.raises(pa.ArrowInvalid, match="key"):
        pa.array([[(None, 1)]], type=MAP_SI)


@pytest.mark.parametrize("name", ["m", "st", "nst", "lm"])
def test_ipc_streams_round_trip_with_pyarrow(name):
    rb = pa.RecordBatch.from_arrays([FRAME[name]], names=[name]).slice(2, 30)
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as w:
        w.write_batch(rb)
    (hb,) = I.read_stream(sink.getvalue())
    assert hb.columns[0].to_pylist() == rb.column(0).to_pylist()
    back = pa.ipc.open_stream(I.write_stream([_export(rb)])).read_all()
    assert back.schema == rb.schema and back.column(0).to_pylist() == rb.column(0).to_pylist()
    # a dictionary-encoded nested field's schema message, as the shuffle writes it
    dt = PT.DataType.from_arrow(rb.schema.field(0).type)
    msg = I.schema_message(PT.Schema((PT.Field(name, dt),)), {0: 0}) + I.EOS
    assert pa.ipc.read_schema(pa.py_buffer(msg)).field(0).type == \
        pa.dictionary(pa.int32(), rb.schema.field(0).type)


def _dtype_sig(t):
    return (t.kind.value, t.precision, t.scale, tuple(_dtype_sig(i) for i in t.inner),
            tuple(t.struct_names))


def _same(name, got, want):
    assert _dtype_sig(got.dtype) == _dtype_sig(want.dtype), (name, got.dtype, want.dtype)
    gv, gm, ge = FC.host_result(got)
    wv, wm, we = FC.host_result(want)
    np.testing.assert_array_equal(gm, wm, err_msg=f"{name}: validity")
    if we is not None:
        assert FC.decoded(gv, gm, ge) == FC.decoded(wv, wm, we), name
    else:
        np.testing.assert_array_equal(gv[gm], wv[wm], err_msg=name)


def _both(expr_of):
    got = PEval(PB.schema).evaluate(PB, [expr_of(pir, PT)])[0]
    want = JEval(JB.schema).evaluate(JB, [expr_of(jir, JT)])[0]
    return got, want


def _map(T, k, v):
    return T.DataType(T.TypeKind.MAP, inner=(k, v))


CASTS = {
    "list_int_to_long": ("vs", lambda T: T.DataType(T.TypeKind.LIST, inner=(T.INT32,))),
    "list_to_string_list": ("vs", lambda T: T.DataType(T.TypeKind.LIST, inner=(T.STRING,))),
    "map_values_to_string": ("m", lambda T: _map(T, T.STRING, T.STRING)),
    "map_keys_to_int": ("m", lambda T: _map(T, T.INT32, T.INT64)),
    "struct_fields": ("st", lambda T: T.DataType(
        T.TypeKind.STRUCT, inner=(T.STRING, T.STRING, T.DataType(T.TypeKind.LIST,
                                                                 inner=(T.INT64,))),
        struct_names=("a", "b", "c"))),
    "map_to_string": ("m", lambda T: T.STRING),
    "struct_to_string": ("nst", lambda T: T.STRING),
    "list_of_maps_to_string": ("lm", lambda T: T.STRING),
}


@pytest.mark.parametrize("case", list(CASTS))
def test_nested_casts_match_the_reference(case):
    col, to = CASTS[case]
    got, want = _both(lambda ir, T: ir.Cast(ir.col(COL[col]), to(T)))
    _same(case, got, want)


@pytest.mark.parametrize("case", list(FC.NESTED_CASES))
def test_nested_function_matches_the_reference(case):
    """Each case through both packages' ``Evaluator``; the cases where the
    reference raises ``ValueError`` (Arrow's ``ArrowInvalid``) raise it in
    the port."""
    if case in FC.NESTED_RAISES:
        with pytest.raises(ValueError):
            JEval(JB.schema).evaluate(JB, [FC.nested_expr(jir, case)])
        with pytest.raises(ValueError):
            PEval(PB.schema).evaluate(PB, [FC.nested_expr(pir, case)])
        return
    got, want = _both(lambda ir, T: FC.nested_expr(ir, case))
    _same(case, got, want)


def test_every_reference_map_and_struct_function_has_a_case():
    names = {FC.NESTED_CASES[c][0] for c in FC.NESTED_CASES}
    assert names == set(FC.NESTED_FUNCTIONS) | {"element_at"}
    assert tuple(FRAME) == FC.NESTED_NAMES


# ---------------------------------------------------------------------------
# the file shuffle
# ---------------------------------------------------------------------------

_CONF = {"exec.shuffle.encoding.fallback.codec": "none"}


def _shuffle_batches(n=300, n_batches=2, seed=14):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        cols = [pa.array(rng.integers(0, 50, n), pa.int64()),
                _column(pa.list_(pa.int64()), [[1, 2], [], None, [b, None, 3]], n, seed + b),
                _column(MAP_SI, FC.MAPS, n, seed + 10 + b),
                _column(STRUCT, FC.STRUCTS, n, seed + 20 + b)]
        out.append(JBatch.from_arrow(pa.RecordBatch.from_arrays(cols, ["k", "l", "m", "st"])))
    return out


def _write(side, batches, tmp_path, n_out, tag):
    d, i = str(tmp_path / f"{tag}.data"), str(tmp_path / f"{tag}.index")
    if side == "jax":
        w = JWriter(JScan([batches], batches[0].schema), JHash([jir.col(0)], n_out), d, i)
        list(w.execute(0, JCtx(conf=JConf(dict(_CONF)))))
    else:
        pbs = [carry(b) for b in batches]
        w = PWriter(PScan([pbs], pbs[0].schema), PHash([pir.col(0)], n_out), d, i)
        list(w.execute(0, PCtx(conf=PConf(dict(_CONF)), device="cpu")))
    return [(d, i)]


def _read(side, pairs, schema, partition):
    if side == "jax":
        r = JReader(schema, "blocks")
        ctx = JCtx(conf=JConf(dict(_CONF)), resources={"blocks": JProvider(pairs)})
    else:
        r = PReader(port_schema(schema), "blocks")
        ctx = PCtx(conf=PConf(dict(_CONF)), resources={"blocks": MultiMapBlockProvider(pairs)},
                   device="cpu")
    return rows(list(r.execute(partition, ctx)))


def _encodings(pairs, partition) -> set:
    """The column encodings of a partition's blocks (four columns)."""
    (d, i), = pairs
    return {e for pl in LocalFileBlockProvider(d, i).iter_payloads(partition)
            for e in _column_encodings(pl, 4)}


def struct_len(pl) -> int:
    """The schema section's length in a v2 block payload."""
    return int.from_bytes(pl[12:16], "little")


def test_port_nested_blocks_read_in_the_reference(tmp_path):
    """LIST, MAP and STRUCT columns hash-partitioned on a key by the port's
    writer (ENC_DICT: the nested vocabulary as a one-column Arrow IPC
    stream, then the codes): the JAX reader reads the port's rows, in
    order."""
    batches = _shuffle_batches()
    schema = batches[0].schema
    pairs = _write("port", batches, tmp_path, 3, "port")
    total = 0
    for p in range(3):
        want = _read("port", pairs, schema, p)
        assert _read("jax", pairs, schema, p) == want
        assert _encodings(pairs, p) >= {pf.ENC_DICT}
        total += len(want)
    assert total == sum(len(rows([b])) for b in batches)


def test_reference_nested_dict_blocks_read_in_the_port():
    """The reference's block format holds a dictionary-typed nested column
    as ENC_DICT while its vocabulary holds at most
    ``exec.shuffle.encoding.dict.max`` entries (``format.py:623``); its
    vocabulary keeps the NULL rows' entries. The port decodes the rows."""
    n = 200
    rng = np.random.default_rng(3)
    mask = rng.random(n) < 0.2
    cols, names = [], []
    for name in ("lm", "m", "st", "nst"):
        vals = FRAME[name].to_pylist()[:40]
        vocab = pa.array(vals, type=FRAME[name].type)
        idx = pa.array(rng.integers(0, 40, n).astype(np.int32), mask=mask)
        cols.append(pa.DictionaryArray.from_arrays(idx, vocab))
        names.append(name)
    rb = pa.RecordBatch.from_arrays(cols, names)
    (payload,) = pf.iter_block_payloads(jf.encode_block_v2([rb], conf=JConf(dict(_CONF))))
    schema = PT.Schema(tuple(PT.Field(n_, PT.DataType.from_arrow(c.type.value_type))
                             for n_, c in zip(names, cols)))
    nrows, got = pf.decode_block(payload, schema)
    assert nrows == n
    for (vals, valid), col in zip(got, cols):
        assert vals.vocab is not None  # DictCodes
        decoded = [vals.vocab[c] if valid is None or v else None
                   for c, v in zip(vals.codes, valid if valid is not None else [True] * n)]
        assert decoded == col.to_pylist()
    assert set(_column_encodings(payload, len(cols))) == {pf.ENC_DICT}


def _column_encodings(pl, ncols) -> list:
    pos, out = 16 + struct_len(pl), []
    for _ in range(ncols):
        enc, hasv = pl[pos], pl[pos + 1]
        pos += 2
        if hasv:
            pos += 4 + int.from_bytes(pl[pos:pos + 4], "little")
        out.append(enc)
        pos += 4 + int.from_bytes(pl[pos:pos + 4], "little")
    return out


@pytest.mark.parametrize("codec", ["none", "lz4"])
def test_reference_writer_nested_columns_in_enc_arrow_read_in_the_port(tmp_path, codec):
    """The reference's ``ShuffleWriterExec`` materializes nested columns
    (``columnar/batch.py:569-572``) and writes them as ENC_ARROW, a
    single-column Arrow IPC stream under its codec: the port's reader
    reads the JAX reader's rows, in order."""
    batches = _shuffle_batches(n=100, n_batches=1)
    d, i = str(tmp_path / "jax.data"), str(tmp_path / "jax.index")
    conf = {**_CONF, "exec.shuffle.encoding.fallback.codec": codec}
    w = JWriter(JScan([batches], batches[0].schema), JHash([jir.col(0)], 2), d, i)
    list(w.execute(0, JCtx(conf=JConf(conf))))
    pairs = [(d, i)]
    for p in range(2):
        assert pf.ENC_ARROW in _encodings(pairs, p)
        want = _read("jax", pairs, batches[0].schema, p)
        assert _read("port", pairs, batches[0].schema, p) == want and want


def test_nested_vocabulary_stream_round_trips_through_pyarrow():
    dt = PT.DataType.from_arrow(NESTED)
    vocab = [e for e in FRAME["nst"].to_pylist() if e is not None]
    stream = pf.arrow_column_stream(np.array(vocab, dtype=object), dt)
    assert pa.ipc.open_stream(stream).read_all().column(0).to_pylist() == vocab
    # the JAX writer's vocabulary holds its NULL rows' entries: None here
    rb = pa.RecordBatch.from_arrays([FRAME["st"]], ["d"])
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as w:
        w.write_batch(rb)
    got = pf.read_arrow_column_stream(sink.getvalue(), PT.DataType.from_arrow(STRUCT))
    assert got.tolist() == FRAME["st"].to_pylist()
