"""Slice 18: the shuffle codecs of the port (``exec/shuffle/format.py``
ENC_CODEC and ENC_ARROW, ``columnar/arrow_ipc.py`` compressed bodies, v1
blocks, ``columnar/codecs.py``) against the JAX package, on the CPU.

- ENC_CODEC planes under lz4 and zstd: the port's column bytes equal the
  JAX ``_encode_column``'s wherever its chooser is deterministic (every
  case here), and decode back exactly; below 1,024 bytes no codec;
- whole v2 blocks at the defaults (lz4) from both writers equal past the
  schema section, and each package reads the other's files;
- ENC_ARROW: the JAX writer's strings past ``dict.max`` and its nested
  columns, under lz4, zstd and none, read in the port; the port's ENC_ARROW
  (strings past ``dict.max``) read in the JAX reader. The port writes its
  own Arrow IPC, whose bytes differ from pyarrow's (its metadata layout), so
  those columns are compared by rows;
- v1 blocks (``exec.shuffle.encoding=off``, compressed Arrow IPC) both ways;
- a codec the process cannot have warns once per name and writes none;
- a JAX PARTIAL aggregate with a ``host_udaf`` and a ``collect_list``
  written by its shuffle writer (pickled states in ENC_DICT, the nested
  list in ENC_ARROW under lz4) reduced by the port's FINAL to the JAX
  FINAL's answer, and the reverse: the state carried across packages."""

import struct

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu.bridge import udf as judf
from auron_tpu.exec.agg_exec import AggExpr as JAgg, HashAggExec as JHashAgg
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.shuffle import format as jf
from auron_tpu.exec.shuffle.partitioning import HashPartitioning as JHash
from auron_tpu.exec.shuffle.reader import IpcReaderExec as JReader
from auron_tpu.exec.shuffle.reader import MultiMapBlockProvider as JProvider
from auron_tpu.exec.shuffle.writer import ShuffleWriterExec as JWriter
from auron_tpu.exprs import ir as jir
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch import types as T
from auron_tpu_torch.bridge import udf as pudf
from auron_tpu_torch.columnar import codecs
from auron_tpu_torch.exec.agg_exec import AggExpr as PAgg, HashAggExec as PHashAgg
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.shuffle import format as pf
from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning as PHash
from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec as PReader
from auron_tpu_torch.exec.shuffle.reader import LocalFileBlockProvider, MultiMapBlockProvider
from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec as PWriter
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import canon, carry, jax_batch, port_schema, rows


def _plane(name, n, rng):
    """(port type, pyarrow type, values, validity or None) of one case."""
    pool = np.sqrt(np.arange(2, 18))
    return {
        "float64_irrational": (T.FLOAT64, pa.float64(), rng.choice(pool, n), None),
        "float32_irrational": (T.FLOAT32, pa.float32(), rng.choice(pool, n).astype(np.float32),
                               None),
        "int64_wide_pool": (T.INT64, pa.int64(),
                            rng.choice(rng.integers(-(2**62), 2**62, 16, dtype=np.int64), n),
                            None),
        "float64_nulls": (T.FLOAT64, pa.float64(), rng.choice(pool, n), rng.random(n) > 0.2),
        "float64_half_null_sparse": (T.FLOAT64, pa.float64(), rng.choice(pool, n),
                                     np.arange(n) % 2 == 0),
        "float64_random": (T.FLOAT64, pa.float64(), rng.normal(size=n), None),
    }[name]


_PLANES = ["float64_irrational", "float32_irrational", "int64_wide_pool", "float64_nulls",
           "float64_half_null_sparse", "float64_random"]


@pytest.mark.parametrize("n", [100, 4096])
@pytest.mark.parametrize("codec", ["lz4", "zstd"])
@pytest.mark.parametrize("name", _PLANES)
def test_codec_planes_match_reference_bytes(name, codec, n):
    rng = np.random.default_rng(len(name) * 1000 + n)
    dt, pt_, vals, valid = _plane(name, n, rng)
    arr = pa.array(vals, type=pt_, mask=None if valid is None else ~valid)
    want = jf._encode_column(arr, "c", codec, 4096)
    got = pf.encode_column(vals, valid, dt, codec, 4096)
    assert got == want
    enc, vbytes, payload = got
    if n == 100:
        assert enc != pf.ENC_CODEC  # below 1,024 bytes the codec never runs
    elif name in ("float64_irrational", "float32_irrational", "int64_wide_pool",
                  "float64_nulls"):
        assert enc == pf.ENC_CODEC and payload[0] == codecs.CODEC_IDS[codec]
    v = None if vbytes is None else np.unpackbits(
        np.frombuffer(vbytes, np.uint8), count=n, bitorder="little").astype(bool)
    dec = pf.decode_column(enc, payload, v, n, dt)
    exp = np.asarray(vals, dtype=dt.numpy_dtype())
    if v is not None:
        exp = np.where(v, exp, exp.dtype.type(0))
    np.testing.assert_array_equal(dec.view(np.uint8), exp.view(np.uint8))


def _inputs(seed=5, n=3000, n_batches=2):
    rng = np.random.default_rng(seed)
    pool = np.sqrt(np.arange(2, 18))
    return [jax_batch({"k": rng.integers(0, 1000, n).astype(np.int64),
                       "x": rng.choice(pool, n), "q": rng.integers(1, 100, n).astype(np.int32)},
                      {"x": rng.random(n) > 0.1}) for _ in range(n_batches)]


def _write(side, batches, tmp_path, n_out, tag, conf=None):
    d, i = str(tmp_path / f"{tag}.data"), str(tmp_path / f"{tag}.index")
    conf = dict(conf or {})
    if side == "jax":
        w = JWriter(JScan([batches], batches[0].schema), JHash([jir.col(0)], n_out), d, i)
        list(w.execute(0, JCtx(conf=JConf(conf))))
    else:
        pbs = [carry(b) for b in batches]
        w = PWriter(PScan([pbs], pbs[0].schema), PHash([pir.col(0)], n_out), d, i)
        ctx = PCtx(conf=PConf(conf), device="cpu")
        list(w.execute(0, ctx))
        assert "compress_time" in ctx.metrics.values
    return [(d, i)]


def _read(side, pairs, schema, partition):
    if side == "jax":
        op, ctx = JReader(schema, "b"), JCtx(resources={"b": JProvider(pairs)})
    else:
        op = PReader(port_schema(schema), "b")
        ctx = PCtx(device="cpu", resources={"b": MultiMapBlockProvider(pairs)})
    return rows(list(op.execute(partition, ctx)))


def test_default_blocks_match_reference_bytes_and_cross(tmp_path):
    """At the defaults (lz4 fallback codec) both writers' blocks match past
    the schema section, hold ENC_CODEC planes, and each package reads the
    other's files to the same rows."""
    batches = _inputs()
    jpairs = _write("jax", batches, tmp_path, 3, "j")
    ppairs = _write("port", batches, tmp_path, 3, "p")
    total = 0
    for p in range(3):
        jp = list(LocalFileBlockProvider(*jpairs[0]).iter_payloads(p))
        pp = list(LocalFileBlockProvider(*ppairs[0]).iter_payloads(p))
        assert len(jp) == len(pp) == 1
        (jsl,), (psl,) = struct.unpack_from("<I", jp[0], 12), struct.unpack_from("<I", pp[0], 12)
        assert jp[0][:12] == pp[0][:12] and jp[0][16 + jsl:] == pp[0][16 + psl:]
        want = _read("jax", jpairs, batches[0].schema, p)
        assert _read("port", jpairs, batches[0].schema, p) == want
        assert _read("jax", ppairs, batches[0].schema, p) == want
        total += len(want)
    assert total == sum(len(rows([b])) for b in batches)
    assert pf.ENC_CODEC in {e for p in range(3) for pl in
                            LocalFileBlockProvider(*ppairs[0]).iter_payloads(p)
                            for e in _encodings(pl, 3)}


def _encodings(pl, ncols) -> list:
    pos, out = 16 + struct.unpack_from("<I", pl, 12)[0], []
    for _ in range(ncols):
        enc, hasv = pl[pos], pl[pos + 1]
        pos += 2
        if hasv:
            pos += 4 + int.from_bytes(pl[pos:pos + 4], "little")
        out.append(enc)
        pos += 4 + int.from_bytes(pl[pos:pos + 4], "little")
    return out


def _strings(n=6000, seed=7):
    """A string column with more distinct values than ``dict.max``."""
    rng = np.random.default_rng(seed)
    s = np.array([f"v{x}" for x in rng.integers(0, 50_000, n)], dtype=object)
    return jax_batch({"k": rng.integers(0, 99, n).astype(np.int64), "s": s},
                     {"s": rng.random(n) > 0.1})


@pytest.mark.parametrize("codec", ["lz4", "zstd", "none"])
def test_reference_enc_arrow_strings_read_in_the_port(tmp_path, codec):
    b = _strings()
    pairs = _write("jax", [b], tmp_path, 2, "j", {"exec.shuffle.encoding.fallback.codec": codec})
    for p in range(2):
        pls = list(LocalFileBlockProvider(*pairs[0]).iter_payloads(p))
        assert pf.ENC_ARROW in {e for pl in pls for e in _encodings(pl, 2)}
        want = _read("jax", pairs, b.schema, p)
        assert _read("port", pairs, b.schema, p) == want and want


@pytest.mark.parametrize("codec", ["lz4", "none"])
def test_port_enc_arrow_strings_read_in_the_reference(tmp_path, codec):
    """Past ``dict.max`` distinct strings the port writes ENC_ARROW (its own
    IPC, under the codec); its bytes differ from pyarrow's, so the JAX
    reader's rows are the check."""
    b = _strings(seed=8)
    pairs = _write("port", [b], tmp_path, 2, "p", {"exec.shuffle.encoding.fallback.codec": codec})
    ref = _write("jax", [b], tmp_path, 2, "j", {"exec.shuffle.encoding.fallback.codec": codec})
    for p in range(2):
        pls = list(LocalFileBlockProvider(*pairs[0]).iter_payloads(p))
        assert {e for pl in pls for e in _encodings(pl, 2)} == {pf.ENC_BITPACK, pf.ENC_ARROW}
        want = _read("jax", ref, b.schema, p)
        assert _read("jax", pairs, b.schema, p) == want
        assert _read("port", pairs, b.schema, p) == want


def _v1(side, batches, tmp_path, tag, codec):
    return _write(side, batches, tmp_path, 2, tag,
                  {"exec.shuffle.encoding": "off", "spill.compression.codec": codec})


@pytest.mark.parametrize("codec", ["lz4", "zstd", "none"])
def test_v1_blocks_both_ways(tmp_path, codec):
    """``exec.shuffle.encoding=off``: each writer's v1 blocks (an Arrow IPC
    stream a block, compressed with ``spill.compression.codec``) read in
    both packages to the same rows."""
    batches = _inputs(n=1500)
    jpairs = _v1("jax", batches, tmp_path, "j", codec)
    ppairs = _v1("port", batches, tmp_path, "p", codec)
    for p in range(2):
        (pl,) = LocalFileBlockProvider(*ppairs[0]).iter_payloads(p)
        assert not pf.is_v2_payload(pl)
        want = _read("jax", jpairs, batches[0].schema, p)
        for side in ("jax", "port"):
            assert _read(side, ppairs, batches[0].schema, p) == want
            assert _read(side, jpairs, batches[0].schema, p) == want


def test_unavailable_codec_warns_once_per_name(monkeypatch, capsys):
    monkeypatch.setattr(codecs, "available", lambda name: False)
    pf._codec_warned.clear()
    conf = PConf({"exec.shuffle.encoding.fallback.codec": "zstd"})
    for _ in range(3):
        assert pf.fallback_codec(conf) is None
        assert pf.fallback_codec(PConf({})) is None  # auto -> spill codec lz4
    err = capsys.readouterr().err
    assert err.count("'zstd' unavailable") == 1 and err.count("'lz4' unavailable") == 1
    assert pf.fallback_codec(PConf({"exec.shuffle.encoding.fallback.codec": "none"})) is None
    monkeypatch.undo()
    assert pf.fallback_codec(conf) == "zstd" and pf.fallback_codec(PConf({})) == "lz4"


def test_codec_without_pyarrow_is_unavailable(monkeypatch):
    """A failed import of pyarrow makes every codec unavailable (the
    degraded path, never an error)."""
    import sys

    monkeypatch.setitem(sys.modules, "pyarrow", None)
    assert not codecs.available("lz4") and not codecs.available("zstd")


def _geo(pkg_t):
    return dict(init=lambda: (0.0, 0), update=lambda st, v: (st[0] + np.log(v), st[1] + 1),
                merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
                finish=lambda st: float(np.exp(st[0] / st[1])) if st[1] else None,
                out_dtype=pkg_t.FLOAT64)


@pytest.mark.parametrize("mapper", ["jax", "port"])
def test_udaf_and_collect_states_cross_the_shuffle(tmp_path, mapper):
    """A map stage's PARTIAL host_udaf (pickled accumulator states) and
    collect_list (a LIST state) written at the default codec by one package,
    reduced by the other's FINAL: the answer equals the mapper package's own
    FINAL (means at rel 1e-12, lists as multisets)."""
    from auron_tpu import types as JT

    judf.register_udaf_accumulator("geo_x", **_geo(JT))
    pudf.register_udaf_accumulator("geo_x", **_geo(T))
    rng = np.random.default_rng(11)
    jbs = [jax_batch({"k": rng.integers(0, 40, 800).astype(np.int32),
                      "v": rng.uniform(0.5, 9.0, 800)}) for _ in range(2)]
    d, i = str(tmp_path / "m.data"), str(tmp_path / "m.index")

    def aggs(ir, agg):
        return [(agg("host_udaf", ir.col(1), udaf="geo_x"), "g"),
                (agg("collect_list", ir.col(1)), "l")]

    if mapper == "jax":
        part = JHashAgg(JScan([jbs], jbs[0].schema), [(jir.col(0), "k")], aggs(jir, JAgg),
                        "partial")
        list(JWriter(part, JHash([jir.col(0)], 2), d, i).execute(0, JCtx()))
        inter = part.schema
    else:
        pbs = [carry(b) for b in jbs]
        part = PHashAgg(PScan([pbs], pbs[0].schema), [(pir.col(0), "k")], aggs(pir, PAgg),
                        "partial")
        list(PWriter(part, PHash([pir.col(0)], 2), d, i).execute(0, PCtx(device="cpu")))
        inter = part.inter_schema
    encs = {e for p in range(2) for pl in LocalFileBlockProvider(d, i).iter_payloads(p)
            for e in _encodings(pl, 3)}
    assert pf.ENC_DICT in encs or pf.ENC_ARROW in encs
    jinter = inter if mapper == "jax" else None
    got, want = [], []
    for p in range(2):
        pfin = PHashAgg(PReader(port_schema(jinter) if jinter is not None else inter, "b"),
                        [(pir.col(0), "k")], aggs(pir, PAgg), "final")
        got += rows(list(pfin.execute(p, PCtx(device="cpu", resources={
            "b": MultiMapBlockProvider([(d, i)])}))))
        jschema = jinter if jinter is not None else _jax_schema(inter)
        jfin = JHashAgg(JReader(jschema, "b"), [(jir.col(0), "k")], aggs(jir, JAgg), "final")
        want += rows(list(jfin.execute(p, JCtx(resources={"b": JProvider([(d, i)])}))))
    got, want = canon(got), canon(want)
    assert [r[0] for r in got] == [r[0] for r in want] == list(range(40))
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=1e-12)
    assert [sorted(r[2]) for r in got] == [sorted(r[2]) for r in want]


def _jax_schema(s: T.Schema):
    from auron_tpu import types as JT

    def jt(t):
        return JT.DataType(JT.TypeKind(t.kind.value), t.precision, t.scale,
                           tuple(jt(i) for i in t.inner), tuple(t.struct_names))

    return JT.Schema(tuple(JT.Field(f.name, jt(f.dtype), f.nullable) for f in s))
