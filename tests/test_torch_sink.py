"""The port's Parquet and ORC sinks (``auron_tpu_torch/exec/sink.py``)
against the JAX package's (``auron_tpu/exec/sink.py``): the same batches
through both, then the directory trees and file names must be equal, the
tables read back must be equal, and so must the counted metrics
(``rows_written``, ``partitions_written``). Covered: plain and
Hive-partitioned Parquet with NULL, NaN and escaped keys (``a/b``, ``x=y``,
``%``), an empty partition, several batches, the ``compression`` prop, and
ORC.
"""

import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JMemory
from auron_tpu.exec import sink as jsink

from auron_tpu_torch.columnar.batch import Batch as PBatch
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PMemory
from auron_tpu_torch.exec import sink as psink
from torch_arrow import pyarrow_egress


def _batches(n: int, seed: int, n_batches: int = 1) -> list:
    """Record batches with string, float and int key columns holding NULLs,
    NaN and the characters Hive escapes."""
    rng = np.random.default_rng(seed)
    keys = ["a/b", "x=y", "%", "plain", None, "é#1"]
    out = []
    for _ in range(n_batches):
        cat = [keys[i] for i in rng.integers(0, len(keys), n)]
        f = rng.choice([1.5, float("nan"), -0.0, 2.0], n).tolist()
        f = [None if i % 11 == 0 else x for i, x in enumerate(f)]
        out.append(pa.record_batch({
            "id": pa.array(rng.integers(0, 1000, n), pa.int64()),
            "cat": pa.array(cat, pa.string()),
            "f": pa.array(f, pa.float64()),
            "y": pa.array(rng.integers(2020, 2023, n).astype(np.int32), pa.int32()),
            "price": pa.array(np.round(rng.random(n) * 100, 2)),
        }))
    return out


def _write(pkg: str, kind: str, root: str, parts: list[list], **kw):
    """Run the sink over ``parts`` (one batch list a task partition) into
    ``root``; the counted metrics summed over the tasks."""
    counts: dict = {}
    for p, rbs in enumerate(parts):
        if pkg == "jax":
            batches = [JBatch.from_arrow(rb) for rb in rbs]
            schema = batches[0].schema if batches else None
            child, sink, ctx = JMemory, jsink, JCtx()
        else:
            batches = [PBatch.from_arrow(rb, device="cpu") for rb in rbs]
            schema = batches[0].schema if batches else None
            child, sink, ctx = PMemory, psink, PCtx(device="cpu")
        if schema is None:  # an empty partition: the schema of a full one
            ref = parts[0][0]
            schema = (JBatch if pkg == "jax" else PBatch).from_arrow(
                ref, **({} if pkg == "jax" else {"device": "cpu"})).schema
        src = child([[]] * p + [batches], schema)
        if kind == "orc":
            op = sink.OrcSinkExec(src, root, kw.get("props"))
        else:
            op = sink.ParquetSinkExec(src, root, kw.get("props"),
                                      partition_by=kw.get("partition_by"))
        assert list(op.execute(p, ctx)) == []
        for k, v in ctx.metrics.snapshot()["values"].items():
            if not k.endswith("_time"):
                counts[k] = counts.get(k, 0) + v
    return counts


def _tree(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _rows(table) -> list:
    """Rows with NaN made comparable."""
    return [{k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
             for k, v in r.items()} for r in table.to_pylist()]


def _assert_same_output(jroot: str, proot: str, kind: str = "parquet") -> list[str]:
    tree = _tree(proot)
    assert tree == _tree(jroot)
    def read(f):  # the file as it is (read_table may add a Hive directory's key)
        return orc.ORCFile(f).read() if kind == "orc" else pq.ParquetFile(f).read()

    for rel in tree:
        jt, pt = read(os.path.join(jroot, rel)), read(os.path.join(proot, rel))
        assert pt.schema == jt.schema, rel
        assert _rows(pt) == _rows(jt), rel
        if kind == "parquet":
            jmd = pq.ParquetFile(os.path.join(jroot, rel)).metadata
            pmd = pq.ParquetFile(os.path.join(proot, rel)).metadata
            assert pmd.num_row_groups == jmd.num_row_groups, rel
            assert [pmd.row_group(0).column(j).compression for j in range(pmd.num_columns)] == \
                [jmd.row_group(0).column(j).compression for j in range(jmd.num_columns)] \
                if pmd.num_row_groups else True
    return tree


#: name -> (sink kind, partitions (batch lists), sink arguments)
CASES = {
    "plain": ("parquet", lambda: [_batches(300, 1)], {}),
    "plain_tasks_and_batches": ("parquet", lambda: [_batches(200, 2, 3), _batches(50, 3)], {}),
    "plain_empty_partition": ("parquet", lambda: [_batches(100, 4), []], {}),
    "plain_snappy": ("parquet", lambda: [_batches(100, 5)], {"props": {"compression": "snappy"}}),
    "hive_string_key": ("parquet", lambda: [_batches(400, 6)], {"partition_by": ["cat"]}),
    "hive_float_key": ("parquet", lambda: [_batches(400, 7)], {"partition_by": ["f"]}),
    "hive_two_keys": ("parquet", lambda: [_batches(300, 8, 2), _batches(100, 9)],
                      {"partition_by": ["y", "cat"]}),
    "hive_empty_partition": ("parquet", lambda: [_batches(100, 10), []],
                             {"partition_by": ["cat"]}),
    "orc": ("orc", lambda: [_batches(300, 11, 2)], {}),
    "orc_empty_partition": ("orc", lambda: [_batches(100, 12), []], {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sink_writes_what_the_reference_writes(tmp_path, name):
    kind, parts_of, kw = CASES[name]
    parts = parts_of()
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _write("jax", kind, jroot, parts, **kw)
    got = _write("port", kind, proot, parts, **kw)
    assert got == want
    tree = _assert_same_output(jroot, proot, kind)
    n = sum(rb.num_rows for rbs in parts for rb in rbs)
    assert got["rows_written"] == n
    if kw.get("partition_by"):
        assert all("=" in rel.split(os.sep)[0] for rel in tree)
    if name == "hive_string_key":
        dirs = sorted({rel.split(os.sep)[0] for rel in tree})
        assert dirs == sorted(f"cat={psink._hive_escape(v)}" for v in
                              {r for rb in parts[0] for r in rb.column("cat").to_pylist()})
        assert "cat=a%2Fb" in dirs and "cat=x%3Dy" in dirs and "cat=%25" in dirs
        assert "cat=__HIVE_DEFAULT_PARTITION__" in dirs
    if name == "hive_float_key":
        # NaN keys make one directory, as the reference groups them
        assert sum(rel.startswith("f=nan") for rel in tree) == 1
    if name == "plain_empty_partition":
        empty = pq.ParquetFile(os.path.join(proot, "part-00001.parquet")).read()
        assert empty.num_rows == 0 and empty.schema == parts[0][0].schema


def test_hive_escape_equals_the_reference():
    values = [None, "", "plain", "a/b", "x=y", "%", "#?*", 'q"\'', "back\\slash", "{}[]^:",
              "tab\there", "\x01", "é", 3, -1.5, float("nan"), True]
    assert [psink._hive_escape(v) for v in values] == [jsink._hive_escape(v) for v in values]


def _typed_batch(seed: int, n: int):
    """A record batch of every fixed-width, string and decimal type the sinks
    write, NULLs in each column."""
    import datetime
    import decimal

    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.2

    def arr(values, typ):
        return pa.array([None if z else v for v, z in zip(values, null)], typ)

    ints = rng.integers(-1000, 1000, n).tolist()
    return pa.record_batch({
        "b": arr([bool(i % 2) for i in ints], pa.bool_()),
        "i8": arr([i % 100 for i in ints], pa.int8()),
        "i16": arr(ints, pa.int16()), "i32": arr(ints, pa.int32()),
        "i64": arr([i * 10**12 for i in ints], pa.int64()),
        "f32": arr([i / 7 for i in ints], pa.float32()),
        "f64": arr([float("nan") if i % 9 == 0 else i / 3 for i in ints], pa.float64()),
        "s": arr([f"s{i % 17}/é" for i in ints], pa.string()),
        "d": arr([datetime.date(2000, 1, 1) + datetime.timedelta(days=i) for i in ints],
                 pa.date32()),
        "ts": arr([datetime.datetime(2020, 1, 1) + datetime.timedelta(microseconds=i * 997)
                   for i in ints], pa.timestamp("us")),
        "m": arr([decimal.Decimal(i).scaleb(-2) for i in ints], pa.decimal128(7, 2)),
        "w": arr([decimal.Decimal(i * 10**20).scaleb(-4) for i in ints], pa.decimal128(30, 4)),
    })


@pytest.mark.parametrize("n", [1, 257, 5000])
def test_to_arrow_is_the_reference_egress(n):
    """The sinks' egress (``Batch.to_arrow``: the C data interface) gives
    the batch that a pyarrow build of each column gives
    (``torch_arrow.pyarrow_egress``), bit for bit, schema (nullability)
    included."""
    rb = _typed_batch(n, n)
    b = PBatch.from_arrow(rb, device="cpu")
    got = b.to_arrow()
    want = pyarrow_egress(b)
    assert got.schema.equals(want.schema)
    for name in want.schema.names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_floating(w.type):  # bit for bit: NaN equals itself
            valid = w.is_valid().to_numpy(zero_copy_only=False)
            assert np.array_equal(g.is_valid().to_numpy(zero_copy_only=False), valid)
            bits = np.uint64 if w.type == pa.float64() else np.uint32
            assert np.array_equal(g.fill_null(0).to_numpy().view(bits)[valid],
                                  w.fill_null(0).to_numpy().view(bits)[valid]), name
        else:
            assert g.equals(w), name
    assert _rows(pa.Table.from_batches([got])) == _rows(pa.Table.from_batches([rb]))
