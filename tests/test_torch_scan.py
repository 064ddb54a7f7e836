"""The port's Parquet and ORC scans (``auron_tpu_torch/exec/scan.py``)
against the JAX package's (``auron_tpu/exec/scan.py``) on the same files.

One case per reference test of ``tests/test_scan_pruning.py`` (statistics
pruning, late materialization, the pruned scan against the exact filter,
the coalesced reader through an opener, an all-NULL group, schema adaption
for missing and widened columns with and without predicates, the ORC late
path, probe planes reused without a second decode), plus
``files.ignore.corrupted``, IN and OR predicates and the per-task file
groups. Rows must be equal exactly (order included), and so must every
metric that counts (every metric but the timers).
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

from auron_tpu import types as JT
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec import scan as jscan
from auron_tpu.exprs import ir as jir

from auron_tpu_torch import types as PT
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec import scan as pscan
from auron_tpu_torch.exprs import ir as pir


def _schema(tmod, fields):
    return tmod.Schema(tuple(tmod.Field(n, getattr(tmod, t), True) for n, t in fields))


KVS = (("k", "INT64"), ("v", "INT64"), ("s", "STRING"))
KVW = (("k", "INT64"), ("v", "INT64"), ("w", "FLOAT64"))


def _counts(ctx) -> dict:
    return {k: v for k, v in ctx.metrics.snapshot()["values"].items()
            if not k.endswith("_time")}


def run_both(kind: str, fields, files, preds=lambda ir: [], conf=None, resources=None,
             partitions=None, partition: int = 0, fs: str | None = None):
    """The same scan through both packages: (rows, counts) of each."""
    out = []
    for tmod, ir, scan, ctx in ((JT, jir, jscan, JCtx()), (PT, pir, pscan, PCtx(device="cpu"))):
        for k, v in (conf or {}).items():
            ctx.conf.set(k, v)
        ctx.resources.update(resources or {})
        cls = scan.ParquetScanExec if kind == "parquet" else scan.OrcScanExec
        op = cls(_schema(tmod, fields), list(files), preds(ir), fs, partitions=partitions)
        rows = [r for b in op.execute(partition, ctx) for r in b.to_arrow().to_pylist()]
        out.append((rows, _counts(ctx)))
    return out


def assert_same(kind, fields, files, preds=lambda ir: [], **kw):
    (jrows, jm), (prows, pm) = run_both(kind, fields, files, preds, **kw)
    assert prows == jrows
    assert pm == jm
    return prows, pm


@pytest.fixture(scope="module")
def pq_file(tmp_path_factory):
    """4 row groups with disjoint k ranges (sorted: tight statistics)."""
    path = str(tmp_path_factory.mktemp("scan") / "t.parquet")
    n = 4000
    tbl = pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                    "v": pa.array((np.arange(n, dtype=np.int64) % 100) * 2),
                    "s": pa.array([f"val_{i % 50}" for i in range(n)])})
    pq.write_table(tbl, path, row_group_size=1000)
    return path


def _and(ir, a, b):
    return ir.BinaryOp("and", a, b)


def _cmp(ir, op, c, v):
    return ir.BinaryOp(op, ir.col(c), ir.lit(v))


#: name -> (predicates of an ir module, conf, counts the reference test pins)
PARQUET_CASES = {
    "stats_range": (lambda ir: [_and(ir, _cmp(ir, "gteq", 0, 1200), _cmp(ir, "lt", 0, 1800))],
                    {}, {"row_groups_total": 4, "row_groups_pruned": 3}),
    "late_stat_blind": (lambda ir: [_cmp(ir, "eq", 1, 51)], {},
                        {"row_groups_pruned_late": 4}),
    "late_off": (lambda ir: [_cmp(ir, "eq", 1, 51)],
                 {"parquet.late.materialization": "false"}, {}),
    "pruned_equals_exact": (lambda ir: [_and(ir, _cmp(ir, "gt", 0, 2500),
                                             _cmp(ir, "eq", 1, 14))], {}, {}),
    "no_predicates": (lambda ir: [], {}, {"row_groups_total": 4}),
    "in_list": (lambda ir: [ir.In(ir.col(0), (5, 1500, 3999, 9999))], {}, {}),
    "or_of_ranges": (lambda ir: [ir.BinaryOp(
        "or", _and(ir, _cmp(ir, "gteq", 0, 100), _cmp(ir, "lteq", 0, 150)),
        _and(ir, _cmp(ir, "gteq", 0, 3100), _cmp(ir, "lteq", 0, 3120)))], {},
        {"row_groups_pruned": 2}),
    "string_neq": (lambda ir: [_cmp(ir, "neq", 2, "val_3")], {}, {}),
    "unconvertible_or": (lambda ir: [ir.BinaryOp("or", _cmp(ir, "lt", 0, 10),
                                                 ir.IsNull(ir.col(1)))], {}, {}),
}


@pytest.mark.parametrize("name", sorted(PARQUET_CASES))
def test_parquet_scan_equals_the_reference(pq_file, name):
    preds, conf, pinned = PARQUET_CASES[name]
    rows, m = assert_same("parquet", KVS, [pq_file], preds, conf=conf)
    for k, v in pinned.items():
        assert m.get(k, 0) == v, (k, m)
    if name == "pruned_equals_exact":
        assert [r["k"] for r in rows] == [k for k in range(2501, 4000) if (k % 100) * 2 == 14]


def test_late_materialization_reads_fewer_bytes(pq_file):
    _, late = run_both("parquet", KVS, [pq_file], lambda ir: [_cmp(ir, "eq", 1, 51)])[1]
    _, full = run_both("parquet", KVS, [pq_file])[1]
    assert late["bytes_scanned"] < full["bytes_scanned"] / 3


def test_coalesced_reader_through_an_opener(pq_file):
    class CountingRaw(io.FileIO):
        reads = 0

        def read(self, n=-1):
            CountingRaw.reads += 1
            return super().read(n)

    rows, m = assert_same("parquet", KVS, [pq_file], lambda ir: [_cmp(ir, "lt", 0, 500)],
                          resources={"fs": lambda p: CountingRaw(p, "rb")}, fs="fs")
    assert len(rows) == 500
    assert m["fs_raw_reads"] <= 4 and m["row_groups_pruned"] == 3, m


def test_coalesced_read_file_serves_windows(tmp_path):
    path = tmp_path / "blob"
    data = bytes(range(256)) * 1024
    path.write_bytes(data)
    f = pscan.CoalescedReadFile(open(path, "rb"), 1 << 16)
    g = jscan.CoalescedReadFile(open(path, "rb"), 1 << 16)
    for off, n in ((0, 10), (70_000, 100_000), (len(data) - 5, 50), (3, -1)):
        f.seek(off)
        g.seek(off)
        assert f.read(n) == g.read(n) == data[off:off + n if n >= 0 else None]
    assert (f.raw_reads, f.bytes_fetched) == (g.raw_reads, g.bytes_fetched)
    f.close()
    g.close()
    assert f.closed


def test_all_null_group_pruned_by_is_not_null(tmp_path):
    path = str(tmp_path / "nulls.parquet")
    pq.write_table(pa.table({"a": pa.array([None] * 100 + list(range(100)), pa.int64())}),
                   path, row_group_size=100)
    rows, m = assert_same("parquet", (("a", "INT64"),), [path],
                          lambda ir: [ir.IsNotNull(ir.col(0))])
    assert len(rows) == 100 and m["row_groups_pruned"] == 1


@pytest.fixture()
def old_new(tmp_path):
    old, new = str(tmp_path / "old.parquet"), str(tmp_path / "new.parquet")
    pq.write_table(pa.table({"k": pa.array([1, 2], pa.int32())}), old)
    pq.write_table(pa.table({"k": pa.array([3, 4], pa.int32()),
                             "extra": pa.array(["x", "y"], pa.string())}), new)
    return [old, new]


def test_schema_adaption_missing_and_widened_columns(old_new):
    rows, _ = assert_same("parquet", (("k", "INT64"), ("extra", "STRING")), old_new)
    assert rows == [{"k": 1, "extra": None}, {"k": 2, "extra": None},
                    {"k": 3, "extra": "x"}, {"k": 4, "extra": "y"}]


def test_schema_adaption_with_predicates(tmp_path):
    a, b = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    pq.write_table(pa.table({"k": pa.array(range(10), pa.int64())}), a)
    pq.write_table(pa.table({"k": pa.array(range(10, 20), pa.int64()),
                             "v": pa.array(range(10), pa.int64())}), b)
    rows, m = assert_same("parquet", (("k", "INT64"), ("v", "INT64")), [a, b],
                          lambda ir: [_cmp(ir, "gteq", 1, 5)])
    assert sorted(r["k"] for r in rows) == list(range(15, 20))
    assert m.get("row_groups_pruned_late", 0) >= 1


@pytest.fixture()
def orc_file(tmp_path):
    path = str(tmp_path / "t.orc")
    n = 3000
    orc.write_table(pa.table({"k": pa.array(range(n), pa.int64()),
                              "v": pa.array([i % 50 for i in range(n)], pa.int64())}),
                    path, stripe_size=8192)  # several stripes
    return path


@pytest.mark.parametrize("name,preds,pinned", [
    ("absent", lambda ir: [_cmp(ir, "eq", 1, 777)], "stripes_pruned_late"),
    ("prefix", lambda ir: [_cmp(ir, "lt", 0, 3)], None),
    ("no_predicates", lambda ir: [], None),
])
def test_orc_scan_equals_the_reference(orc_file, name, preds, pinned):
    fields = (("k", "INT64"), ("v", "INT64"), ("missing", "STRING"))
    rows, m = assert_same("orc", fields, [orc_file], preds)
    if pinned:
        assert rows == [] and m.get(pinned, 0) >= 1, m
    if name == "prefix":
        assert [r["k"] for r in rows] == [0, 1, 2]
        assert all(r["missing"] is None for r in rows)


def _spy_calls(monkeypatch, cls, method, calls):
    orig = getattr(cls, method)

    def spy(self, i, columns=None, **kw):
        calls.append((i, tuple(columns or ())))
        return orig(self, i, columns=columns, **kw)

    monkeypatch.setattr(cls, method, spy)


@pytest.mark.parametrize("kind", ["parquet", "orc"])
def test_probe_planes_reused_without_a_second_decode(tmp_path, monkeypatch, kind):
    n = 4000
    tbl = pa.table({"k": pa.array(range(n), pa.int64()),
                    "v": pa.array([i % 7 for i in range(n)], pa.int64()),
                    "w": pa.array([float(i) for i in range(n)])})
    path = str(tmp_path / f"t.{kind}")
    if kind == "parquet":
        pq.write_table(tbl, path, row_group_size=1000)
        cls, method = pq.ParquetFile, "read_row_group"
    else:
        orc.write_table(tbl, path, stripe_size=8192)
        cls, method = orc.ORCFile, "read_stripe"
    per_package = []
    for which in (0, 1):
        calls: list = []
        _spy_calls(monkeypatch, cls, method, calls)
        scan = (jscan, pscan)[which]
        tmod, ir = ((JT, jir), (PT, pir))[which]
        ctx = JCtx() if which == 0 else PCtx(device="cpu")
        op = (scan.ParquetScanExec if kind == "parquet" else scan.OrcScanExec)(
            _schema(tmod, KVW), [path], [_cmp(ir, "eq", 1, 3)])
        rows = [r for b in op.execute(0, ctx) for r in b.to_arrow().to_pylist()]
        monkeypatch.undo()
        per_package.append((rows, calls))
    (jrows, jcalls), (prows, pcalls) = per_package
    assert prows == jrows and len(prows) == sum(1 for i in range(n) if i % 7 == 3)
    assert pcalls == jcalls
    seen: dict = {}
    for g, cols in pcalls:
        for c in cols:
            assert c not in seen.setdefault(g, set()), f"{c} decoded twice in group {g}"
            seen[g].add(c)
    wide = [cols for _, cols in pcalls if "v" not in cols]
    assert wide and all(set(c) == {"k", "w"} for c in wide)


@pytest.mark.parametrize("tolerate", [True, False])
def test_ignore_corrupted_files(pq_file, tmp_path, tolerate):
    bad = tmp_path / "bad.parquet"
    bad.write_bytes(b"not a parquet file at all")
    conf = {"files.ignore.corrupted": "true" if tolerate else "false"}
    if tolerate:
        rows, m = assert_same("parquet", KVS, [str(bad), pq_file],
                              lambda ir: [_cmp(ir, "lt", 0, 10)], conf=conf)
        assert len(rows) == 10 and m["corrupted_files_skipped"] == 1
        return
    errors = []
    for tmod, ir, scan, ctx in ((JT, jir, jscan, JCtx()), (PT, pir, pscan, PCtx(device="cpu"))):
        ctx.conf.set("files.ignore.corrupted", "false")
        op = scan.ParquetScanExec(_schema(tmod, KVS), [str(bad), pq_file])
        with pytest.raises(Exception) as e:
            list(op.execute(0, ctx))
        errors.append(type(e.value))
    assert errors[0] is errors[1]


@pytest.mark.parametrize("partition", [0, 1, 2])
def test_task_reads_its_file_group(pq_file, tmp_path, partition):
    other = str(tmp_path / "o.parquet")
    pq.write_table(pa.table({"k": pa.array([7, 8], pa.int64()), "v": pa.array([1, 2], pa.int64()),
                             "s": pa.array(["a", None])}), other)
    groups = [[pq_file], [other]]  # a third task (over-provisioned) reads nothing
    rows, _ = assert_same("parquet", KVS, [pq_file, other], lambda ir: [_cmp(ir, "lt", 0, 9)],
                          partitions=groups, partition=partition)
    assert len(rows) == (9, 2, 0)[partition]


def test_pruning_filter_and_statistics_decisions():
    """``pruning_to_arrow_filter`` and ``_pred_false_for_stats`` decide as the
    reference's on every predicate shape."""
    fields = KVS
    shapes = [
        lambda ir: _cmp(ir, "eq", 0, 5), lambda ir: _cmp(ir, "neq", 0, 5),
        lambda ir: _cmp(ir, "gt", 0, 5), lambda ir: _cmp(ir, "lteq", 2, "b"),
        lambda ir: ir.BinaryOp("eq", ir.col(0), ir.lit(None)),
        lambda ir: ir.In(ir.col(0), (1, 2)), lambda ir: ir.In(ir.col(0), (1,), True),
        lambda ir: ir.In(ir.col(0), (None,)), lambda ir: ir.IsNotNull(ir.col(1)),
        lambda ir: ir.IsNull(ir.col(1)),
        lambda ir: _and(ir, _cmp(ir, "gt", 0, 1), ir.IsNull(ir.col(0))),
        lambda ir: ir.BinaryOp("or", _cmp(ir, "gt", 0, 1), ir.IsNull(ir.col(0))),
    ]
    stats_list = [{"k": (0, 9, 0, 10), "v": (None, None, 10, 10), "s": ("a", "c", 0, 10)},
                  {"k": (10, 20, 1, 12)}, {}]
    for shape in shapes:
        je, pe = shape(jir), shape(pir)
        jf = jscan.pruning_to_arrow_filter(je, _schema(JT, fields))
        pf = pscan.pruning_to_arrow_filter(pe, _schema(PT, fields))
        assert (pf is None) == (jf is None) and (pf is None or pf.equals(jf))
        for st in stats_list:
            assert pscan._pred_false_for_stats(pe, _schema(PT, fields), st) == \
                jscan._pred_false_for_stats(je, _schema(JT, fields), st)
