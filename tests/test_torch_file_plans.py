"""The file variants in the port's planner and in converted host plans.

- ``parquet_scan``, ``orc_scan``, ``parquet_sink`` and ``orc_sink`` plan
  from protos built as ``plan/builders.py`` and the converters build them;
  ``kafka_scan`` still raises naming its ROADMAP item, and
  ``rss_shuffle_writer`` plans and pushes to the service;
- the tables written through converted ``DataWritingCommandExec`` plans
  read back equal to the numpy tables; q42, q93 and q3 from file-backed
  ``FileSourceScanExec`` host plans equal their oracles, q42 also from the
  ORC fact, q3 also over the sorted write's files under a pushed filter
  that prunes row groups;
- a table-format resolution over real Parquet data files scans to the same
  rows through the port's converted plan as through the JAX package's
  ``ParquetScanExec``;
- importing the scans, the sinks and the planner loads no pyarrow.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

import test_hudi
import test_iceberg
from auron_tpu import types as JT
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.scan import ParquetScanExec as JParquetScan

from auron_tpu_torch import proto as pb
from auron_tpu_torch import types as T
from auron_tpu_torch.convert import hudi as phudi
from auron_tpu_torch.convert import iceberg as piceberg
from auron_tpu_torch.exec import scan as pscan
from auron_tpu_torch.exec import sink as psink
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.models import tpcds
from auron_tpu_torch.plan import builders as B
from auron_tpu_torch.plan.planner import plan_from_proto

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KV = T.Schema((T.Field("k", T.INT64, True), T.Field("v", T.STRING, True)))


def _orc_scan():
    n = pb.OrcScanNode(schema=B.schema_to_proto(KV), file_paths=["/d/a.orc"],
                       fs_resource_id="fs")
    n.pruning_predicates.add().CopyFrom(B.expr_to_proto(ir.BinaryOp("lt", ir.col(0),
                                                                    ir.lit(3))))
    n.partitions.add().paths.extend(["/d/a.orc"])
    return B._wrap(orc_scan=n)


def _parquet_scan():
    node = B.parquet_scan(KV, ["/d/a.parquet", "/d/b.parquet"],
                          [ir.BinaryOp("gteq", ir.col(0), ir.lit(5))])
    for group in (["/d/a.parquet"], ["/d/b.parquet"]):
        node.parquet_scan.partitions.add().paths.extend(group)
    return node


VARIANTS = {
    "parquet_scan": (_parquet_scan, pscan.ParquetScanExec,
                     lambda op: (op.file_paths == ["/d/a.parquet", "/d/b.parquet"]
                                 and op.partitions == [["/d/a.parquet"], ["/d/b.parquet"]]
                                 and len(op.pruning_predicates) == 1
                                 and op.fs_resource_id is None)),
    "orc_scan": (_orc_scan, pscan.OrcScanExec,
                 lambda op: (op.file_paths == ["/d/a.orc"] and op.fs_resource_id == "fs"
                             and op.partitions == [["/d/a.orc"]]
                             and op.pruning_predicates == [ir.BinaryOp("lt", ir.col(0),
                                                                       ir.lit(3))])),
    "parquet_sink": (lambda: B.parquet_sink(B.memory_scan(KV, "m"), "/out",
                                            {"compression": "snappy"}, partition_by=["v"]),
                     psink.ParquetSinkExec,
                     lambda op: (op.output_path == "/out" and op.partition_by == ["v"]
                                 and op.props == {"compression": "snappy"}
                                 and op.schema == KV)),
    "orc_sink": (lambda: B._wrap(orc_sink=pb.OrcSinkNode(child=B.memory_scan(KV, "m"),
                                                         output_path="/o", props={"a": "b"})),
                 psink.OrcSinkExec,
                 lambda op: op.output_path == "/o" and op.props == {"a": "b"}),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_the_file_variants_plan(name):
    build, cls, check = VARIANTS[name]
    wire = build().SerializeToString()
    op = plan_from_proto(pb.PhysicalPlanNode.FromString(wire))
    assert type(op) is cls and op.schema == KV and check(op)


@pytest.mark.parametrize("which,item", [
    ("kafka_scan", "item 6"), ("rss_shuffle_writer", "item 4")])
def test_the_remaining_refusals_name_their_items(which, item):
    """``kafka_scan`` still raises naming its item; ``rss_shuffle_writer``
    (item 4) now plans and pushes its blocks to the service."""
    leaf = B.memory_scan(KV, "m")
    node = (B.kafka_scan(KV, "t", "src") if which == "kafka_scan" else
            B.rss_shuffle_writer(leaf, B.hash_partitioning([ir.col(0)], 2), "rss"))
    proto = pb.PhysicalPlanNode.FromString(node.SerializeToString())
    if which == "kafka_scan":
        with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
            plan_from_proto(proto)
        return
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec
    from auron_tpu_torch.exec.shuffle.rss import (
        LocalRssService, RssBlockProvider, RssPartitionWriterClient,
    )
    from auron_tpu_torch.exec.shuffle.writer import RssShuffleWriterExec

    op = plan_from_proto(proto)
    assert isinstance(op, RssShuffleWriterExec)
    svc = LocalRssService()
    b = Batch.from_numpy([np.arange(50, dtype=np.int64),
                          np.array([f"s{i}" for i in range(50)], dtype=object)], KV, device="cpu")
    ctx = ExecutionContext(device="cpu", resources={"m": [[b]],
                                                    "rss": RssPartitionWriterClient(svc, "s", 0)})
    assert list(op.execute(0, ctx)) == []
    got = sorted(r for p in range(2) for bb in IpcReaderExec(KV, "r").execute(
        p, ExecutionContext(device="cpu", resources={"r": RssBlockProvider(svc, "s")}))
        for r in zip(*bb.to_pydict().values()))
    assert got == [(i, f"s{i}") for i in range(50)]


@pytest.fixture(scope="module")
def data():
    return tpcds.generate(0.02, 42)


@pytest.fixture(scope="module")
def files(data, tmp_path_factory):
    """The four tables as Parquet, the fact also as ORC, and the sorted
    write (row groups of 8,192 rows)."""
    root = str(tmp_path_factory.mktemp("files"))
    stats: dict = {}
    paths = tpcds.write_tables(data, os.path.join(root, "parquet"), device="cpu", stats=stats)
    orc_dir = tpcds.write_table(data.store_sales, os.path.join(root, "orc"), "cpu", fmt="orc",
                                n_parts=4)
    sorted_files = tpcds.run_sorted_write(data, os.path.join(root, "sorted"), device="cpu",
                                          conf={"batch.size": "8192"})
    return {"paths": paths, "stats": stats, "orc": orc_dir, "sorted": sorted_files,
            "root": root}


@pytest.mark.parametrize("name", ["store_sales", "item", "date_dim", "customer"])
def test_written_tables_read_back(data, files, name):
    table = tpcds.file_tables(data)[name]
    parts = tpcds.part_files(files["paths"][name])
    assert len(parts) == (4 if name == "store_sales" else 1)
    got = pa.concat_tables([pq.ParquetFile(f).read() for f in parts])
    assert tpcds.table_mismatch(got, table) is None
    st = files["stats"][name]
    assert st["counters"]["ParquetSinkExec.rows_written"] == len(table)
    assert st["bytes"] == sum(os.path.getsize(f) for f in parts)


def test_orc_fact_reads_back(data, files):
    got = pa.concat_tables([orc.read_table(f) for f in tpcds.part_files(files["orc"], "orc")])
    assert tpcds.table_mismatch(got, data.store_sales) is None


def test_hive_partitioned_item(data, tmp_path):
    st: dict = {}
    path = tpcds.write_table(data.item, str(tmp_path / "hive"), "cpu",
                             partition_by=["i_category"], stats=st)
    cats, counts = np.unique(data.item.columns["i_category"].astype(str), return_counts=True)
    assert sorted(os.listdir(path)) == [f"i_category={psink._hive_escape(c)}" for c in cats]
    for c, n in zip(cats, counts):
        got = pq.ParquetFile(os.path.join(path, f"i_category={c}", "part-00000.parquet")).read()
        assert got.num_rows == n and "i_category" not in got.column_names
    assert st["counters"]["ParquetSinkExec.partitions_written"] == len(cats)


def _equal(got: dict, want: dict) -> None:
    for k, v in want.items():
        if np.asarray(v).dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, rtol=1e-9, atol=0)
        else:
            np.testing.assert_array_equal(got[k], v)


def _run(name: str, data, files, st: dict):
    paths = files["paths"]
    if name == "q42":
        return tpcds.run_q42_files(paths, "cpu", stats=st), tpcds.q42_class_oracle(data)
    if name == "q42_orc":
        return (tpcds.run_q42_files({**paths, "store_sales": files["orc"]}, "cpu", stats=st,
                                    fact_fmt="orc"), tpcds.q42_class_oracle(data))
    if name == "q93":
        return tpcds.run_q93_files(paths, device="cpu", stats=st), tpcds.q93_class_oracle(data)
    if name == "q3":
        return tpcds.run_q3_files(paths, device="cpu", stats=st), tpcds.q3_class_oracle(data)
    return (tpcds.run_q3_files({**paths, "store_sales": os.path.dirname(files["sorted"][0])},
                               device="cpu", stats=st, fact_schema=tpcds.RANGE_SORT_SCHEMA,
                               fact_filters=[tpcds.month_filter(data)]),
            tpcds.q3_class_oracle(data))


@pytest.mark.parametrize("name", ["q42", "q42_orc", "q93", "q3", "q3_sorted"])
def test_classes_from_files_equal_their_oracles(data, files, name):
    st: dict = {}
    got, want = _run(name, data, files, st)
    _equal(got, want)
    first = st["tasks"][0]
    scans = {k.split(".", 1)[1]: v for k, v in st["counters"].items()
             if k.split(".")[0] in ("ParquetScanExec", "OrcScanExec")}
    if name in ("q93", "q3", "q3_sorted"):
        # the response pins the map stage to the fact's four file groups
        assert [t["partition"] for t in st["tasks"] if t["stage"] == first["stage"]] == \
            [0, 1, 2, 3]
    if name == "q3_sorted":
        assert scans["row_groups_pruned"] > 0, scans
    if name == "q42_orc":
        assert "stripes_pruned_late" not in scans  # no pushed filter


def test_sorted_write_is_the_range_sort(data, files):
    parts = []
    for f in files["sorted"]:
        t = pq.ParquetFile(f).read()
        part = {}
        for n in t.column_names:
            part[f"{n}_valid"] = t.column(n).is_valid().to_numpy(zero_copy_only=False)
            part[n] = t.column(n).fill_null(0).to_numpy()
        parts.append(part)
        assert pq.ParquetFile(f).metadata.num_row_groups > 1
    assert tpcds.range_sort_mismatch(parts, tpcds.range_sort_oracle(data)) is None


def test_month_filter_holds_exactly_the_month(data):
    ranges = []
    e = tpcds.month_filter(data)
    stack = [e]
    while stack:
        x = stack.pop()
        if x["name"] == "or":
            stack += x["children"]
        else:
            lo, hi = (c["children"][1]["value"] for c in x["children"])
            ranges.append((lo, hi))
    dd = data.date_dim.columns
    want = set(dd["d_date_sk"][dd["d_moy"] == 11].tolist())
    got = {d for lo, hi in ranges for d in range(lo, hi + 1)}
    assert got == want and len(ranges) == 5


@pytest.mark.parametrize("fmt", ["hudi", "iceberg"])
def test_table_format_scan_equals_the_reference(tmp_path, fmt):
    """The resolved table's ``parquet_scan`` through the port's converted
    plan gives the JAX package's ``ParquetScanExec`` rows over the same
    data files."""
    if fmt == "hudi":
        test_hudi._build_table(str(tmp_path))
        node = phudi.resolve_hudi_scan(str(tmp_path))
    else:
        test_iceberg._build_table(str(tmp_path))
        node = piceberg.resolve_iceberg_scan(str(tmp_path))
    node = {**node, "children": []}
    outs = tpcds.run_converted(node, {}, 1, "cpu", nulls=True)
    got = outs[0]
    names = [f[0] for f in node["schema"]]
    files = [f["path"] for f in node["args"]["files"]]
    jschema = JT.Schema(tuple(
        JT.Field(n, {"long": JT.INT64, "int": JT.INT32, "double": JT.FLOAT64,
                     "string": JT.STRING}[t], nullable) for n, t, nullable in node["schema"]))
    want = [r for b in JParquetScan(jschema, files).execute(0, JCtx())
            for r in b.to_arrow().to_pylist()]
    rows = [{n: (got[n][i].item() if hasattr(got[n][i], "item") else got[n][i])
             if got[f"{n}_valid"][i] else None for n in names}
            for i in range(len(got[names[0]]))]
    assert len(want) > 0 and rows == want


def test_importing_the_file_operators_loads_no_pyarrow():
    script = textwrap.dedent("""
        import sys
        import auron_tpu_torch.exec.scan, auron_tpu_torch.exec.sink
        import auron_tpu_torch.plan.planner
        from auron_tpu_torch.models import tpcds
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("pyarrow", "jax",
                                                                       "auron_tpu"))
        assert not loaded, loaded
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
