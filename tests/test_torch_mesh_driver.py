"""Slice 3 as a whole: the planned-exchange driver. The same plan protos
(built with auron_tpu's builders) run through auron_tpu's MeshQueryDriver on
a 4-device CPU mesh and through the port's driver on 4 logical partitions
(``device="cpu"``) under exchange.mode = mesh, file and auto. Rows must be
equal (integer columns exact; float sums at rel 1e-9, since the summation
order differs), and so must the routing matrix, the transport, the payload
estimate and the AQE coalesced groups. The port's hand-built q93/q3 mesh
trees are what its planner builds from the pruned protos, and the port runs
them with JAX, pyarrow, pandas and protobuf unavailable."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from auron_tpu import types as JT
from auron_tpu.columnar import Batch as JBatch
from auron_tpu.exprs.ir import BinaryOp, If, IsNull, Literal, lit
from auron_tpu.exprs.ir import col as jcol
from auron_tpu.models import tpcds as jt
from auron_tpu.parallel.mesh import make_mesh as jmake_mesh
from auron_tpu.parallel.mesh_driver import MeshQueryDriver as JDriver
from auron_tpu.plan import builders as B
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.columnar.batch import Batch as PBatch
from auron_tpu_torch.exec.basic import ResourceScanExec
from auron_tpu_torch.models import tpcds as pt
from auron_tpu_torch.parallel.mesh import make_mesh
from auron_tpu_torch.parallel.mesh_driver import MeshExchangeExec, MeshQueryDriver
from auron_tpu_torch.plan import optimizer as poptimizer
from auron_tpu_torch.plan import planner as pplanner
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import canon, port_schema, rows

P = 4
SF = 0.02
MODES = ("mesh", "file", "auto")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(P)


@pytest.fixture(scope="module")
def tpcds_data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


# ---- the two packages side by side ------------------------------------------


def _port_proto(plan):
    """The JAX builders' proto as the port's plan_pb2 message."""
    return pplanner._pb().PhysicalPlanNode.FromString(plan.SerializeToString())


def _run_both(jmesh, plan, jres: dict, pres: dict, conf: dict):
    jd = JDriver(jmesh, conf=JConf(dict(conf)))
    want = jd.run(plan, jres)
    pd_ = MeshQueryDriver(make_mesh(P, device="cpu"), conf=PConf(dict(conf)))
    got = pd_.run(_port_proto(plan), pres)
    return got, want, pd_, jd


def _assert_rows_equal(got_parts, want_parts, float_cols=()):
    """Same rows (order-free): integer/string columns exact, the float
    columns at rel 1e-9 (summation order differs)."""
    got = rows([b for p in got_parts for b in p])
    want = rows([b for p in want_parts for b in p])
    assert len(got) == len(want)

    def key(r):
        return tuple(x for i, x in enumerate(r) if i not in float_cols)

    got, want = canon(got), canon(want)
    got.sort(key=lambda r: repr(key(r)))
    want.sort(key=lambda r: repr(key(r)))
    for g, w in zip(got, want):
        assert key(g) == key(w)
        for i in float_cols:
            np.testing.assert_allclose(g[i], w[i], rtol=1e-9, atol=0)


def _assert_stats_equal(pd_, jd):
    assert len(pd_.stats) == len(jd.stats)
    for g, w in zip(pd_.stats, jd.stats):
        assert g.exchange_id == w.exchange_id and g.mode == w.mode
        np.testing.assert_array_equal(g.rows, np.asarray(w.rows))
        assert g.est_bytes_per_shard == w.est_bytes_per_shard
        assert g.coalesced_groups == w.coalesced_groups
        assert (g.slot_cap is not None) == (g.mode == "mesh")


# ---- the two-stage group-by of test_exchange_planned.py -----------------------


def _fact(n=2000, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": np.zeros(n, np.int64) if skew else rng.integers(0, 97, n),
        "g2": rng.integers(0, 7, n).astype(np.int64),
        "v": rng.integers(-1000, 1000, n).astype(np.int64),
    })


def _schema(df):
    return JT.Schema.from_arrow(pa.RecordBatch.from_pandas(df.iloc[:1],
                                                           preserve_index=False).schema)


def _both_partitioned(df, rid="fact"):
    per = (len(df) + P - 1) // P
    chunks = [df.iloc[p * per:(p + 1) * per] for p in range(P)]
    jparts = [[JBatch.from_arrow(pa.RecordBatch.from_pandas(c, preserve_index=False))]
              for c in chunks]
    ps = port_schema(_schema(df))
    pparts = [[PBatch.from_numpy([c[f.name].to_numpy() for f in ps], ps, device="cpu")]
              for c in chunks]
    return {rid: jparts}, {rid: pparts}


def _two_stage_plan(schema):
    scan = B.memory_scan(schema, "fact")
    partial = B.hash_agg(scan, [(jcol(0), "k"), (jcol(1), "g2")], [("sum", jcol(2), "s")],
                         "partial")
    ex = B.mesh_exchange(partial, B.hash_partitioning([jcol(0), jcol(1)], P), "ex0")
    return B.hash_agg(ex, [(jcol(0), "k"), (jcol(1), "g2")], [("sum", jcol(2), "s")], "final")


@pytest.mark.parametrize("mode", MODES)
def test_two_stage_group_by_matches_jax(jmesh, mode):
    df = _fact()
    jres, pres = _both_partitioned(df)
    got, want, pd_, jd = _run_both(jmesh, _two_stage_plan(_schema(df)), jres, pres,
                                   {"exchange.mode": mode})
    _assert_rows_equal(got, want)
    _assert_stats_equal(pd_, jd)
    assert pd_.stats[0].mode == ("file" if mode == "file" else "mesh")
    assert pd_.stats[0].rows.shape == (P, P) and pd_.stats[0].rows.sum() > 0
    oracle = df.groupby(["k", "g2"]).v.sum()
    assert len(rows([b for p in got for b in p])) == len(oracle)


@pytest.mark.parametrize("mode", MODES)
def test_dictionary_string_key_routes_by_bytes(jmesh, mode):
    """A string group key: rows route by murmur3 of the bytes (not the
    codes), each shard's vocabulary is unified (mesh) or rides its blocks
    (file), and the final groups are the reference's."""
    df = _fact(n=2000, seed=3)
    df["k"] = df["k"].map(lambda x: f"key_{x}")
    jres, pres = _both_partitioned(df)
    got, want, pd_, jd = _run_both(jmesh, _two_stage_plan(_schema(df)), jres, pres,
                                   {"exchange.mode": mode})
    _assert_rows_equal(got, want)
    _assert_stats_equal(pd_, jd)
    keys = {r[0] for r in rows([b for p in got for b in p])}
    assert keys == set(df["k"])


@pytest.mark.parametrize("mode", MODES)
def test_fully_skewed_raw_exchange_matches_jax(jmesh, mode):
    """Every raw row to one reducer: slots sized from the exact counts."""
    df = _fact(n=3000, seed=5, skew=True)
    scan = B.memory_scan(_schema(df), "fact")
    ex = B.mesh_exchange(scan, B.hash_partitioning([jcol(0)], P), "ex_skew")
    plan = B.hash_agg(ex, [(jcol(0), "k")],
                      [("sum", jcol(2), "s"), ("count_star", None, "c")], "partial")
    jres, pres = _both_partitioned(df)
    got, want, pd_, jd = _run_both(jmesh, plan, jres, pres, {"exchange.mode": mode})
    _assert_rows_equal(got, want)
    _assert_stats_equal(pd_, jd)
    sizes = pd_.stats[0].partition_sizes()
    assert (sizes > 0).sum() == 1 and sizes.sum() == len(df)
    if mode != "file":
        assert pd_.stats[0].slot_cap == 1024  # 3000 / 4 sources -> bucket of 750


def test_auto_mode_switches_on_the_payload_estimate(jmesh):
    df = _fact(n=1000, seed=7)
    jres, pres = _both_partitioned(df)
    conf = {"exchange.mode": "auto", "exchange.mesh.max.bytes": 1}
    got, want, pd_, jd = _run_both(jmesh, _two_stage_plan(_schema(df)), jres, pres, conf)
    assert pd_.stats[0].mode == jd.stats[0].mode == "file"
    _assert_rows_equal(got, want)
    _assert_stats_equal(pd_, jd)


@pytest.mark.parametrize("enable", [True, False])
def test_aqe_coalescing_groups_match_jax(jmesh, enable):
    df = _fact(n=400, seed=11)
    jres, pres = _both_partitioned(df)
    conf = {"exchange.mode": "file", "exchange.coalesce.target.bytes": 1 << 20,
            "exchange.coalesce.enable": enable}
    got, want, pd_, jd = _run_both(jmesh, _two_stage_plan(_schema(df)), jres, pres, conf)
    _assert_stats_equal(pd_, jd)
    groups = pd_.stats[0].coalesced_groups
    if enable:
        assert groups is not None and 1 <= len(groups) < P and len(got) == len(groups)
        assert sorted(p for g in groups for p in g) == list(range(P))
    else:
        assert groups is None and len(got) == P
    _assert_rows_equal(got, want)


def test_coalescing_skipped_when_another_source_feeds_the_stage(jmesh):
    """A reduce stage with a second per-partition input keeps its width."""
    df = _fact(n=400, seed=13)
    dim = pd.DataFrame({"k2": np.arange(97, dtype=np.int64),
                        "tag": np.arange(97, dtype=np.int64) * 10})
    scan = B.memory_scan(_schema(df), "fact")
    partial = B.hash_agg(scan, [(jcol(0), "k")], [("sum", jcol(2), "s")], "partial")
    ex = B.mesh_exchange(partial, B.hash_partitioning([jcol(0)], P), "exj")
    final = B.hash_agg(ex, [(jcol(0), "k")], [("sum", jcol(1), "s")], "final")
    plan = B.hash_join(final, B.memory_scan(_schema(dim), "dim"), [jcol(0)], [jcol(0)],
                       "inner", build_side="right")
    jres, pres = _both_partitioned(df)
    jdim, pdim = _both_partitioned(dim, "dim")
    jres["dim"] = [[b for part in jdim["dim"] for b in part]] * P
    pres["dim"] = [[b for part in pdim["dim"] for b in part]] * P
    conf = {"exchange.mode": "file", "exchange.coalesce.target.bytes": 1 << 20}
    got, want, pd_, jd = _run_both(jmesh, plan, jres, pres, conf)
    assert pd_.stats[0].coalesced_groups is None
    _assert_stats_equal(pd_, jd)
    _assert_rows_equal(got, want)


# ---- q93-class and q3-class plans ------------------------------------------


def _q93_proto(jd):
    key = If(BinaryOp("lt", jcol(3), Literal(85, JT.INT32)), Literal(None, JT.INT64), jcol(2))
    proj = B.project(B.memory_scan(jt._schema_of(jd.store_sales), "q93_fact"),
                     [(key, "k"), (jcol(4), "price")])
    ex = B.mesh_exchange(proj, B.hash_partitioning([jcol(0)], P), "q93_ex0")
    cu = JT.Schema((JT.Field("c_customer_sk", JT.INT64, True),
                    JT.Field("c_band", JT.INT64, True)))
    j = B.hash_join(ex, B.memory_scan(cu, "q93_cust"), [jcol(0)], [jcol(0)], "left",
                    build_side="right")
    p = B.hash_agg(j, [(IsNull(jcol(0)), "k_null")],
                   [("count_star", None, "rows"), ("count", jcol(2), "matched"),
                    ("sum", jcol(1), "s")], "partial")
    return B.hash_agg(p, [(jcol(0), "k_null")],
                      [("count_star", None, "rows"), ("count", jcol(1), "matched"),
                       ("sum", jcol(2), "s")], "final")


def _q93_resources(data):
    jd, pd_ = data
    cust = pd.DataFrame({"c_customer_sk": np.arange(1, 5001, dtype=np.int64),
                         "c_band": np.arange(1, 5001, dtype=np.int64) % 5})
    jres = {"q93_fact": jt.to_batches(jd.store_sales, P),
            "q93_cust": [[JBatch.from_pandas(cust)]] * P}
    ing = pt.ingest_q93(pd_, P, device="cpu")
    return jres, {"q93_fact": ing["fact"], "q93_cust": [ing["cust"]] * P}


def _q3_map_proto(jd, moy=11, category_id=1):
    scan = B.memory_scan(jt._schema_of(jd.store_sales), "q3_fact")
    dscan = B.filter_(B.memory_scan(jt._schema_of(jd.date_dim), "q3_dd"),
                      [BinaryOp("eq", jcol(2), lit(moy))])
    iscan = B.filter_(B.memory_scan(jt._schema_of(jd.item), "q3_item"),
                      [BinaryOp("eq", jcol(2), lit(category_id))])
    j1 = B.hash_join(scan, dscan, [jcol(0)], [jcol(0)], "inner", build_side="right",
                     cached_build_id="q3_dd_build")
    j2 = B.hash_join(j1, iscan, [jcol(1)], [jcol(0)], "inner", build_side="right",
                     cached_build_id="q3_it_build")
    proj = B.project(j2, [(jcol(6), "d_year"), (jcol(9), "i_brand_id"), (jcol(4), "price")])
    return B.hash_agg(proj, [(jcol(0), "d_year"), (jcol(1), "i_brand_id")],
                      [("sum", jcol(2), "s")], "partial")


def _q3_proto(jd):
    ex = B.mesh_exchange(_q3_map_proto(jd), B.hash_partitioning([jcol(0), jcol(1)], P),
                         "q3_ex0")
    return B.hash_agg(ex, [(jcol(0), "d_year"), (jcol(1), "i_brand_id")],
                      [("sum", jcol(2), "s")], "final")


def _q3_resources(data):
    jd, pd_ = data
    ji = jt.ingest_q3(jd, P)
    jres = {"q3_fact": ji["fact"], "q3_dd": [ji["dd"]] * P, "q3_item": [ji["it"]] * P}
    ing = pt.ingest_q3(pd_, P, device="cpu")
    return jres, {"q3_fact": ing["fact"], "q3_dd": [ing["dd"]] * P,
                  "q3_item": [ing["item"]] * P}


@pytest.mark.parametrize("mode", MODES)
def test_q93_class_plan_matches_jax(jmesh, tpcds_data, mode):
    jres, pres = _q93_resources(tpcds_data)
    got, want, pd_, jd = _run_both(jmesh, _q93_proto(tpcds_data[0]), jres, pres,
                                   {"exchange.mode": mode})
    _assert_rows_equal(got, want, float_cols=(3,))
    _assert_stats_equal(pd_, jd)
    # the null skew: pmod(42, 4) = 2 receives most rows
    sizes = pd_.stats[0].partition_sizes()
    assert sizes[42 % P] > 0.8 * sizes.sum()


@pytest.mark.parametrize("mode", MODES)
def test_q3_class_plan_matches_jax(jmesh, tpcds_data, mode):
    jres, pres = _q3_resources(tpcds_data)
    got, want, pd_, jd = _run_both(jmesh, _q3_proto(tpcds_data[0]), jres, pres,
                                   {"exchange.mode": mode})
    _assert_rows_equal(got, want, float_cols=(2,))
    _assert_stats_equal(pd_, jd)


@pytest.mark.parametrize("mode", MODES)
def test_run_mesh_entry_points_match_oracles(tpcds_data, mode):
    """run_q93_mesh / run_q3_mesh (the hand-built trees, warm-up and timed
    style: the same ingest twice) against the numpy oracles and the JAX
    package's own two-stage answers."""
    jd, pd_ = tpcds_data
    ing93, ing3 = pt.ingest_q93(pd_, P, device="cpu"), pt.ingest_q3(pd_, P, device="cpu")
    want93, want3 = pt.q93_class_oracle(pd_), pt.q3_class_oracle(pd_)
    for _ in range(2):
        st: dict = {}
        got = pt.run_q93_mesh(device="cpu", conf={"exchange.mode": mode}, stats=st,
                              ingested=ing93)
        np.testing.assert_array_equal(got["k_null"], want93["k_null"])
        np.testing.assert_array_equal(got["rows"], want93["rows"])
        np.testing.assert_array_equal(got["matched"], want93["matched"])
        np.testing.assert_allclose(got["s"], want93["s"], rtol=1e-9, atol=0)
        assert st["mode"] == ("file" if mode == "file" else "mesh")
        assert np.asarray(st["routing"]).sum() == pd_.fact_rows()
        assert st["launches"] == {"murmur3_pmod": 0, "partition_histogram": 0}  # CPU tensors
        assert st["peak_bytes"] is None
        assert min(st["map_s"], st["exchange_s"], st["reduce_s"]) > 0
        st3: dict = {}
        got3 = pt.run_q3_mesh(device="cpu", conf={"exchange.mode": mode}, stats=st3,
                              ingested=ing3)
        for k in ("d_year", "i_brand_id"):
            np.testing.assert_array_equal(got3[k], want3[k])
        np.testing.assert_allclose(got3["s"], want3["s"], rtol=1e-9, atol=0)
        assert len(got3["s"]) == 100 and st3["collect_s"] > 0
    j93 = jt.q93_class_oracle(jd)
    np.testing.assert_array_equal(got["rows"], j93["rows"].to_numpy())


def _describe(op) -> list:
    """Operator types and everything that defines them, as comparable text."""
    name = type(op).__name__
    d = [name, repr(op.schema)]
    if name in ("ResourceScanExec", "IpcReaderExec"):
        d.append(op.resource_id)
    elif name == "ProjectExec":
        d += [repr(op.exprs), op.names]
    elif name == "FilterExec":
        d.append(repr(op.predicates))
    elif name == "HashAggExec":
        d += [repr(op.groupings), repr(op.aggs), op.mode]
    elif name == "SortExec":
        d += [repr(op.sort_exprs), repr(op.specs), op.fetch]
    elif name == "LimitExec":
        d.append(op.limit)
    elif name == "MeshExchangeExec":
        d += [repr(op.partitioning), op.exchange_id]
    elif name == "BroadcastHashJoinExec":
        dr = op.driver
        d += [repr(dr.left_keys), repr(dr.right_keys), dr.join_type, dr.build_side,
              dr.projection, op.cached_build_id]
    return [d] + [_describe(c) for c in op.children]


def _planned(plan):
    return pplanner.plan_from_proto(poptimizer.prune_columns(_port_proto(plan)))


def test_hand_built_mesh_trees_match_the_planner(tpcds_data):
    jd = tpcds_data[0]
    assert _describe(pt.q93_mesh_tree(P)) == _describe(_planned(_q93_proto(jd)))
    q3 = pt.q3_mesh_tree(P)
    assert _describe(q3) == _describe(_planned(_q3_proto(jd)))
    # the lowered SQL q3's collect stage: ORDER BY d_year, s DESC, brand
    # with fetch, then LIMIT, over the gathered stage output
    from auron_tpu.ops.sortkeys import SortSpec

    collect = B.limit(B.sort(B.memory_scan(_jax_schema(q3.schema), "q3_stage"),
                             [(jcol(0), SortSpec()), (jcol(2), SortSpec(asc=False)),
                              (jcol(1), SortSpec())], fetch=100), 100)
    assert pt.q3_collect_plan(q3.schema, 100).SerializeToString() == \
        collect.SerializeToString(deterministic=True)
    assert _describe(_planned(pt.q3_collect_plan(q3.schema, 100))) == _describe(_planned(collect))


def _jax_schema(ps):
    return JT.Schema(tuple(JT.Field(f.name, JT.DataType(JT.TypeKind(f.dtype.kind.value)),
                                    f.nullable) for f in ps))


# ---- the driver's contract ---------------------------------------------------


def test_driver_keeps_the_callers_tree_and_rejects_misuse(tpcds_data):
    pd_ = tpcds_data[1]
    tree = pt.q93_mesh_tree(P)
    before = _describe(tree)
    ing = pt.ingest_q93(pd_, P, device="cpu")
    res = {"q93_fact": ing["fact"], "q93_cust": [ing["cust"]] * P}
    driver = MeshQueryDriver(make_mesh(P, device="cpu"))
    first = driver.run(tree, dict(res))
    second = driver.run(tree, dict(res))
    assert _describe(tree) == before  # still holds its MeshExchangeExec
    assert rows([b for p in first for b in p]) == rows([b for p in second for b in p])
    cols = driver.collect(tree, dict(res))  # host numpy columns
    assert sorted(cols) == ["k_null", "matched", "rows", "s"]
    assert int(cols["rows"].sum()) == pd_.fact_rows()
    # an unresolved exchange never streams
    ex = next(c for c in _walk(tree) if isinstance(c, MeshExchangeExec))
    from auron_tpu_torch.exec.base import ExecutionContext

    with pytest.raises(ValueError, match="stage boundary resolved by"):
        list(ex.execute(0, ExecutionContext(resources=res, device="cpu")))
    with pytest.raises(ValueError, match="4 partitions on a 2-partition mesh"):
        MeshQueryDriver(make_mesh(2, device="cpu")).run(pt.q93_mesh_tree(P), dict(res))
    # one process ignores spmd=True, as the JAX driver does
    spmd = MeshQueryDriver(make_mesh(P, device="cpu"), spmd=True)
    assert not spmd.spmd and spmd.local_parts == list(range(P))
    assert rows([b for p in spmd.run(tree, dict(res)) for b in p]) == \
        rows([b for p in first for b in p])
    with pytest.raises(ValueError, match="exchange.mode"):
        MeshQueryDriver(make_mesh(P, device="cpu"), PConf({"exchange.mode": "ici"})).run(
            pt.q93_mesh_tree(P), dict(res))


def _walk(op):
    yield op
    for c in op.children:
        yield from _walk(c)


@pytest.mark.parametrize("mode", ("mesh", "file"))
def test_each_shard_is_hashed_once(tpcds_data, mode):
    """The routing counts and the file transport's writers share one
    partition-id pass per map shard; the answer stays the oracle's."""
    pd_ = tpcds_data[1]
    tree = pt.q93_mesh_tree(P)
    ex = next(c for c in _walk(tree) if isinstance(c, MeshExchangeExec))
    part = ex.partitioning
    calls = []
    real = type(part).partition_ids

    def counted(batch, ctx):
        calls.append(ctx.partition_id)
        return real(part, batch, ctx)

    part.partition_ids = counted
    ing = pt.ingest_q93(pd_, P, device="cpu")
    res = {"q93_fact": ing["fact"], "q93_cust": [ing["cust"]] * P}
    driver = MeshQueryDriver(make_mesh(P, device="cpu"), PConf({"exchange.mode": mode}))
    got = pt._q93_by_key([pt.collect(o) for o in driver.run(tree, res)])
    assert sorted(calls) == list(range(P))
    assert driver.stats[0].mode == mode
    np.testing.assert_array_equal(got["rows"], pt.q93_class_oracle(pd_)["rows"])


def test_skew_split_detection_finds_a_single_sort_merge_join():
    """``_find_single_smj`` accepts a stage whose one sort-merge join sits
    below only per-partition-safe operators (a partial aggregate) with
    per-row operators and whole-input sorts down to its exchange leaves,
    and refuses a partition-scoped ancestor (a final aggregate, a limit), a
    fetch sort below the join, and more than one join. A self-join on one
    exchange is found but never split (its slices would collide), and plans
    without a join keep their width."""
    from auron_tpu_torch.exec.agg_exec import AggExpr, HashAggExec
    from auron_tpu_torch.exec.basic import FilterExec, LimitExec, ProjectExec
    from auron_tpu_torch.exec.joins.smj import SortMergeJoinExec
    from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec
    from auron_tpu_torch.exec.sort_exec import SortExec
    from auron_tpu_torch.exprs.ir import BinaryOp as PBinaryOp, col as pcol, lit as plit
    from auron_tpu_torch.ops.sortkeys import SortSpec as PSortSpec
    from auron_tpu_torch.parallel.mesh_driver import _find_single_smj

    schema = pt.SKEW_FACT_SCHEMA

    def sort(child, fetch=None):
        return SortExec(child, [pcol(0)], [PSortSpec()], fetch=fetch)

    def smj(left, right):
        return SortMergeJoinExec(left, right, [pcol(0)], [pcol(0)], "inner")

    def agg(child, mode):
        return HashAggExec(child, [(pcol(0), "k")], [(AggExpr("count_star", None), "c")], mode)

    a, b = IpcReaderExec(schema, "a"), IpcReaderExec(schema, "b")
    per_row = FilterExec(ProjectExec(a, [pcol(0), pcol(1)], ["k", "v"]),
                         [PBinaryOp("gt", pcol(1), plit(0))])
    join = smj(sort(per_row), sort(b))
    assert _find_single_smj(join) is join
    assert _find_single_smj(agg(join, "partial")) is join
    for refused in (agg(join, "final"), LimitExec(join, 10), smj(sort(a, fetch=5), b),
                    smj(agg(a, "partial"), b), ProjectExec(smj(join, smj(a, b)), [pcol(0)], ["k"])):
        assert _find_single_smj(refused) is None
    driver = MeshQueryDriver(make_mesh(P, device="cpu"))
    assert driver._maybe_split_skew(pt.q93_mesh_tree(P), {}) == P
    assert driver._maybe_split_skew(pt.q3_mesh_tree(P), {}) == P
    # a self-join on one just-resolved exchange, hot in partition 0: found, not split
    per_map = np.array([[1000, 1, 1, 1]] * P, dtype=np.int64)
    driver._coalesce_candidates = {"a": (None, per_map.sum(axis=0), per_map)}
    self_join = smj(sort(a), IpcReaderExec(schema, "a"))
    assert _find_single_smj(self_join) is self_join
    assert driver._maybe_split_skew(self_join, {}) == P
    assert "a" in driver._coalesce_candidates  # nothing consumed


def test_mesh_queries_run_without_jax_arrow_pandas_or_protobuf():
    script = textwrap.dedent("""
        import sys
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "jaxlib", "auron_tpu"):
            sys.modules[m] = None  # any import of them raises ImportError
        import numpy as np
        from auron_tpu_torch.models import tpcds
        from auron_tpu_torch.parallel import broadcast, exchange, mesh, mesh_driver
        d = tpcds.generate(0.005, 3)
        for mode in ("mesh", "file"):
            got = tpcds.run_q93_mesh(d, device="cpu", conf={"exchange.mode": mode})
            want = tpcds.q93_class_oracle(d)
            assert np.array_equal(got["rows"], want["rows"]), (got, want)
            q3 = tpcds.run_q3_mesh(d, device="cpu", conf={"exchange.mode": mode})
            o3 = tpcds.q3_class_oracle(d)
            assert np.array_equal(q3["i_brand_id"], o3["i_brand_id"]), (q3, o3)
        bad = sorted(m for m in sys.modules if sys.modules[m] is not None and
                     m.split(".")[0] in ("jax", "jaxlib", "auron_tpu", "pandas", "pyarrow"))
        print("OK", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK []" in r.stdout


def test_mesh_cuda_entries_without_card_raise(tpcds_data):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pt.run_q93_mesh(tpcds_data[1])
    with pytest.raises(RuntimeError, match="cuda"):
        pt.run_q3_mesh(tpcds_data[1])


# ---- a window above a skew-splittable join is not sliced --------------------


def _window_over_skew_join(l_schema, r_schema, order_col: int):
    """The skew plan's join stage (two mesh exchanges, sorts, SMJ), then a
    window per join key in the same stage: rank and dense_rank by
    ``order_col``, the partition's count and sum."""
    from auron_tpu.ops.sortkeys import SortSpec

    def side(schema, rid, ex_id):
        ex = B.mesh_exchange(B.memory_scan(schema, rid), B.hash_partitioning([jcol(0)], P),
                             ex_id)
        return B.sort(ex, [(jcol(0), SortSpec())])

    j = B.sort_merge_join(side(l_schema, "skew_l", "skew_ex_l"),
                          side(r_schema, "skew_r", "skew_ex_r"), [jcol(0)], [jcol(0)], "inner")
    return B.window(j, [jcol(0)], [(jcol(order_col), SortSpec())],
                    [("rank", None, None, 1, False, "rk"),
                     ("dense_rank", None, None, 1, False, "dr"),
                     ("agg", "count", jcol(1), 1, True, "n"),
                     ("agg", "sum", jcol(3), 1, True, "tw")])


@pytest.mark.parametrize("order_col", [1, 3])
def test_window_above_a_skewed_join_is_not_split(jmesh, order_col):
    """AQE skew splitting would run the hot partition as several slices,
    and a window over a slice sees part of its partition: the driver must
    leave such a stage whole (``_partition_scoped`` covers WindowExec). The
    answer equals the JAX driver's and the port's own run with splitting
    off, and the hot key's count is all of its rows."""
    fact, dim = pt.skew_data(30000, 0.7)
    fdf, ddf = pd.DataFrame(fact.columns), pd.DataFrame(dim.columns)
    jres, pres = _both_partitioned(fdf, "skew_l")
    jd_, pdim = _both_partitioned(ddf, "skew_r")
    jres, pres = {**jres, **jd_}, {**pres, **pdim}
    plan = _window_over_skew_join(_schema(fdf), _schema(ddf), order_col)
    got, want, pdr, jd = _run_both(jmesh, plan, jres, pres, pt.SKEW_CONF)
    assert [s.skew_tasks for s in pdr.stats] == [None, None]
    assert [s.skew_tasks for s in jd.stats] == [None, None]
    _assert_rows_equal(got, want)
    off = MeshQueryDriver(make_mesh(P, device="cpu"), conf=PConf(
        {**pt.SKEW_CONF, "exchange.skew.join.enable": False})).run(_port_proto(plan), pres)
    assert canon(rows([b for p in got for b in p])) == canon(rows([b for p in off for b in p]))
    hot = [r for r in rows([b for p in got for b in p]) if r[0] == 7]
    assert {r[6] for r in hot} == {int((fact.columns["k"] == 7).sum())}


def test_rename_columns_is_slice_safe_below_a_join():
    """A RenameColumnsExec between the SMJ and its exchange leaf keeps the
    stage splittable, as in the JAX driver."""
    from auron_tpu_torch.exec.basic import RenameColumnsExec
    from auron_tpu_torch.exec.window_exec import WindowExec
    from auron_tpu_torch.parallel import mesh_driver as pmd

    from auron_tpu_torch.exec.joins.smj import SortMergeJoinExec
    from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec
    from auron_tpu_torch.exec.sort_exec import SortExec
    from auron_tpu_torch.exprs.ir import col
    from auron_tpu_torch.ops.sortkeys import SortSpec

    def side(schema, rid, rename):
        read = IpcReaderExec(schema, rid)  # an exchange leaf, as the driver resolves it
        read = RenameColumnsExec(read, ["a", "b"]) if rename else read
        return SortExec(read, [col(0)], [SortSpec()])

    for rename in (False, True):
        smj = SortMergeJoinExec(side(pt.SKEW_FACT_SCHEMA, "l", rename),
                                side(pt.SKEW_DIM_SCHEMA, "r", False), [col(0)], [col(0)], "inner")
        assert pmd._find_single_smj(smj) is smj
        assert pmd._find_single_smj(WindowExec(smj, [col(0)], [], [])) is None
