"""Sort-merge join stages through the planned-exchange driver: the same
plan protos (auron_tpu's builders) run through auron_tpu's MeshQueryDriver
on a 4-device CPU mesh and through the port's driver on 4 logical
partitions. AQE skew-join splitting must make the same task table from
the same map output bytes, and the rows must be equal (integers exact,
float averages at rel 1e-9), with splitting on and off. The port's
hand-built q72-mesh and skew trees are what its planner builds from the
elided and pruned protos."""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from auron_tpu import types as JT
from auron_tpu.columnar import Batch as JBatch
from auron_tpu.exprs.ir import col as jcol
from auron_tpu.models import tpcds as jt
from auron_tpu.ops.sortkeys import SortSpec as JSortSpec
from auron_tpu.parallel.mesh import make_mesh as jmake_mesh
from auron_tpu.parallel.mesh_driver import MeshQueryDriver as JDriver
from auron_tpu.plan import builders as B
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.columnar.batch import Batch as PBatch
from auron_tpu_torch.models import tpcds as pt
from auron_tpu_torch.parallel.mesh import make_mesh
from auron_tpu_torch.parallel.mesh_driver import MeshQueryDriver
from auron_tpu_torch.plan import optimizer as poptimizer
from auron_tpu_torch.plan import planner as pplanner
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import canon, port_schema, rows

P = 4


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(P)


def _port_proto(plan):
    return pplanner._pb().PhysicalPlanNode.FromString(plan.SerializeToString())


def _schema(df):
    return JT.Schema.from_arrow(pa.RecordBatch.from_pandas(df.iloc[:1],
                                                           preserve_index=False).schema)


def _both_partitioned(df, rid):
    per = (len(df) + P - 1) // P
    chunks = [df.iloc[p * per:(p + 1) * per] for p in range(P)]
    jparts = [[JBatch.from_arrow(pa.RecordBatch.from_pandas(c, preserve_index=False))]
              for c in chunks]
    ps = port_schema(_schema(df))
    pparts = [[PBatch.from_numpy([c[f.name].to_numpy() for f in ps], ps, device="cpu")]
              for c in chunks]
    return {rid: jparts}, {rid: pparts}


def _run_both(jmesh, plan, jres, pres, conf):
    jd = JDriver(jmesh, conf=JConf(dict(conf)))
    want = jd.run(plan, jres)
    pdr = MeshQueryDriver(make_mesh(P, device="cpu"), conf=PConf(dict(conf)))
    got = pdr.run(_port_proto(plan), pres)
    return got, want, pdr, jd


def _assert_rows_equal(got_parts, want_parts, float_cols=()):
    got = canon(rows([b for p in got_parts for b in p]))
    want = canon(rows([b for p in want_parts for b in p]))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert [x for i, x in enumerate(g) if i not in float_cols] == \
            [x for i, x in enumerate(w) if i not in float_cols]
        for i in float_cols:
            np.testing.assert_allclose(g[i], w[i], rtol=1e-9, atol=0)


def _assert_stats_equal(pdr, jd):
    assert [s.exchange_id for s in pdr.stats] == [s.exchange_id for s in jd.stats]
    for g, w in zip(pdr.stats, jd.stats):
        assert g.mode == w.mode
        np.testing.assert_array_equal(g.rows, np.asarray(w.rows))
        assert g.coalesced_groups == w.coalesced_groups
        assert g.skew_tasks == w.skew_tasks


# ---- the skew plan of tests/test_exchange_planned.py ----------------------------


def _skew_plan(l_schema, r_schema):
    lex = B.mesh_exchange(B.memory_scan(l_schema, "skew_l"), B.hash_partitioning([jcol(0)], P),
                          "skew_ex_l")
    rex = B.mesh_exchange(B.memory_scan(r_schema, "skew_r"), B.hash_partitioning([jcol(0)], P),
                          "skew_ex_r")
    j = B.sort_merge_join(B.sort(lex, [(jcol(0), JSortSpec())]),
                          B.sort(rex, [(jcol(0), JSortSpec())]), [jcol(0)], [jcol(0)], "inner")
    p = B.hash_agg(j, [(jcol(0), "k")], [("count_star", None, "c"), ("sum", jcol(3), "w")],
                   "partial")
    ex2 = B.mesh_exchange(p, B.hash_partitioning([jcol(0)], P), "skew_ex2")
    return B.hash_agg(ex2, [(jcol(0), "k")], [("count_star", None, "c"), ("sum", jcol(1), "w")],
                      "final")


def _skew_inputs(n, hot_frac):
    fact, dim = pt.skew_data(n, hot_frac)
    fdf, ddf = pd.DataFrame(fact.columns), pd.DataFrame(dim.columns)
    jres, pres = _both_partitioned(fdf, "skew_l")
    jd, pdim = _both_partitioned(ddf, "skew_r")
    return _skew_plan(_schema(fdf), _schema(ddf)), {**jres, **jd}, {**pres, **pdim}, fact, dim


@pytest.mark.parametrize("hot_frac", [0.7, 0.9])
@pytest.mark.parametrize("enable", [True, False])
def test_skew_split_matches_jax(jmesh, enable, hot_frac):
    plan, jres, pres, fact, dim = _skew_inputs(30000, hot_frac)
    conf = {**pt.SKEW_CONF, "exchange.skew.join.enable": enable}
    got, want, pdr, jd = _run_both(jmesh, plan, jres, pres, conf)
    _assert_stats_equal(pdr, jd)
    _assert_rows_equal(got, want)
    st = {s.exchange_id: s for s in pdr.stats}
    if enable:  # the hot partition split: the join stage ran more than P tasks
        assert len(st["skew_ex_l"].skew_tasks) > P and st["skew_ex2"].rows.shape[0] > P
        assert len(st["skew_ex_r"].skew_tasks) == len(st["skew_ex_l"].skew_tasks)
    else:
        assert st["skew_ex_l"].skew_tasks is None and st["skew_ex2"].rows.shape[0] == P
    oracle = pt.skew_join_oracle(fact, dim)
    assert sorted(rows([b for p in got for b in p])) == list(
        zip(oracle["k"].tolist(), oracle["c"].tolist(), oracle["w"].tolist()))


def test_run_skew_join_matches_the_jax_driver(jmesh):
    """The hand-built tree through ``run_skew_join`` splits as the JAX
    driver splits the proto, and answers the same."""
    plan, jres, _, fact, dim = _skew_inputs(30000, 0.7)
    jd = JDriver(jmesh, conf=JConf(dict(pt.SKEW_CONF)))
    want = jd.collect(plan, jres).sort_values("k").reset_index(drop=True)
    st: dict = {}
    got = pt.run_skew_join(fact, dim, device="cpu", stats=st)
    for k in ("k", "c", "w"):
        np.testing.assert_array_equal(got[k], want[k].to_numpy(np.int64))
    jtasks = {s.exchange_id: s.skew_tasks for s in jd.stats}
    assert {ex["id"]: ex["skew_tasks"] for ex in st["exchanges"]} == jtasks


def test_skew_split_refused_for_a_left_join_hot_on_the_right(jmesh):
    """A left join may split only its left side: a right side that is the
    hot one stays whole, in both drivers."""
    fact, dim = pt.skew_data(30000, 0.7)
    fdf, ddf = pd.DataFrame(fact.columns), pd.DataFrame(dim.columns)
    jres, pres = _both_partitioned(ddf, "skew_l")
    jr2, pr2 = _both_partitioned(fdf, "skew_r")
    lex = B.mesh_exchange(B.memory_scan(_schema(ddf), "skew_l"),
                          B.hash_partitioning([jcol(0)], P), "skew_ex_l")
    rex = B.mesh_exchange(B.memory_scan(_schema(fdf), "skew_r"),
                          B.hash_partitioning([jcol(0)], P), "skew_ex_r")
    j = B.sort_merge_join(lex, rex, [jcol(0)], [jcol(0)], "left")
    p = B.hash_agg(j, [(jcol(0), "k2")], [("count_star", None, "c")], "partial")
    plan = B.hash_agg(B.mesh_exchange(p, B.hash_partitioning([jcol(0)], P), "skew_ex2"),
                      [(jcol(0), "k2")], [("count_star", None, "c")], "final")
    got, want, pdr, jd = _run_both(jmesh, plan, {**jres, **jr2}, {**pres, **pr2}, pt.SKEW_CONF)
    _assert_stats_equal(pdr, jd)
    _assert_rows_equal(got, want)
    assert all(s.skew_tasks is None for s in pdr.stats)


# ---- q72 as one plan ----------------------------------------------------------------


def _q72_proto(jd):
    schema = jt._schema_of(jd.store_sales)
    specs = [(jcol(1), JSortSpec()), (jcol(0), JSortSpec())]
    lex = B.mesh_exchange(B.memory_scan(schema, "q72_l"), B.hash_partitioning([jcol(1)], P),
                          "q72_ex_l")
    rex = B.mesh_exchange(B.memory_scan(schema, "q72_r"), B.hash_partitioning([jcol(1)], P),
                          "q72_ex_r")
    smj = B.sort_merge_join(B.sort(lex, specs), B.sort(rex, specs), [jcol(1), jcol(0)],
                            [jcol(1), jcol(0)], "inner")
    proj = B.project(smj, [(jcol(1), "item"), (jcol(3), "qty"), (jcol(9), "price")])
    aggs = [("count_star", None, "cnt"), ("sum", jcol(1), "qty"), ("avg", jcol(2), "p_avg")]
    partial = B.hash_agg(proj, [(jcol(0), "item")], aggs, "partial")
    ex2 = B.mesh_exchange(partial, B.hash_partitioning([jcol(0)], P), "q72_ex2")
    return B.hash_agg(ex2, [(jcol(0), "item")], aggs, "final")


@pytest.fixture(scope="module")
def tpcds_data():
    return jt.generate(0.02, 42), pt.generate(0.02, 42)


@pytest.mark.parametrize("mode", ["mesh", "file"])
def test_q72_plan_matches_jax(jmesh, tpcds_data, mode):
    """q72 as one plan with an SMJ stage between two exchanges and a
    third. The JAX driver runs the file transport: its SortExec cannot sort
    a mesh-transport receive batch on a CPU mesh, so the port's mesh
    transport is held against the JAX file transport's answer."""
    jd_, pd_ = tpcds_data
    sr = jd_.store_sales.sample(frac=0.5, random_state=3).reset_index(drop=True)
    jres = {"q72_l": jt.to_batches(jd_.store_sales, P), "q72_r": jt.to_batches(sr, P)}
    ing = pt.ingest_q72(pd_, P, device="cpu")
    pres = {"q72_l": ing["fact"], "q72_r": ing["fact2"]}
    plan = _q72_proto(jd_)
    jd = JDriver(jmesh, conf=JConf({"exchange.mode": "file"}))
    want = jd.run(plan, jres)
    pdr = MeshQueryDriver(make_mesh(P, device="cpu"), conf=PConf({"exchange.mode": mode}))
    got = pdr.run(_port_proto(plan), pres)
    if mode == "file":
        _assert_stats_equal(pdr, jd)
    for g, w in zip(pdr.stats, jd.stats):
        # the file transport coalesces the small join stage's outputs into
        # one task, so the last exchange's sources differ: its totals do not
        assert g.mode == mode
        np.testing.assert_array_equal(g.partition_sizes(), np.asarray(w.rows).sum(axis=0))
    for g, w in zip(pdr.stats[:2], jd.stats[:2]):
        np.testing.assert_array_equal(g.rows, np.asarray(w.rows))
    _assert_rows_equal(got, want, float_cols=(3,))
    oracle = pt.q72_class_oracle(pd_)
    mine = pt.run_q72_mesh(device="cpu", conf={"exchange.mode": mode}, ingested=ing)
    for k in ("item", "cnt", "qty"):
        np.testing.assert_array_equal(mine[k], oracle[k])
    np.testing.assert_allclose(mine["p_avg"], oracle["p_avg"], rtol=1e-9, atol=0)


def _describe(op) -> list:
    """Operator types and everything that defines them, as comparable text."""
    name = type(op).__name__
    d = [name, repr(op.schema)]
    if name in ("ResourceScanExec", "IpcReaderExec"):
        d.append(op.resource_id)
    elif name == "ProjectExec":
        d += [repr(op.exprs), op.names]
    elif name == "HashAggExec":
        d += [repr(op.groupings), repr(op.aggs), op.mode]
    elif name == "SortExec":
        d += [repr(op.sort_exprs), repr(op.specs), op.fetch]
    elif name == "MeshExchangeExec":
        d += [repr(op.partitioning), op.exchange_id]
    elif name == "SortMergeJoinExec":
        dr = op.driver
        d += [repr(dr.left_keys), repr(dr.right_keys), dr.join_type, dr.build_side,
              dr.projection]
    return [d] + [_describe(c) for c in op.children]


def _planned(plan, mode="off"):
    elided = poptimizer.elide_smj_input_sorts(_port_proto(plan), mode=mode)
    return pplanner.plan_from_proto(poptimizer.prune_columns(elided))


@pytest.mark.parametrize("mode", ["build", "full", "off"])
def test_hand_built_q72_tree_matches_the_planner(tpcds_data, mode):
    """The port's q72 mesh plan is the reference driver's plan, byte for
    byte, and plans to the same tree under each elision mode."""
    want = _q72_proto(tpcds_data[0])
    assert pt.q72_mesh_plan(P).SerializeToString() == want.SerializeToString(deterministic=True)
    assert _describe(_planned(pt.q72_mesh_plan(P), mode)) == _describe(_planned(want, mode))


def test_hand_built_skew_tree_matches_the_planner():
    plan = _skew_inputs(100, 0.7)[0]
    assert pt.skew_join_plan(P).SerializeToString() == plan.SerializeToString(deterministic=True)
    assert _describe(_planned(pt.skew_join_plan(P))) == _describe(_planned(plan))
