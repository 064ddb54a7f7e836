"""Slice 2 as a whole: the two-stage file-shuffle queries. q93-class (null-
skew left join, one nullable int64 shuffle key through K1) and q3-class
(the flagship: two joins, partial aggregate, shuffle on two int32 keys,
final aggregate, driver top-k) give the same answer from auron_tpu, from
auron_tpu_torch's entry points, from auron_tpu_torch fed the JAX
builders' serialized tasks, and from the numpy oracles; and the port runs
both with pyarrow, pandas, protobuf and JAX unavailable."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest
import torch

from auron_tpu import types as JT
from auron_tpu.exprs.ir import BinaryOp, If, IsNull, Literal
from auron_tpu.exprs.ir import col as jcol
from auron_tpu.models import tpcds as jt
from auron_tpu.plan import builders as B

from auron_tpu_torch.bridge import api as papi
from auron_tpu_torch.exec.shuffle.reader import MultiMapBlockProvider
from auron_tpu_torch.models import tpcds as pt
from auron_tpu_torch.plan import planner as pplanner

SF = 0.02
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


def _assert_q93(got: dict, want: dict):
    assert got["k_null"].tolist() == want["k_null"].tolist()
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["matched"], want["matched"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)


def _frame_q93(df: pd.DataFrame) -> dict:
    return {"k_null": df["k_null"].to_numpy(bool), "rows": df["rows"].to_numpy(np.int64),
            "matched": df["matched"].to_numpy(np.int64), "s": df["s"].to_numpy(np.float64)}


def _assert_q3(got: dict, want: dict):
    np.testing.assert_array_equal(got["d_year"], want["d_year"])
    np.testing.assert_array_equal(got["i_brand_id"], want["i_brand_id"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)


@pytest.mark.parametrize("n_map,n_reduce", [(2, 3), (4, 4)])
def test_q93_three_ways(data, n_map, n_reduce, tmp_path):
    jd, pd_ = data
    want = _frame_q93(jt.run_q93_class(jd, n_map=n_map, n_reduce=n_reduce,
                                       work_dir=str(tmp_path / "jax")))
    stats: dict = {}
    got = pt.run_q93_class(pd_, n_map=n_map, n_reduce=n_reduce, device="cpu", stats=stats)
    _assert_q93(got, want)
    _assert_q93(pt.q93_class_oracle(pd_), want)
    assert want["rows"][1] > 0.8 * want["rows"].sum()  # the NULL skew
    # every NULL key landed in pmod(42, n_reduce)
    null_part = stats["partition_rows"][42 % n_reduce]
    assert null_part >= want["rows"][1]
    assert sum(stats["partition_rows"]) == want["rows"].sum()
    assert stats["shuffle_bytes"] > 0 and stats["map_s"] > 0 and stats["reduce_s"] > 0


def test_q3_three_ways(data, tmp_path):
    jd, pd_ = data
    w = jt.run_q3_class(jd, n_map=4, n_reduce=4, work_dir=str(tmp_path))
    want = {"d_year": w["d_year"].to_numpy(np.int32),
            "i_brand_id": w["i_brand_id"].to_numpy(np.int32), "s": w["s"].to_numpy()}
    assert len(want["s"]) == 100
    _assert_q3(pt.run_q3_class(pd_, n_map=4, n_reduce=4, device="cpu"), want)
    _assert_q3(pt.q3_class_oracle(pd_), want)
    o = jt.q3_class_oracle(jd)
    _assert_q3(pt.q3_class_oracle(pd_), {"d_year": o["d_year"].to_numpy(),
                                         "i_brand_id": o["i_brand_id"].to_numpy(),
                                         "s": o["s"].to_numpy()})


def test_q3_other_filters_and_limit(data):
    _, pd_ = data
    got = pt.run_q3_class(pd_, n_map=3, n_reduce=2, moy=2, category_id=7, limit=7,
                          device="cpu")
    _assert_q3(got, pt.q3_class_oracle(pd_, moy=2, category_id=7, limit=7))
    assert len(got["s"]) == 7


def test_q93_through_serialized_tasks(data, tmp_path):
    """The JAX builders' TaskDefinition bytes (shuffle_writer with hash
    partitioning on an if_expr key, ipc_reader, left hash_join) run on the
    port's bridge and give the port's own answer."""
    jd, pd_ = data
    n_map, n_reduce = 2, 3
    fact_schema = jt._schema_of(jd.store_sales)
    ingested = pt.ingest_q93(pd_, n_map, device="cpu")
    papi.put_resource("q93_fact", ingested["fact"])
    papi.put_resource("q93_cust", [ingested["cust"]] * n_reduce)
    try:
        key = If(BinaryOp("lt", jcol(3), Literal(85, JT.INT32)), Literal(None, JT.INT64),
                 jcol(2))
        proj = B.project(B.memory_scan(fact_schema, "q93_fact"),
                         [(key, "k"), (jcol(4), "price")])
        part = B.hash_partitioning([jcol(0)], n_reduce)
        pairs = []
        for p in range(n_map):
            d, i = str(tmp_path / f"m{p}.data"), str(tmp_path / f"m{p}.index")
            task = B.task(B.shuffle_writer(proj, part, d, i), stage_id=1, partition_id=p)
            with papi.native_task(task.SerializeToString(), device="cpu") as h:
                assert papi.next_batch(h) is None
            pairs.append((d, i))
        papi.put_resource("q93_ex0", MultiMapBlockProvider(pairs))
        inter = JT.Schema((JT.Field("k", JT.INT64, True), JT.Field("price", JT.FLOAT64, True)))
        cu_schema = JT.Schema((JT.Field("c_customer_sk", JT.INT64, True),
                               JT.Field("c_band", JT.INT64, True)))
        j = B.hash_join(B.ipc_reader(inter, "q93_ex0"), B.memory_scan(cu_schema, "q93_cust"),
                        [jcol(0)], [jcol(0)], "left", build_side="right")
        pa_ = B.hash_agg(j, [(IsNull(jcol(0)), "k_null")],
                         [("count_star", None, "rows"), ("count", jcol(2), "matched"),
                          ("sum", jcol(1), "s")], "partial")
        f = B.hash_agg(pa_, [(jcol(0), "k_null")],
                       [("count_star", None, "rows"), ("count", jcol(1), "matched"),
                        ("sum", jcol(2), "s")], "final")
        outs = []
        for r in range(n_reduce):
            task = B.task(f, stage_id=2, partition_id=r)
            with papi.native_task(task.SerializeToString(), device="cpu") as h:
                while (b := papi.next_batch(h)) is not None:
                    outs.append(pt.collect([b]))
    finally:
        for k in ("q93_fact", "q93_cust", "q93_ex0"):
            papi.remove_resource(k)
    k_null = np.concatenate([o["k_null"] for o in outs])
    got = {"k_null": np.array([False, True]),
           "rows": np.array([np.concatenate([o["rows"] for o in outs])[k_null == k].sum()
                             for k in (False, True)]),
           "matched": np.array([np.concatenate([o["matched"] for o in outs])[k_null == k].sum()
                                for k in (False, True)]),
           "s": np.array([np.concatenate([o["s"] for o in outs])[k_null == k].sum()
                          for k in (False, True)])}
    _assert_q93(got, pt.q93_class_oracle(pd_))


def test_planner_partitionings():
    from auron_tpu_torch.exec.shuffle.partitioning import (
        HashPartitioning, RangePartitioning, RoundRobinPartitioning, SinglePartitioning,
    )
    from auron_tpu_torch.exprs.ir import col as pcol
    from auron_tpu_torch.ops.sortkeys import SortSpec
    from auron_tpu_torch.plan import builders as PB

    pb = pplanner._pb()

    def conv(p):
        return pplanner.partitioning_from_proto(pb.Partitioning.FromString(
            p.SerializeToString()))

    h = conv(B.hash_partitioning([jcol(0), jcol(1)], 7))
    assert isinstance(h, HashPartitioning) and h.num_partitions == 7 and len(h.exprs) == 2
    rr = conv(pb.Partitioning(kind=pb.Partitioning.ROUND_ROBIN, num_partitions=5))
    assert isinstance(rr, RoundRobinPartitioning) and rr.num_partitions == 5
    assert isinstance(conv(pb.Partitioning(kind=pb.Partitioning.SINGLE)), SinglePartitioning)
    rg = pb.Partitioning(kind=pb.Partitioning.RANGE, num_partitions=3, range_words_per_bound=2,
                         range_bound_words=[1, 2**63 + 5, 0, 7])
    rg.range_fields.add().CopyFrom(PB.sort_field(pcol(0), SortSpec(asc=False)))
    r = conv(rg)
    assert isinstance(r, RangePartitioning) and r.num_partitions == 3
    assert r.bound_words.tolist() == [[1, 2**63 + 5], [0, 7]] and not r.specs[0].asc


def test_two_stage_queries_run_without_jax_arrow_pandas_or_protobuf():
    script = textwrap.dedent("""
        import sys
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "jaxlib", "auron_tpu"):
            sys.modules[m] = None  # any import of them raises ImportError
        import numpy as np
        from auron_tpu_torch.models import tpcds
        d = tpcds.generate(0.005, 3)
        got = tpcds.run_q93_class(d, n_map=2, n_reduce=3, device="cpu")
        want = tpcds.q93_class_oracle(d)
        assert np.array_equal(got["rows"], want["rows"]), (got, want)
        assert np.array_equal(got["matched"], want["matched"]), (got, want)
        q3 = tpcds.run_q3_class(d, n_map=2, n_reduce=2, device="cpu")
        o3 = tpcds.q3_class_oracle(d)
        assert np.array_equal(q3["i_brand_id"], o3["i_brand_id"]), (q3, o3)
        print("OK", len(q3["s"]))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout


def test_two_stage_cuda_entries_without_card_raise(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pt.run_q93_class(data[1])
    with pytest.raises(RuntimeError, match="cuda"):
        pt.run_q3_class(data[1])
