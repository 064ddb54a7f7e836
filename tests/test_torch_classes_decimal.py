"""The port's decimal paths at SF 0.02 (``tpcds.DECIMAL_CLASSES``): q9b
(the reference's wide-decimal class; its overflowing group NULL), q3 and
q42 with TPC-DS's money type decimal(7,2), and the windowed class over
decimal revenues. Each equals its exact oracle, and the same tree run
through the JAX package's planner and operators (q9b: its own function),
exactly: decimals compare as Decimals or as int64 unscaled values."""

import decimal as pydec

import numpy as np
import pytest

from auron_tpu import types as JT
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exprs.ir import BinaryOp, Cast, col, lit
from auron_tpu.models import tpcds as jt
from auron_tpu.ops.sortkeys import SortSpec
from auron_tpu.plan import builders as B
from auron_tpu.plan import planner as jplanner

from auron_tpu_torch.models import tpcds as pt

SF = 0.02
MONEY = JT.decimal(7, 2)


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


def _jax_rows(plan, resources: dict) -> list[tuple]:
    ctx = JCtx(resources=resources)
    out = []
    for b in jplanner.plan_from_proto(plan).execute(0, ctx):
        out.extend(zip(*b.to_pydict().values()))
    return out


def _cents(x, scale: int = 2) -> int:
    return JT.unscaled_int(x, scale)


def _schemas(jd):
    return (jt._schema_of(jd.store_sales), jt._schema_of(jd.date_dim), jt._schema_of(jd.item))


def _same(got: dict, want: dict, label: str) -> None:
    assert sorted(got) == sorted(want), label
    for k in want:
        assert np.asarray(got[k]).tolist() == np.asarray(want[k]).tolist(), (label, k)


def test_q9b_equals_oracle_and_reference(data, monkeypatch):
    from auron_tpu.bridge import api as japi

    from auron_tpu_torch.bridge import api as papi
    from torch_classes import assert_same_tasks, record_tasks

    jd, pdata = data
    jtasks, ptasks = record_tasks(monkeypatch, japi), record_tasks(monkeypatch, papi)
    stats: dict = {}
    got = pt.run_q9b_class(pdata, device="cpu", stats=stats)
    want = pt.q9b_class_oracle(pdata)
    _same(got, want, "q9b oracle")
    assert got["s"][7] is None and got["c"][7] > 1011  # the poisoned group overflows
    assert all(s is not None for s in got["s"][:7])
    ref = jt.run_q9b_class(jd)
    assert_same_tasks(jtasks, ptasks, "q9b")
    assert ref["g"].tolist() == got["g"].tolist()
    for k in ("s", "mn", "mx"):
        assert [None if (v is None or v != v) else pydec.Decimal(v) for v in ref[k]] == \
            list(got[k]), k
    assert ref["c"].tolist() == got["c"].tolist()
    assert stats["timers"]


def test_q3_decimal_equals_oracle_and_reference(data):
    jd, pdata = data
    stats: dict = {}
    got = pt.run_q3_decimal_class(pdata, device="cpu", stats=stats)
    _same(got, pt.q3_decimal_class_oracle(pdata), "q3 decimal oracle")
    assert got["s"].dtype == np.int64 and len(got["s"])
    assert stats["shuffle_bytes"] > 0
    ss, dd, it = _schemas(jd)
    j1 = B.hash_join(B.memory_scan(ss, "f"),
                     B.filter_(B.memory_scan(dd, "d"), [BinaryOp("eq", col(2), lit(11))]),
                     [col(0)], [col(0)], "inner", build_side="right")
    j2 = B.hash_join(j1, B.filter_(B.memory_scan(it, "i"), [BinaryOp("eq", col(2), lit(1))]),
                     [col(1)], [col(0)], "inner", build_side="right")
    proj = B.project(j2, [(col(6), "d_year"), (col(9), "i_brand_id"),
                          (Cast(col(4), MONEY), "price")])
    p = B.hash_agg(proj, [(col(0), "d_year"), (col(1), "i_brand_id")],
                   [("sum", col(2), "s")], "partial")
    f = B.hash_agg(p, [(col(0), "d_year"), (col(1), "i_brand_id")],
                   [("sum", col(2), "s")], "final")
    res = {"f": [[b for part in jt.to_batches(jd.store_sales, 4) for b in part]],
           "d": [[jt.to_batches(jd.date_dim, 1)[0][0]]], "i": [[jt.to_batches(jd.item, 1)[0][0]]]}
    rows = _jax_rows(f, res)
    assert str(jplanner.plan_from_proto(f).schema[2].dtype) == "decimal(17,2)"
    ref = pt._top_k(np.array([r[0] for r in rows], np.int64),
                    np.array([r[1] for r in rows], np.int64),
                    np.array([_cents(r[2]) for r in rows], np.int64), 100)
    _same(got, ref, "q3 decimal vs auron_tpu")


def test_q42_decimal_equals_oracle_and_reference(data, monkeypatch):
    """Also the port's task: the plan below from the reference's builders."""
    from auron_tpu_torch.bridge import api as papi
    from torch_classes import assert_same_tasks, record_tasks

    jd, pdata = data
    ptasks = record_tasks(monkeypatch, papi)
    got = pt.run_q42_decimal_class(pdata, device="cpu")
    _same(got, pt.q42_decimal_class_oracle(pdata), "q42 decimal oracle")
    ss, _, it = _schemas(jd)
    j = B.hash_join(B.memory_scan(ss, "q42_fact"), B.memory_scan(it, "q42_item"), [col(1)],
                    [col(0)], "inner", build_side="right")
    pr = B.project(j, [(col(6), "brand"), (Cast(col(4), MONEY), "p"), (col(3), "q")])
    p = B.hash_agg(pr, [(col(0), "brand")], [("sum", BinaryOp("mul", col(1), col(2)), "rev"),
                                             ("avg", col(1), "avg_price")], "partial")
    f = B.hash_agg(p, [(col(0), "brand")], [("sum", col(1), "rev"),
                                            ("avg", col(2), "avg_price")], "final")
    plan = B.sort(f, [(col(1), SortSpec(asc=False)), (col(0), SortSpec())], fetch=10)
    assert_same_tasks([B.task(plan).SerializeToString()], ptasks, "q42 decimal")
    fin = jplanner.plan_from_proto(f).schema
    assert [str(x.dtype) for x in fin][1:] == ["decimal(28,2)", "decimal(11,6)"]
    rows = _jax_rows(plan, {"q42_fact": jt.to_batches(jd.store_sales, 1),
                            "q42_item": jt.to_batches(jd.item, 1)})
    ref = {"brand": np.array([r[0] for r in rows], np.int32),
           "rev": np.array([_cents(r[1]) for r in rows], np.int64),
           "avg_price": np.array([_cents(r[2], 6) for r in rows], np.int64)}
    _same(got, ref, "q42 decimal vs auron_tpu")


def test_windowed_decimal_equals_oracle_and_reference(data, monkeypatch):
    """Also the port's task: the plan below from the reference's builders."""
    from auron_tpu_torch.bridge import api as papi
    from torch_classes import assert_same_tasks, record_tasks

    jd, pdata = data
    rows_ = pt.WINDOW_PREFIX["windowed"]
    ptasks = record_tasks(monkeypatch, papi)
    got = pt.run_windowed_decimal_class(pdata, device="cpu", rows=rows_)
    _same(got, pt.windowed_decimal_class_oracle(pdata, rows_), "windowed decimal oracle")
    ss, _, _ = _schemas(jd)
    p = B.hash_agg(B.memory_scan(ss, "qw_fact"), [(col(0), "d"), (col(1), "item")],
                   [("sum", Cast(col(4), MONEY), "rev")], "partial")
    f = B.hash_agg(p, [(col(0), "d"), (col(1), "item")], [("sum", col(2), "rev")], "final")
    w = B.window(f, [col(0)], [(col(2), SortSpec(asc=False))],
                 [("rank", None, None, 1, False, "rk")])
    assert_same_tasks([B.task(w).SerializeToString()], ptasks, "windowed decimal")
    fact = jt.to_batches(jd.store_sales.iloc[:rows_], 2)
    rows = [r for r in _jax_rows(w, {"qw_fact": [[b for part in fact for b in part]]})
            if r[3] <= 2]
    rows.sort(key=lambda r: (r[0], r[3], r[1]))
    ref = {"d": np.array([r[0] for r in rows], np.int64),
           "item": np.array([r[1] for r in rows], np.int64),
           "rev": np.array([_cents(r[2]) for r in rows], np.int64),
           "rk": np.array([r[3] for r in rows], np.int32)}
    _same(got, ref, "windowed decimal vs auron_tpu")
