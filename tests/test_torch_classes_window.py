"""Slice 7: the window, expand and scalar-subquery classes
(``tpcds.WINDOW_CLASSES``) give the same answer from auron_tpu, from
auron_tpu_torch on ``device="cpu"`` and from the port's numpy oracles, on
``generate(SF, 42)`` with the JAX functions' fact prefixes
(``tpcds.WINDOW_PREFIX``); then the port against its oracles on the whole
fact table, as the classes run on a card.

Tolerances: keys, counts, ranks, lag values and validity, and row order
exactly; revenues and sums at rel 1e-9; running sums at |got - want| <=
1e-9 |want| + 16 eps G, G the global prefix sum up to the row
(``tpcds.running_sum_bound``). The windowed class ranks by a float revenue
alone, so beside the exact comparison it is held to its tie rule
(``tpcds.windowed_mismatch``)."""

import numpy as np
import pandas as pd
import pytest

from auron_tpu.models import tpcds as jt

from auron_tpu_torch.models import tpcds as pt
from torch_classes import SF, assert_same_tasks, record_tasks

#: the JAX function of each class
JAX_FUNCS = {"windowed": "run_windowed_query", **{n: f"run_{n}_class"
                                                  for n in pt.WINDOW_CLASSES if n != "windowed"}}
#: running float sums: (column, partition key column)
RUNNING = {"run_sum": "ss_item_sk", "run_rev": "item"}
FLOATS = ("rev", "s", "prev_price")
DTYPES = {"d": np.int64, "item": np.int64, "rk": np.int32, "ss_item_sk": np.int64,
          "ss_sold_date_sk": np.int64, "y": np.int32, "cat": np.int32, "brand": np.int32,
          "i": np.int64, "gid": np.int32, "c": np.int64}


def from_jax(name: str, out: pd.DataFrame) -> dict:
    """The JAX function's answer as the port's columns and dtypes (a NULL
    becomes 0 beside a ``<name>_valid`` column)."""
    out = out.reset_index(drop=True)
    res = {}
    for k in out.columns:
        col = out[k]
        if k in ("d", "i") and name in ("q67", "q67b"):
            valid = col.notna().to_numpy()
            res[k] = np.where(valid, col.fillna(0), 0).astype(np.int64)
            res[f"{k}_valid"] = valid
        elif k == "prev_price":
            valid = col.notna().to_numpy()
            res[k] = np.where(valid, col.fillna(0.0), 0.0).astype(np.float64)
            res[f"{k}_valid"] = valid
        elif k in FLOATS or k in RUNNING:
            res[k] = col.to_numpy(np.float64)
        else:
            res[k] = col.to_numpy(DTYPES[k])
    return res


def assert_same(got: dict, want: dict, label: str) -> None:
    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (label, k, g.shape, w.shape, g.dtype,
                                                           w.dtype)
        if k in RUNNING:
            bound = pt.running_sum_bound(want[RUNNING[k]], w)
            assert (np.abs(g - w) <= bound).all(), (label, k, np.abs(g - w).max())
        elif k in FLOATS:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=f"{label} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {k}")


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


@pytest.mark.parametrize("name", pt.WINDOW_CLASSES)
def test_class_three_ways(data, name, monkeypatch):
    """Also the tasks: the port's equal the reference's field by field."""
    from auron_tpu.bridge import api as japi

    from auron_tpu_torch.bridge import api as papi

    jd, pdata = data
    rows = pt.WINDOW_PREFIX.get(name)
    jtasks, ptasks = record_tasks(monkeypatch, japi), record_tasks(monkeypatch, papi)
    want = from_jax(name, getattr(jt, JAX_FUNCS[name])(jd))
    stats: dict = {}
    got = getattr(pt, f"run_{name}_class")(pdata, device="cpu", stats=stats, rows=rows)
    assert_same_tasks(jtasks, ptasks, name)
    assert_same(got, want, f"{name} port vs auron_tpu")
    assert_same(getattr(pt, f"{name}_class_oracle")(pdata, rows=rows), want,
                f"{name} oracle vs auron_tpu")
    assert stats["timers"] and len(next(iter(want.values()))) > 0, name


@pytest.mark.parametrize("name", pt.WINDOW_CLASSES)
def test_whole_fact_equals_the_oracle(data, name):
    """The whole fact table (no prefix), as on the card."""
    got = getattr(pt, f"run_{name}_class")(data[1], device="cpu")
    want = getattr(pt, f"{name}_class_oracle")(data[1])
    assert_same(got, want, f"{name} whole fact")
    if name == "windowed":
        assert pt.windowed_mismatch(got, pt.windowed_ranks(data[1])) is None


def test_windowed_tie_rule():
    """A tie in cents may take either rank; anything else is refused."""
    d = pt.generate(0.002, 7)
    ss = d.store_sales.columns
    # three sales of one date at the same price in three items: a three-way
    # tie at the top of the date
    ss["ss_sold_date_sk"][:3] = ss["ss_sold_date_sk"][0]
    ss["ss_item_sk"][:3] = [11, 12, 13]
    ss["ss_ext_sales_price"][:3] = 10_000.0
    want = pt.windowed_class_oracle(d)
    ranks = pt.windowed_ranks(d)
    top = want["d"] == ss["ss_sold_date_sk"][0]
    assert want["rk"][top].tolist() == [1, 1, 1]
    assert pt.windowed_mismatch(want, ranks) is None
    split = {k: v.copy() for k, v in want.items()}
    split["rk"][np.flatnonzero(top)[1:]] = 2  # the tie split: 1, 2, 2
    assert pt.windowed_mismatch(split, ranks) is None
    wrong = {k: v.copy() for k, v in want.items()}
    wrong["rk"][np.flatnonzero(~top)[0]] += 1
    assert pt.windowed_mismatch(wrong, ranks) is not None
    short = {k: v[1:] for k, v in want.items()}
    assert pt.windowed_mismatch(short, ranks) is not None


def test_running_sum_bound_is_the_global_prefix():
    part = np.array([1, 1, 2, 2, 2])
    run = np.array([1.0, 3.0, 10.0, 20.0, 30.0])
    eps = np.finfo(np.float64).eps
    np.testing.assert_allclose(pt.running_sum_bound(part, run),
                               1e-9 * run + 16 * eps * np.array([1, 3, 13, 23, 33.0]))


def test_windowed2_keeps_the_first_occurrence():
    d = pt.generate(0.002, 3)
    f = pt.windowed2_fact(d, 3000)
    c = d.store_sales.columns
    keys = c["ss_item_sk"][:3000] * (1 << 32) + c["ss_sold_date_sk"][:3000]
    first = ~pd.Series(keys).duplicated().to_numpy()
    np.testing.assert_array_equal(f.columns["ss_ext_sales_price"],
                                  c["ss_ext_sales_price"][:3000][first])


def test_q9_scalar_subquery_value_reaches_the_filter(data):
    """The subquery task's average is what the filter compares with."""
    pdata = data[1]
    got = pt.run_q9_class(pdata, device="cpu")
    price = pdata.store_sales.columns["ss_ext_sales_price"]
    assert 0 < got["c"][0] < len(price)
    assert got["c"][0] == int((price > price.mean()).sum())
