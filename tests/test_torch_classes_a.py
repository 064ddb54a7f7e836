"""Slice 6, part A: the q17 (three-way sort-merge join chain), q16 (anti
join after a file shuffle on the nullable customer), q41 (LIKE, DISTINCT
over a dictionary string), q48 and q99 (CASE), q37 (IN) and q6 (a broadcast
aggregate joined under a residual condition) classes give the same answer
from auron_tpu, from auron_tpu_torch on ``device="cpu"`` and from the
port's numpy oracles (torch_classes.py)."""

import numpy as np
import pytest

from auron_tpu.models import tpcds as jt

from auron_tpu_torch.models import tpcds as pt
from torch_classes import SF, assert_same, run_three_ways

CLASSES = ("q17", "q16", "q41", "q48", "q99", "q37", "q6")


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


@pytest.mark.parametrize("name", CLASSES)
def test_class_three_ways(data, name, tmp_path):
    run_three_ways(jt, pt, *data, name, tmp_path)


@pytest.mark.parametrize("mode", ["build", "full", "off"])
def test_q17_every_elision_mode_equals_the_oracle(data, mode):
    """The SMJ chain's answer does not depend on which input sorts run."""
    got = pt.run_q17_class(data[1], device="cpu", conf={"auron.smj.elide.sorts": mode})
    assert_same(got, pt.q17_class_oracle(data[1]), f"q17 {mode}")


@pytest.mark.parametrize("n_map,n_reduce", [(1, 1), (3, 2), (4, 5)])
def test_q16_any_task_count_equals_the_oracle(data, n_map, n_reduce):
    stats: dict = {}
    got = pt.run_q16_class(data[1], n_map=n_map, n_reduce=n_reduce, device="cpu", stats=stats)
    assert_same(got, pt.q16_class_oracle(data[1]), f"q16 {n_map}x{n_reduce}")
    assert len(stats["stage_s"]) == 1 and stats["shuffle_bytes"] > 0


@pytest.mark.parametrize("n", [1, 3])
def test_q6_and_q48_any_partition_count_equal_the_oracle(data, n):
    assert_same(pt.run_q6_class(data[1], n_partitions=n, device="cpu"),
                pt.q6_class_oracle(data[1]), f"q6 {n}")
    assert_same(pt.run_q48_class(data[1], n_map=n, device="cpu"),
                pt.q48_class_oracle(data[1]), f"q48 {n}")


def test_q16_keeps_null_customers(data):
    """With every 50th sale priced above 400, the anti join drops those
    customers' rows; a NULL customer never matches the high-value list, so
    its rows survive."""
    import dataclasses

    ss = data[1].store_sales
    price = ss.columns["ss_ext_sales_price"].copy()
    price[::50] = 450.0
    d = dataclasses.replace(data[1], store_sales=dataclasses.replace(
        ss, columns={**ss.columns, "ss_ext_sales_price": price}))
    nulls = int((~ss.validity("ss_customer_sk")).sum())
    got = pt.run_q16_class(d, n_map=3, n_reduce=3, device="cpu")
    assert_same(got, pt.q16_class_oracle(d), "q16 high prices")
    assert nulls <= got["c"][0] < len(ss) - len(price[::50])


def test_q41_liked_categories(data):
    got = pt.run_q41_class(data[1], device="cpu")
    assert got["cat"].tolist() == sorted({c for c in data[1].item.columns["i_category"]
                                          if "o" in c})
    assert "Books" in got["cat"].tolist() and "Music" not in got["cat"].tolist()
    assert np.all([isinstance(c, str) for c in got["cat"]])
