"""Slice 6, part B: the q85 (residual condition with a cast), q1, q88
(UNION of bands), q14b (INTERSECT / EXCEPT), q2 (a CTE read twice), q4 (a
CTE chain), q11 (year-over-year self-join) and q15 (EXISTS) classes give
the same answer from auron_tpu, from auron_tpu_torch on ``device="cpu"``
and from the port's numpy oracles (torch_classes.py)."""

import numpy as np
import pytest

from auron_tpu.models import tpcds as jt

from auron_tpu_torch.models import tpcds as pt
from torch_classes import SF, assert_same, run_three_ways

CLASSES = ("q85", "q1", "q88", "q14b", "q2", "q4", "q11", "q15")


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


@pytest.mark.parametrize("name", CLASSES)
def test_class_three_ways(data, name, tmp_path):
    run_three_ways(jt, pt, *data, name, tmp_path)


@pytest.mark.parametrize("year", [1998, 2002, 1990])
def test_q1_any_year_equals_the_oracle(data, year):
    """A year without sales is an empty input: count 0, sum and avg NULL."""
    got = pt.run_q1_class(data[1], year=year, device="cpu")
    want = pt.q1_class_oracle(data[1], year=year)
    assert got["cnt"].tolist() == want["cnt"].tolist()
    if want["cnt"][0]:
        assert_same(got, want, f"q1 {year}")


def test_q85_condition_drops_pairs(data):
    """Without the residual condition every fact row would join."""
    got = pt.run_q85_class(data[1], device="cpu")
    assert 0 < got["n"].sum() < data[1].fact_rows()


def test_q14b_empty_answer_is_null_min_max():
    """At a scale where every item sells every year the EXCEPT is empty:
    count 0, min and max NULL, as the oracle says."""
    d = pt.generate(0.5, 42)
    got = pt.run_q14b_class(d, device="cpu")
    assert_same(got, pt.q14b_class_oracle(d), "q14b empty")
    assert got["c"].tolist() == [0] and not got["lo_valid"][0] and not got["hi_valid"][0]
