"""Slice 5 as a whole: the six shuffle-heavy gate classes the port adds
(q72, q95, q18, q14, q65, q5 of ``perf_gate.py``'s HEAVY list) give the
same answer from auron_tpu, from auron_tpu_torch on ``device="cpu"`` and
from the port's numpy oracles: keys and counts exact, float sums and
averages at rel 1e-9 (the summation order differs). q72's second fact
table is pandas' ``sample(frac=0.5, random_state=3)`` without pandas; the
new entry points run with JAX, pyarrow, pandas and protobuf unavailable,
and raise on ``cuda`` without a card."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest
import torch

from auron_tpu.models import tpcds as jt

from auron_tpu_torch.models import tpcds as pt

SF = 0.02
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("q72", "q95", "q18", "q14", "q65", "q5")
#: answer columns held at rel 1e-9; every other column exactly
FLOAT_SUMS = ("p_avg", "q_avg", "p_sum", "a", "s")


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


def _assert_same(got: dict, want: dict, label: str) -> None:
    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    assert len(next(iter(want.values()))) > 0, label
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == np.asarray(w).shape, (label, k)
        if k in FLOAT_SUMS:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=f"{label} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {k}")


def _from_jax(name: str, out) -> dict:
    """The JAX function's answer as the port's columns and dtypes."""
    if name == "q72":
        out = out[0]  # (answer, second fact table)
    if name == "q95":  # a NULL customer sorts last in both
        valid = out["customer"].notna().to_numpy()
        return {"customer": np.where(valid, out["customer"].fillna(0), 0).astype(np.int64),
                "customer_valid": valid, "cnt": out["cnt"].to_numpy(np.int64)}
    dtypes = {"item": np.int64, "cnt": np.int64, "qty": np.int64, "p_avg": np.float64,
              "cat": np.int32, "d_year": np.int32, "q_avg": np.float64, "p_sum": np.float64,
              "y": np.int32, "d_items": np.int64, "i": np.int64, "a": np.float64,
              "m": np.float64, "c": np.int64, "s": np.float64}
    return {k: out[k].to_numpy(dtypes[k]) for k in out.columns}


@pytest.mark.parametrize("name", CLASSES)
def test_gate_class_three_ways(data, name, tmp_path):
    jd, pd_ = data
    want = _from_jax(name, getattr(jt, f"run_{name}_class")(
        jd, n_map=4, n_reduce=4, work_dir=str(tmp_path / "jax")))
    stats: dict = {}
    got = getattr(pt, f"run_{name}_class")(pd_, device="cpu", stats=stats)
    _assert_same(got, want, f"{name} port vs auron_tpu")
    _assert_same(getattr(pt, f"{name}_class_oracle")(pd_), want, f"{name} oracle vs auron_tpu")
    assert stats["shuffle_bytes"] > 0 and stats["reduce_s"] > 0
    assert len(stats["stage_s"]) == (1 if name == "q18" else 2)
    assert stats["map_s"] == pytest.approx(sum(stats["stage_s"].values()))


@pytest.mark.parametrize("mode", ["build", "full", "off"])
def test_q72_every_elision_mode_equals_the_oracle(data, mode):
    """The SMJ's answer does not depend on which input sorts were dropped;
    ``run_q72_class`` defaults to full, as the JAX function's tasks."""
    pd_ = data[1]
    conf = {"auron.smj.elide.sorts": mode}
    got = pt.run_q72_class(pd_, n_map=3, n_reduce=2, device="cpu", conf=conf)
    _assert_same(got, pt.q72_class_oracle(pd_), f"q72 {mode}")
    assert pt.Q72_ELIDE_SORTS == "full"
    with pytest.raises(ValueError, match="build, full or off"):
        pt.run_q72_class(pd_, device="cpu", conf={"auron.smj.elide.sorts": "some"})


def test_q72_second_fact_is_the_reference_sample(data):
    jd, pd_ = data
    sr = jt.run_q72_class(jd, n_map=2, n_reduce=2)[1]
    mine = pt.q72_second_fact(pd_)
    for c in ("ss_item_sk", "ss_sold_date_sk", "ss_quantity", "ss_ext_sales_price"):
        np.testing.assert_array_equal(mine.columns[c], sr[c].to_numpy())


@pytest.mark.parametrize("n", [1, 7, 1000, 57_600, 230_401])
def test_q72_second_fact_rows_equal_pandas_sample(n):
    want = pd.DataFrame({"x": np.arange(n)}).sample(frac=0.5, random_state=3)["x"].to_numpy()
    np.testing.assert_array_equal(pt.q72_second_fact_rows(n), want)


def test_q95_keeps_null_customers_through_the_anti_join(data):
    """A NULL customer never matches the bad-customer list, so its rows
    survive the anti join and count under one NULL group."""
    pd_ = data[1]
    got = pt.run_q95_class(pd_, n_map=2, n_reduce=3, device="cpu")
    assert not got["customer_valid"][-1] and got["customer_valid"][:-1].all()
    ss = pd_.store_sales
    cat1 = np.isin(ss.columns["ss_item_sk"],
                   pd_.item.columns["i_item_sk"][pd_.item.columns["i_category_id"] == 1])
    assert got["cnt"][-1] == int((cat1 & ~ss.validity("ss_customer_sk")).sum()) > 0


@pytest.mark.parametrize("entry", [f"run_{n}_class" for n in CLASSES]
                         + ["run_q72_mesh", "run_skew_join"])
def test_new_cuda_entries_raise_without_a_card(data, entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = pt.skew_data(100) if entry == "run_skew_join" else (data[1],)
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(pt, entry)(*args)


def test_gate_classes_run_without_jax_arrow_pandas_or_protobuf():
    script = textwrap.dedent("""
        import sys
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "jaxlib", "auron_tpu"):
            sys.modules[m] = None  # any import of them raises ImportError
        import numpy as np
        from auron_tpu_torch.models import tpcds
        from auron_tpu_torch.exec.joins import smj
        d = tpcds.generate(0.005, 3)
        for name in ("q72", "q95", "q18", "q14", "q65", "q5"):
            got = getattr(tpcds, f"run_{name}_class")(d, device="cpu")
            want = getattr(tpcds, f"{name}_class_oracle")(d)
            key = next(iter(want))
            assert np.array_equal(got[key], want[key]), (name, got, want)
        for mode in ("mesh", "file"):
            got = tpcds.run_q72_mesh(d, device="cpu", conf={"exchange.mode": mode})
            assert np.array_equal(got["cnt"], tpcds.q72_class_oracle(d)["cnt"])
        fact, dim = tpcds.skew_data(30000)
        st = {}
        got = tpcds.run_skew_join(fact, dim, device="cpu", stats=st)
        assert np.array_equal(got["c"], tpcds.skew_join_oracle(fact, dim)["c"])
        assert len(st["exchanges"][0]["skew_tasks"]) > 4
        bad = sorted(m for m in sys.modules if sys.modules[m] is not None and
                     m.split(".")[0] in ("jax", "jaxlib", "auron_tpu", "pandas", "pyarrow"))
        print("OK", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK []" in r.stdout
