"""The join-tail class q33 (two aggregate branches FULL OUTER joined by
item, the key coalesced) gives the same answer from auron_tpu, from
auron_tpu_torch on ``device="cpu"`` and from the port's numpy oracle:
items, NULL sides and counts exact, price sums at rel 1e-9; it runs with
JAX, pyarrow, pandas and protobuf unavailable, and raises on ``cuda``
without a card."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from auron_tpu.models import tpcds as jt

from auron_tpu_torch.models import tpcds as pt
from torch_classes import SF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


def _from_jax(out) -> dict:
    got = {"i": out["i"].to_numpy(np.int64)}
    for k in ("lo", "hi"):
        valid = out[k].notna().to_numpy()
        got[k] = np.where(valid, out[k].fillna(0.0), 0.0).astype(np.float64)
        got[f"{k}_valid"] = valid
    return got


def _assert_same(got: dict, want: dict, label: str) -> None:
    assert sorted(got) == sorted(want), label
    for k, w in want.items():
        if k in ("lo", "hi"):
            np.testing.assert_allclose(got[k], w, rtol=1e-9, atol=0, err_msg=f"{label} {k}")
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=f"{label} {k}")


def test_q33_three_ways(data, monkeypatch):
    from auron_tpu.bridge import api as japi

    from auron_tpu_torch.bridge import api as papi
    from torch_classes import assert_same_tasks, record_tasks

    jd, pdata = data
    jtasks, ptasks = record_tasks(monkeypatch, japi), record_tasks(monkeypatch, papi)
    want = _from_jax(jt.run_q33_class(jd))
    stats: dict = {}
    got = pt.run_q33_class(pdata, device="cpu", stats=stats)
    assert_same_tasks(jtasks, ptasks, "q33")
    _assert_same(got, want, "q33 port vs auron_tpu")
    _assert_same(pt.q33_class_oracle(pdata), want, "q33 oracle vs auron_tpu")
    assert stats["timers"]
    # the full join's build (one aggregate branch) is unique: one probe
    # stream through the compaction boundary, one seed read
    assert stats["counters"]["BroadcastHashJoinExec.unique_streams"] == 1
    assert stats["counters"]["BroadcastHashJoinExec.blocking_reads"] == 1


def test_q33_null_sides_both_ways(data):
    """Items sold only below or only at/above quantity 50 keep a NULL on
    the other side (the full join's probe-outer and build-outer rows)."""
    d = pt.generate(0.005, 5)
    ss = d.store_sales.columns
    side = ss["ss_item_sk"] % 3  # 0: low quantities only, 1: high only, 2: both
    ss["ss_quantity"] = np.where(side == 0, ss["ss_quantity"] % 50,
                                 np.where(side == 1, 50 + ss["ss_quantity"] % 50,
                                          ss["ss_quantity"])).astype(ss["ss_quantity"].dtype)
    got = pt.run_q33_class(d, device="cpu")
    want = pt.q33_class_oracle(d)
    _assert_same(got, want, "q33 small")
    assert (~got["lo_valid"]).any() and (~got["hi_valid"]).any()
    assert (got["lo_valid"] | got["hi_valid"]).all()


def test_join_tail_classes_are_listed_once(data):
    assert pt.JOIN_TAIL_CLASSES == ("q33",)
    assert not set(pt.JOIN_TAIL_CLASSES) & set(pt.TAIL_CLASSES)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pt.run_q33_class(data[1])


def test_q33_runs_without_jax_arrow_pandas_or_protobuf():
    script = textwrap.dedent("""
        import sys
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "jaxlib", "auron_tpu"):
            sys.modules[m] = None  # any import of them raises ImportError
        import numpy as np
        from auron_tpu_torch.models import tpcds
        d = tpcds.generate(0.005, 3)
        got = tpcds.run_q33_class(d, device="cpu",
                                  conf={"exec.selectivity.predictor": "on"})
        want = tpcds.q33_class_oracle(d)
        for k, w in want.items():
            assert np.allclose(got[k], w, rtol=1e-9, atol=0), k
        bad = sorted(m for m in sys.modules if sys.modules[m] is not None and
                     m.split(".")[0] in ("jax", "jaxlib", "auron_tpu", "pandas", "pyarrow"))
        print("OK", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK []" in r.stdout
