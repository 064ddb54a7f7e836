"""Slice 18: concurrent task slots (``models/tpcds.run_tasks_parallel``,
``runtime.task.slots``) on the CPU.

- q93, q3 and q72 with their map and reduce tasks on concurrent slots equal
  their sequential answers and the JAX package's (which runs its tasks on
  threads): counts exact, float sums at rel 1e-9; a tail class's tasks too;
- q93 on four slots under a 4,096-byte memory budget: every map task stages
  batches larger than the budget, so each one's second batch must spill
  whatever the threads' timing; the answer equals the oracle (the
  reference's ``num_spills > 0`` on timing-dependent spills is not copied);
- ``run_tasks_parallel`` keeps input order, propagates the first error and
  runs one slot sequentially on the caller's thread;
- a CUDA-graph capture's launch tally is its own thread's: a launch another
  thread counts during a capture stays counted (``ops/launch_count.py``)."""

import threading

import numpy as np
import pytest

from auron_tpu.models import tpcds as jt

from auron_tpu_torch.models import tpcds as pt
from auron_tpu_torch.ops import launch_count
from torch_classes import SF

FLOAT_SUMS = ("s", "p_avg")


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


def _same(got: dict, want: dict, label: str) -> None:
    assert sorted(got) == sorted(want), label
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape and len(w), (label, k)
        if k in FLOAT_SUMS:
            np.testing.assert_allclose(g, w.astype(np.float64), rtol=1e-9, atol=0,
                                       err_msg=f"{label} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {k}")


def _jax(name: str, jd, tmp_path) -> dict:
    out = getattr(jt, f"run_{name}_class")(jd, n_map=4, n_reduce=4, work_dir=str(tmp_path))
    if name == "q72":
        out = out[0]
    dtypes = {"k_null": bool, "rows": np.int64, "matched": np.int64, "s": np.float64,
              "d_year": np.int32, "i_brand_id": np.int32, "item": np.int64, "cnt": np.int64,
              "qty": np.int64, "p_avg": np.float64}
    return {k: out[k].to_numpy(dtypes[k]) for k in out.columns}


@pytest.mark.parametrize("name", ["q93", "q3", "q72"])
def test_concurrent_classes_equal_sequential_and_reference(data, name, tmp_path):
    jd, pd_ = data
    run = getattr(pt, f"run_{name}_class")
    st = {}
    par = run(pd_, device="cpu", parallel=True, stats=st)
    assert st["slots"] == 4
    seq = run(pd_, device="cpu")
    _same(par, seq, f"{name} slots vs sequential")
    _same(par, _jax(name, jd, tmp_path), f"{name} slots vs auron_tpu")


def test_tail_class_tasks_on_slots(data):
    _, pd_ = data
    got = pt.run_q16_class(pd_, device="cpu", conf={"runtime.task.slots": 2})
    want = pt.run_q16_class(pd_, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_concurrent_q93_spills_under_a_budget_below_one_batch(data):
    """Each map task's staged batches (4,096 rows of 16 bytes) are larger
    than the 4,096-byte budget: from its second batch on an acquire finds a
    shortfall that only its own spill clears, on any interleaving."""
    _, pd_ = data
    ing = pt.ingest_q93(pd_, 4, "cpu", fact=pt.to_batches(pd_.store_sales, 4, 4096, "cpu"))
    assert all(len(p) >= 2 for p in ing["fact"])
    st = {}
    got = pt.run_q93_class(device="cpu", parallel=True, ingested=ing, stats=st,
                           conf={"memory.hbm.budget.bytes": 4096})
    _same(got, pt.q93_class_oracle(pd_), "q93 slots under a budget")
    assert st["memory"]["num_spills"] >= 4
    assert st["counters"]["ShuffleWriterExec.spilled_shuffle_runs"] >= 4


def test_run_tasks_parallel_order_errors_and_one_slot():
    seen = []

    def task(i):
        seen.append(threading.get_ident())
        return i * i

    assert pt.run_tasks_parallel([lambda i=i: task(i) for i in range(6)], "cpu") == \
        [i * i for i in range(6)]
    seen.clear()
    assert pt.run_tasks_parallel([lambda i=i: task(i) for i in range(3)], "cpu", slots=1) == \
        [0, 1, 4]
    assert set(seen) == {threading.get_ident()}  # one slot: the caller's thread

    def boom():
        raise ValueError("task 2 failed")

    with pytest.raises(ValueError, match="task 2"):
        pt.run_tasks_parallel([lambda: 1, boom, lambda: 3], "cpu")


def test_capture_tally_keeps_other_threads_launches():
    counts, lock = {"k": 0}, threading.Lock()
    started, release = threading.Event(), threading.Event()

    def other():
        started.wait(5)
        launch_count.add(counts, lock, "k", 2)
        release.set()

    t = threading.Thread(target=other)
    t.start()
    with launch_count.diverted() as tally:
        launch_count.add(counts, lock, "k")  # the capturing thread's own launch
        started.set()
        assert release.wait(5)
    t.join(5)
    assert counts["k"] == 2 and tally[id(counts)] == {"k": 1}
    launch_count.add(counts, lock, "k")
    assert counts["k"] == 3
