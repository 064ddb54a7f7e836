"""Helpers for the three-way tests of the port's expression-tail and
join-tail query classes (tests/test_torch_classes_*.py): the same class
through auron_tpu, through auron_tpu_torch on ``device="cpu"`` and through
the port's numpy oracle, all on ``generate(SF, 42)``. Keys and counts
exact, float sums and averages at rel 1e-9 (the summation order differs)."""

from __future__ import annotations

import numpy as np
import pandas as pd

SF = 0.02
#: answer columns held at rel 1e-9; every other column exactly
FLOAT_SUMS = ("s", "total", "mean", "cheap_s", "all_s", "ratio", "s99", "s98", "a")
_DTYPES = {"y": np.int32, "cat": np.int32, "band": np.int32, "d_year": np.int32,
           "m": np.int32, "c": np.int64, "n": np.int64, "cnt": np.int64, "i": np.int64}


def assert_same(got: dict, want: dict, label: str) -> None:
    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape, (label, k, g.shape, w.shape)
        if k in FLOAT_SUMS:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=f"{label} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {k}")


def from_jax(name: str, out: pd.DataFrame) -> dict:
    """The JAX function's answer as the port's columns and dtypes."""
    out = out.reset_index(drop=True)
    if name == "q14b":  # min and max are NULL when no item is left
        got = {"c": out["c"].to_numpy(np.int64)}
        for k in ("lo", "hi"):
            valid = out[k].notna().to_numpy()
            got[k] = np.where(valid, out[k].fillna(0), 0).astype(np.int64)
            got[f"{k}_valid"] = valid
        return got
    res = {}
    for k in out.columns:
        if k == "cat" and name in ("q17", "q41"):
            res[k] = out[k].to_numpy(object)
        elif k in FLOAT_SUMS:
            res[k] = out[k].to_numpy(np.float64)
        else:
            res[k] = out[k].to_numpy(_DTYPES[k])
    return res


def run_three_ways(jt, pt, jd, pdata, name: str, tmp_path) -> dict:
    """(port answer) after holding it and the oracle against the JAX one."""
    jfn = getattr(jt, f"run_{name}_class")
    jout = jfn(jd, work_dir=str(tmp_path / "jax")) if name == "q16" else jfn(jd)
    want = from_jax(name, jout)
    stats: dict = {}
    got = getattr(pt, f"run_{name}_class")(pdata, device="cpu", stats=stats)
    assert_same(got, want, f"{name} port vs auron_tpu")
    assert_same(getattr(pt, f"{name}_class_oracle")(pdata), want,
                f"{name} oracle vs auron_tpu")
    assert stats["timers"], name
    return got
