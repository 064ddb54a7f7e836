"""Helpers for the three-way tests of the port's expression-tail and
join-tail query classes (tests/test_torch_classes_*.py): the same class
through auron_tpu, through auron_tpu_torch on ``device="cpu"`` and through
the port's numpy oracle, all on ``generate(SF, 42)``. Keys and counts
exact, float sums and averages at rel 1e-9 (the summation order differs).

Plan-IR parity: while the reference function runs (the run that gives the
reference answer, no extra one), ``record_tasks`` keeps the bytes of every
task it starts, and the same for the port's function; ``assert_same_tasks``
decodes both with the port's codec (``proto/wire.py``) and holds them equal
field by field, paths under each side's work directory masked."""

from __future__ import annotations

import numpy as np
import pandas as pd

from auron_tpu_torch import proto as pb
from auron_tpu_torch.proto.wire import FieldDescriptor as FD

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


def run_three_ways(jt, pt, jd, pdata, name: str, tmp_path, monkeypatch) -> dict:
    """(port answer) after holding it and the oracle against the JAX one,
    and the port's tasks against the reference's (``assert_same_tasks``)."""
    from auron_tpu.bridge import api as japi

    from auron_tpu_torch.bridge import api as papi

    jwork, pwork = str(tmp_path / "jax"), str(tmp_path / "port")
    jtasks, ptasks = record_tasks(monkeypatch, japi), record_tasks(monkeypatch, papi)
    jfn, pfn = getattr(jt, f"run_{name}_class"), getattr(pt, f"run_{name}_class")
    shuffled = name == "q16"
    jout = jfn(jd, work_dir=jwork) if shuffled else jfn(jd)
    want = from_jax(name, jout)
    stats: dict = {}
    got = (pfn(pdata, device="cpu", stats=stats, work_dir=pwork) if shuffled
           else pfn(pdata, device="cpu", stats=stats))
    assert_same(got, want, f"{name} port vs auron_tpu")
    assert_same(getattr(pt, f"{name}_class_oracle")(pdata), want,
                f"{name} oracle vs auron_tpu")
    assert stats["timers"], name
    assert_same_tasks(jtasks, ptasks, name, jwork, pwork)
    assert stats["task_bytes"] == sum(map(len, ptasks)) and stats["plan_s"] > 0, name
    return got


def record_tasks(monkeypatch, api) -> list:
    """The bytes of every task ``api`` (``auron_tpu.bridge.api`` or
    ``auron_tpu_torch.bridge.api``) starts from now on, in start order.
    Both bridges' ``native_task`` starts its task through the module's
    ``call_native`` (the reference's q3 and q18 map tasks call it
    directly), so wrapping that one entry sees every task; the wrapper
    calls through to the original."""
    seen: list = []
    original = api.call_native

    def call_native(task, *args, **kwargs):
        seen.append(bytes(task))
        return original(task, *args, **kwargs)

    monkeypatch.setattr(api, "call_native", call_native)
    return seen


def _fields(msg, work: str):
    """A decoded message as nested dicts and lists by field name; strings
    under ``work`` start with ``<work>`` instead."""
    out = {}
    for fd, v in msg.ListFields():
        if fd.is_map:
            out[fd.name] = dict(v.items())
        elif fd.label == FD.LABEL_REPEATED:
            out[fd.name] = [_fields(x, work) if fd.type == FD.TYPE_MESSAGE else x for x in v]
        elif fd.type == FD.TYPE_MESSAGE:
            out[fd.name] = _fields(v, work)
        elif isinstance(v, str) and work and v.startswith(work):
            out[fd.name] = "<work>" + v[len(work):]
        else:
            out[fd.name] = v
    return out


def _first_difference(a, b, path: str = "task") -> str | None:
    if type(a) is not type(b):
        return f"{path}: {a!r} != {b!r}"
    if isinstance(a, dict):
        for k in sorted(set(a) | set(b)):
            if k not in a or k not in b:
                return f"{path}.{k}: only on the {'port' if k in b else 'reference'} side"
            d = _first_difference(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, list):
        if len(a) != len(b):
            return f"{path}: {len(a)} entries != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = _first_difference(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} != {b!r}"


def decoded_tasks(tasks: list, work: str = "") -> list:
    """Each task's fields (``_fields``), ordered by (stage, partition, the
    text of the fields): the reference starts a stage's tasks on threads."""
    out = [_fields(pb.TaskDefinition.FromString(t), work) for t in tasks]
    return sorted(out, key=lambda f: (f.get("stage_id", 0), f.get("partition_id", 0), repr(f)))


def assert_same_tasks(jtasks: list, ptasks: list, label: str, jwork: str = "",
                      pwork: str = "") -> None:
    """The reference's and the port's tasks equal field by field (the same
    number, each pair equal), paths under each work directory masked."""
    want, got = decoded_tasks(jtasks, jwork), decoded_tasks(ptasks, pwork)
    assert want, f"{label}: the reference started no task"
    assert len(got) == len(want), (label, len(got), len(want))
    for w, g in zip(want, got):
        diff = _first_difference(w, g)
        assert diff is None, f"{label}: {diff}"
