"""The port's class gate (``auron_tpu_torch.models.tpcds.run_gate``), the
counterpart of the reference's ``tpcds.run_gate``: the same 42 cases, names
and order, the same ``(name, ok, error, seconds)`` records and comparison
(``compare_frames``, floats at rel 1e-6), each class with the reference
function's task counts and fact prefix, every task from its
``TaskDefinition`` bytes. The reference's names come from its source, so no
JAX run is spent on them."""

import ast
import inspect

import pytest
import torch

from auron_tpu.models import tpcds as jt

from auron_tpu_torch.models import tpcds as pt



def _reference_cases() -> list[tuple[str, str]]:
    """(record name, the reference function it calls) of each case of the
    reference's ``run_gate``, in its order, read from its source."""
    tree = ast.parse(inspect.getsource(jt.run_gate))
    cases = next(n.value for n in ast.walk(tree)
                 if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "cases")
    out = []
    for t in cases.elts:
        name = t.elts[0].value
        calls = [c.func.id for c in ast.walk(t.elts[1]) if isinstance(c, ast.Call)
                 and isinstance(c.func, ast.Name) and c.func.id.startswith("run_")]
        out.append((name, calls[0] if calls else "run_q72_class"))  # q72 through _q72()
    return out


def test_gate_names_are_the_reference_cases_in_order():
    ref = _reference_cases()
    assert len(ref) == len(pt.GATE_CASES) == 42
    assert [n for n, _ in ref] == [n for n, _, _ in pt.GATE_CASES]
    for (name, fn), (_, cls, _) in zip(ref, pt.GATE_CASES):
        want = "windowed" if fn == "run_windowed_query" else fn[len("run_"):-len("_class")]
        assert cls == want, (name, fn, cls)


def test_gate_task_counts_are_the_reference_functions_defaults():
    """Each case runs as many tasks as the reference function's defaults,
    and a file shuffle's work directory where the reference passes one."""
    for name, cls, args in pt.GATE_CASES:
        fn = jt.run_windowed_query if cls == "windowed" else getattr(jt, f"run_{cls}_class")
        params = inspect.signature(fn).parameters
        mine = inspect.signature(getattr(pt, f"run_{cls}_class")).parameters
        for k in ("n_map", "n_reduce", "n_partitions"):
            if k in params and k in mine:  # windowed: its two partitions are fixed
                assert args.get(k, mine[k].default) == params[k].default, (name, k)
        assert bool(args.get("work")) == ("work_dir" in params), name


def test_gate_runs_all_classes():
    res = pt.run_gate(sf=0.02, device="cpu", verbose=False)
    assert [r[0] for r in res] == [n for n, _, _ in pt.GATE_CASES]
    failures = [(n, e) for n, ok, e, _ in res if not ok]
    assert not failures, failures
    assert all(e is None and s > 0 for _, _, e, s in res)


def test_gate_records_a_failing_case(monkeypatch):
    """A case that raises or differs fails its own record; the others run."""
    monkeypatch.setattr(pt, "GATE_CASES", (("q41_like_distinct", "q41", {}),
                                          ("q42_star_topk", "q42", {}),
                                          ("q54_between_range_join", "q54", {})))

    def boom(*_a, **_k):
        raise ValueError("no answer")

    monkeypatch.setattr(pt, "run_q41_class", boom)
    monkeypatch.setattr(pt, "q54_class_oracle", lambda d: {"n": [0], "a": [0.0]})
    res = pt.run_gate(sf=0.005, device="cpu", verbose=False)
    assert [(n, ok) for n, ok, _, _ in res] == [("q41_like_distinct", False),
                                               ("q42_star_topk", True),
                                               ("q54_between_range_join", False)]
    assert res[0][2] == "ValueError: no answer" and res[2][2].startswith("n[0]")


def test_gate_prints_a_line_a_case(capsys, monkeypatch):
    monkeypatch.setattr(pt, "GATE_CASES", (("q41_like_distinct", "q41", {}),))
    pt.run_gate(sf=0.005, device="cpu")
    (line,) = capsys.readouterr().out.splitlines()
    assert line.startswith("q41_like_distinct  PASS")


def test_gate_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pt.run_gate(sf=0.005)
