"""The port's comparator (``auron_tpu_torch/models/compare.py``) gives the
reference's verdict on every case of ``tests/test_compare.py``: each of
that file's tests runs once more with its comparator names bound to the
port's functions (its check that ``tpcds._cmp_frames`` delegates to the
comparator is about the reference's class gate, which the port does not
have, and is left out)."""

import importlib.util
import os

import numpy as np
import pandas as pd
import pytest

from auron_tpu.models import compare as R
from auron_tpu_torch.models import compare as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NAMES = ("canonical_sort", "compare_frames", "float_close", "is_null_scalar")


def _reference_cases(bind):
    """A private copy of tests/test_compare.py with its comparator names
    bound to ``bind``'s functions."""
    spec = importlib.util.spec_from_file_location(
        "_torch_compare_cases", os.path.join(REPO, "tests", "test_compare.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in _NAMES:
        setattr(mod, name, getattr(bind, name))
    return mod


_PORT_CASES = _reference_cases(P)
CASES = sorted(n for n in dir(_PORT_CASES)
               if n.startswith("test_") and n != "test_tpcds_cmp_frames_delegates")


@pytest.mark.parametrize("case", CASES)
def test_reference_case_passes_on_the_port(case):
    getattr(_PORT_CASES, case)()


def _frames():
    """Frame pairs over the comparator's rules, with the verdicts of both."""
    import decimal

    d = decimal.Decimal
    return [
        (pd.DataFrame({"a": [1.0, None]}), pd.DataFrame({"a": [1.0 + 1e-7, np.nan]})),
        (pd.DataFrame({"a": [1.0]}), pd.DataFrame({"a": [1.1]})),
        (pd.DataFrame({"k": ["b", "a"], "v": [2, 1]}), pd.DataFrame({"k": ["a", "b"], "v": [1, 2]})),
        (pd.DataFrame({"k": ["b", "a"], "v": [2, 1]}), pd.DataFrame({"k": ["a", "b"], "v": [2, 1]})),
        (pd.DataFrame({"x": [d("1.10")]}), pd.DataFrame({"x": [d("1.1")]})),
        (pd.DataFrame({"x": [d("0.10000000000000000001")]}), pd.DataFrame({"x": [d("0.1")]})),
        (pd.DataFrame({"x": pd.array([1, None], dtype="Int64")}),
         pd.DataFrame({"x": [1.0, np.nan]})),
        (pd.DataFrame({"x": [1e300]}), pd.DataFrame({"x": [float(np.nextafter(1e300, np.inf))]})),
        (pd.DataFrame({"a": [1]}), pd.DataFrame({"a": [1, 2]})),
        (pd.DataFrame({"a": [1]}), pd.DataFrame({"b": [1]})),
    ]


@pytest.mark.parametrize("sorted_rows", [False, True])
@pytest.mark.parametrize("tol", [1e-6, 1e-12, 0.0])
def test_verdicts_and_messages_equal_the_reference(sorted_rows, tol):
    for got, want in _frames():
        assert P.compare_frames(got, want, tol, sorted_rows=sorted_rows) == \
            R.compare_frames(got, want, tol, sorted_rows=sorted_rows)
        assert P.canonical_sort(got).equals(R.canonical_sort(got))


def test_comparator_imports_no_pandas():
    import subprocess
    import sys
    import textwrap

    script = textwrap.dedent("""
        import sys
        from auron_tpu_torch.models import compare
        assert "pandas" not in sys.modules
        assert compare.float_close(1.0 + 1e-9, 1.0)
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
