"""Slice 6, part C: the q31 (per-group average joined back), q34 (HAVING),
q38 (three-way INTERSECT), q54 (BETWEEN join), q58 (UNION of year
branches), q79 (group-wise argmax) and q22 (NOT IN as an anti join)
classes give the same answer from auron_tpu, from auron_tpu_torch on
``device="cpu"`` and from the port's numpy oracles (torch_classes.py); the
new entry points run with JAX, pyarrow, pandas and protobuf unavailable,
and raise on ``cuda`` without a card."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from auron_tpu.models import tpcds as jt

from auron_tpu_torch.models import tpcds as pt
from torch_classes import SF, run_three_ways

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("q31", "q34", "q38", "q54", "q58", "q79", "q22")


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


@pytest.mark.parametrize("name", CLASSES)
def test_class_three_ways(data, name, tmp_path, monkeypatch):
    run_three_ways(jt, pt, *data, name, tmp_path, monkeypatch)


def test_tail_classes_are_listed_once():
    assert len(set(pt.TAIL_CLASSES)) == len(pt.TAIL_CLASSES) == 22
    for name in pt.TAIL_CLASSES:
        assert callable(getattr(pt, f"run_{name}_class"))
        assert callable(getattr(pt, f"{name}_class_oracle"))


@pytest.mark.parametrize("name", pt.TAIL_CLASSES)
def test_tail_entries_raise_without_a_card(data, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(pt, f"run_{name}_class")(data[1])


def test_tail_classes_run_without_jax_arrow_pandas_or_protobuf():
    script = textwrap.dedent("""
        import sys
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "jaxlib", "auron_tpu"):
            sys.modules[m] = None  # any import of them raises ImportError
        import numpy as np
        from auron_tpu_torch.models import tpcds
        d = tpcds.generate(0.005, 3)
        for name in tpcds.TAIL_CLASSES:
            got = getattr(tpcds, f"run_{name}_class")(d, device="cpu")
            want = getattr(tpcds, f"{name}_class_oracle")(d)
            assert sorted(got) == sorted(want), name
            for k, w in want.items():
                assert len(got[k]) == len(w), (name, k)
                if w.dtype.kind != "f":
                    assert np.array_equal(got[k], w), (name, k)
                else:
                    assert np.allclose(got[k], w, rtol=1e-9, atol=0), (name, k)
        try:
            tpcds.run_q17_class(d)
        except RuntimeError as e:
            assert "cuda" in str(e)
        bad = sorted(m for m in sys.modules if sys.modules[m] is not None and
                     m.split(".")[0] in ("jax", "jaxlib", "auron_tpu", "pandas", "pyarrow"))
        print("OK", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK []" in r.stdout
