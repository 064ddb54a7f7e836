"""Shared differential result comparator (QueryResultComparator analog).

One definition of "the engine's answer matches the oracle": the
real-text SQL gate (models/sqlgate.py) calls :func:`compare_frames` (the
reference keeps the same discipline: dev/auron-it
QueryResultComparator.scala:39-110 is the single comparator behind every
suite).

Rules (each has a direct unit test in tests/test_compare.py, which
tests/test_torch_compare.py runs against this port):

- row counts must match;
- every oracle column must exist in the engine output;
- NULL matches only NULL (pandas NA / NaT / None / float nan);
- floats match within ``float_rel`` relative epsilon of the oracle value
  OR within ``float_ulp`` units-in-the-last-place — the ULP term keeps
  huge magnitudes honest where a relative epsilon would be absurdly wide,
  the epsilon term keeps tiny magnitudes honest where ULPs collapse;
- decimals compare EXACTLY (numeric equality of decimal.Decimal, never
  through a float round trip);
- everything else compares with ``==``.

``sorted_rows=True`` canonicalizes BOTH frames to a total row order first
(string-rendered rows, NULLs first) — the SQL gate's mode, where ORDER BY
determinism belongs to the query, not the comparator.

Port of ``auron_tpu/models/compare.py``, the same rules; pandas is
imported inside the functions that need it.
"""

from __future__ import annotations

import decimal as pydec
import math

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["is_null_scalar", "compare_frames", "float_close", "canonical_sort"]


def is_null_scalar(x) -> bool:
    """SQL NULL test for a python-level cell value."""
    import pandas as pd

    if isinstance(x, (list, tuple, dict, np.ndarray)):
        return False
    try:
        return bool(pd.isna(x))
    except (TypeError, ValueError):
        return False


def float_close(a: float, b: float, rel: float = 1e-6, ulp: int = 4) -> bool:
    """True when a matches b under the epsilon-OR-ULP rule."""
    a = float(a)
    b = float(b)
    if a == b:
        return True
    if math.isnan(a) or math.isnan(b) or math.isinf(a) or math.isinf(b):
        return False  # non-finite mismatches never "close" (== caught equals)
    if abs(a - b) <= rel * max(1.0, abs(b)):
        return True
    return _ulp_distance(a, b) <= ulp


def _ulp_distance(a: float, b: float) -> int:
    """Units-in-the-last-place distance via the IEEE-754 bit trick: the
    lexicographic int64 view of a double is monotone in its magnitude."""
    ia = int(np.float64(a).view(np.int64))
    ib = int(np.float64(b).view(np.int64))
    if ia < 0:
        ia = -(2**63) - ia - 1  # map negative floats to a monotone range
    if ib < 0:
        ib = -(2**63) - ib - 1
    return abs(ia - ib)


def _cell_key(x) -> tuple:
    """Total-order sort key for one cell: NULLs first, then by rendered
    value (type-stable enough for canonicalization; the comparator itself
    re-checks values with the real tolerance rules)."""
    if is_null_scalar(x):
        return (0, "")
    if isinstance(x, (bool, np.bool_)):
        return (1, str(int(x)))
    if isinstance(x, pydec.Decimal):
        return (1, f"{x:.18f}")
    if isinstance(x, (int, np.integer, float, np.floating)):
        return (1, f"{float(x):.10e}")
    return (1, str(x))


def canonical_sort(df: pd.DataFrame) -> pd.DataFrame:
    """Rows in a deterministic total order (NULLs first), all columns."""
    if len(df) <= 1:
        return df.reset_index(drop=True)
    keys = [
        tuple(_cell_key(df.iloc[i, j]) for j in range(df.shape[1]))
        for i in range(len(df))
    ]
    order = sorted(range(len(df)), key=keys.__getitem__)
    return df.iloc[order].reset_index(drop=True)


def compare_frames(
    got: pd.DataFrame,
    want: pd.DataFrame,
    float_tol: float = 1e-6,
    *,
    float_ulp: int = 4,
    sorted_rows: bool = False,
) -> str | None:
    """Row-level comparison; None = match, else a first-difference message."""
    if len(got) != len(want):
        return f"row count {len(got)} != {len(want)}"
    if sorted_rows:
        missing = [c for c in want.columns if c not in got.columns]
        if missing:
            return f"missing column {missing[0]}"
        got = canonical_sort(got[list(want.columns)])
        want = canonical_sort(want)
    for c in want.columns:
        if c not in got.columns:
            return f"missing column {c}"
        g, w = got[c].tolist(), want[c].tolist()
        for i, (a, b) in enumerate(zip(g, w)):
            a_null = is_null_scalar(a)
            b_null = is_null_scalar(b)
            if a_null or b_null:
                if a_null != b_null:
                    return f"{c}[{i}]: {a!r} != {b!r}"
                continue
            if isinstance(b, pydec.Decimal) or isinstance(a, pydec.Decimal):
                # decimal exactness: numeric equality, no float round trip
                try:
                    if pydec.Decimal(str(a)) != pydec.Decimal(str(b)):
                        return f"{c}[{i}]: {a!r} != {b!r} (decimal exact)"
                except pydec.InvalidOperation:
                    return f"{c}[{i}]: {a!r} != {b!r} (decimal exact)"
            elif isinstance(b, (float, np.floating)):
                if not float_close(float(a), float(b), float_tol, float_ulp):
                    return f"{c}[{i}]: {a!r} != {b!r}"
            elif a != b:
                return f"{c}[{i}]: {a!r} != {b!r}"
    return None
