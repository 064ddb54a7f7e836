"""The port's ``WindowExec`` and ``WindowGroupLimitExec`` against the JAX
package's on the same batches (the port's batches carry the reference
batches' planes, tests/torch_carry.py), on the CPU: every case of
tests/test_window_exec.py — ranks with ties, lead/lag, running and
whole-partition aggregates, peers sharing a running value, NULLs, no
PARTITION BY, nth_value visibility, the group limit, ntile with fewer rows
than buckets, lexicographic string min/max — plus a NaN and a -0.0 in
running and whole min/max, several partition and order keys, dictionary
keys, and chunked emission.

Tolerances: keys, ranks, row numbers, ntile, lead/lag/nth_value values and
validity, counts, min/max and the row order exactly; float sums and
averages at |got - want| <= 1e-9 |want| + 16 eps G, where G is the running
sum of |input| over the emitted rows up to the row (the reference's
running sum is a global cumsum rebased at the partition start, which
loses up to about eps G to cancellation)."""

import numpy as np
import pytest
import torch

from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.window_exec import WindowExec as JWindow
from auron_tpu.exec.window_exec import WindowFunc as JFunc
from auron_tpu.exec.window_exec import WindowGroupLimitExec as JLimit
from auron_tpu.exprs import ir as jir
from auron_tpu.ops.sortkeys import SortSpec as JSpec
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch import types as PT
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.window_exec import WindowExec as PWindow
from auron_tpu_torch.exec.window_exec import WindowFunc as PFunc
from auron_tpu_torch.exec.window_exec import WindowGroupLimitExec as PLimit
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.ops import segments as pseg
from auron_tpu_torch.ops.sortkeys import SortSpec as PSpec
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import carry, jax_batch, rows

EPS = np.finfo(np.float64).eps
WORDS = np.array(["zebra", "apple", "mango", "pear", "fig", "Äpfel", "", "kiwi"], dtype=object)


def _data(n: int, seed: int, groups: int = 8, order_range: int | None = None):
    """g (int64 partition key), o (int32 order key, ties when order_range
    is small), v (float64 with NULLs), s (string with NULLs), i (int32)."""
    rng = np.random.default_rng(seed)
    cols = {
        "g": rng.integers(0, groups, n).astype(np.int64),
        "o": (rng.integers(0, order_range, n) if order_range else rng.permutation(n))
        .astype(np.int32),
        "v": rng.normal(size=n).round(3),
        "s": WORDS[rng.integers(0, len(WORDS), n)],
        "i": rng.integers(-50, 50, n).astype(np.int32),
    }
    valid = {"v": rng.random(n) > 0.1, "s": rng.random(n) > 0.1, "i": rng.random(n) > 0.1}
    return cols, valid


def _batches(cols, valid, chunk):
    n = len(next(iter(cols.values())))
    chunk = chunk or n
    return [jax_batch({k: v[i:i + chunk] for k, v in cols.items()},
                      {k: v[i:i + chunk] for k, v in valid.items()})
            for i in range(0, n, chunk)]


def _funcs(ir, Func, specs):
    return [(Func(kind, agg=agg, expr=None if c is None else ir.col(c), offset=off,
                  frame_whole=whole), name)
            for name, kind, agg, c, off, whole in specs]


def _run(jbs, part_cols, order, specs, limit=None, rank_like="row_number", batch_size=None):
    """(port rows, reference rows, port batches) of one window over ``jbs``."""
    schema = jbs[0].schema
    conf = {} if batch_size is None else {"batch.size": batch_size}
    out = []
    for ir, Func, Spec, Scan, Window, Limit, Ctx, Conf, batches in (
        (pir, PFunc, PSpec, None, PWindow, PLimit, PCtx, PConf, [carry(b) for b in jbs]),
        (jir, JFunc, JSpec, JScan, JWindow, JLimit, JCtx, JConf, jbs),
    ):
        scan = (PScan([batches], batches[0].schema) if Scan is None else Scan.single(batches))
        pby = [ir.col(c) for c in part_cols]
        oby = [(ir.col(c), Spec(asc=asc, nulls_first=nf)) for c, asc, nf in order]
        if limit is None:
            op = Window(scan, pby, oby, _funcs(ir, Func, specs))
        else:
            op = Limit(scan, pby, oby, limit, rank_like)
        got = list(op.execute(0, Ctx(conf=Conf(dict(conf)))))
        out.append((rows(got), got))
    assert [f.name for f in out[0][1][0].schema] == [f.name for f in schema] + [
        s[0] for s in (specs if limit is None else [])]
    return out[0][0], out[1][0], out[0][1]


def _prefix_abs(rs, col):
    v = np.array([abs(r[col]) if isinstance(r[col], float) and not np.isnan(r[col]) else 0.0
                  for r in rs])
    return np.cumsum(v)


def _assert_rows(got, want, float_cols=(), value_col=2):
    """Row for row, in order: floats of ``float_cols`` within the bound
    above, everything else exactly (NaN equal to NaN, -0.0 apart from
    0.0)."""
    assert len(got) == len(want) > 0
    g_prefix = _prefix_abs(want, value_col)
    total = g_prefix[-1]
    for k, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for c, (x, y) in enumerate(zip(g, w)):
            if c in float_cols and x is not None and y is not None:
                bound = 1e-9 * abs(y) + 16 * EPS * max(g_prefix[k], total)
                assert abs(x - y) <= bound, (k, c, x, y, bound)
            elif isinstance(y, float) and y is not None:
                assert x is not None and (np.isnan(x) and np.isnan(y) or (
                    x == y and np.signbit(x) == np.signbit(y))), (k, c, x, y)
            else:
                assert x == y, (k, c, x, y)


RANKS = [("rn", "row_number", None, None, 1, False), ("rk", "rank", None, None, 1, False),
         ("dr", "dense_rank", None, None, 1, False),
         ("pr", "percent_rank", None, None, 1, False),
         ("cd", "cume_dist", None, None, 1, False), ("nt", "ntile", None, None, 3, False)]
SHIFTS = [("ld", "lead", None, 2, 1, False), ("lg", "lag", None, 2, 2, False),
          ("lgs", "lag", None, 3, 1, False), ("nv", "nth_value", None, 2, 2, False),
          ("nvs", "nth_value", None, 3, 3, False)]
AGGS = [("rsum", "agg", "sum", 2, 1, False), ("rcnt", "agg", "count", 2, 1, False),
        ("ravg", "agg", "avg", 2, 1, False), ("rmin", "agg", "min", 2, 1, False),
        ("rmax", "agg", "max", 2, 1, False), ("tsum", "agg", "sum", 2, 1, True),
        ("tcnt", "agg", "count", 2, 1, True), ("tavg", "agg", "avg", 2, 1, True),
        ("tmin", "agg", "min", 2, 1, True), ("tmax", "agg", "max", 2, 1, True),
        ("isum", "agg", "sum", 4, 1, False), ("imin", "agg", "min", 4, 1, False),
        ("imax", "agg", "max", 4, 1, True)]

CASES = {
    # name: (data kwargs, chunk, partition cols, order (col, asc, nulls_first), funcs)
    "ranks_with_ties": (dict(n=300, seed=21, order_range=12), 64, (0,), [(1, True, True)],
                        RANKS),
    "ranks_unique_order": (dict(n=200, seed=22), None, (0,), [(1, True, True)], RANKS),
    "ranks_desc_two_keys": (dict(n=300, seed=23, order_range=5), 100, (0,),
                            [(1, False, True), (4, True, False)], RANKS),
    "lead_lag_nth": (dict(n=250, seed=24, order_range=40), 80, (0,), [(1, True, True)],
                     SHIFTS),
    "aggs_running_and_whole": (dict(n=300, seed=25, order_range=30), 50, (0,),
                               [(1, True, True)], AGGS),
    "no_partition_by": (dict(n=150, seed=26, order_range=20), None, (), [(1, True, True)],
                        RANKS + AGGS[:5]),
    "string_and_int_partition": (dict(n=400, seed=27, groups=3, order_range=15), 128, (3, 0),
                                 [(1, True, True)], RANKS[:3] + AGGS),
    "string_order_nulls_last": (dict(n=300, seed=28, groups=4), 90, (0,),
                                [(3, False, False), (1, True, True)],
                                RANKS + [("smin", "agg", "min", 3, 1, False),
                                         ("smax", "agg", "max", 3, 1, False),
                                         ("tsmin", "agg", "min", 3, 1, True),
                                         ("tsmax", "agg", "max", 3, 1, True),
                                         ("sld", "lead", None, 3, 1, False)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_matches_reference(name):
    kw, chunk, part, order, specs = CASES[name]
    cols, valid = _data(**kw)
    got, want, _ = _run(_batches(cols, valid, chunk), part, order, specs)
    float_cols = {5 + i for i, s in enumerate(specs)
                  if s[1] == "agg" and s[2] in ("sum", "avg") and s[3] == 2}
    float_cols |= {5 + i for i, s in enumerate(specs) if s[1] in ("percent_rank", "cume_dist")}
    _assert_rows(got, want, float_cols)


def _fixed(cols: dict):
    return _batches({k: np.asarray(v) for k, v in cols.items()}, {}, None)


def test_rank_with_ties_fixed():
    jbs = _fixed({"g": np.ones(6, np.int64), "o": np.array([10, 10, 20, 20, 20, 30], np.int32),
                  "v": np.arange(6.0)})
    got, want, _ = _run(jbs, (0,), [(1, True, True)], RANKS)
    _assert_rows(got, want)
    assert [r[3:] for r in got] == [(1, 1, 1, 0.0, 2 / 6, 1), (2, 1, 1, 0.0, 2 / 6, 1),
                                    (3, 3, 2, 0.4, 5 / 6, 2), (4, 3, 2, 0.4, 5 / 6, 2),
                                    (5, 3, 2, 0.4, 5 / 6, 3), (6, 6, 3, 1.0, 1.0, 3)]


def test_running_sum_ties_share_value():
    jbs = _fixed({"g": np.ones(4, np.int64), "o": np.array([1, 2, 2, 3], np.int32),
                  "v": np.array([1.0, 2.0, 3.0, 4.0])})
    got, want, _ = _run(jbs, (0,), [(1, True, True)], [("rs", "agg", "sum", 2, 1, False)])
    _assert_rows(got, want)
    assert [r[3] for r in got] == [1.0, 6.0, 6.0, 10.0]


def test_nulls_in_agg_input():
    jbs = _batches({"g": np.ones(3, np.int64), "o": np.arange(3, dtype=np.int32),
                    "v": np.array([1.0, 9.0, 3.0])}, {"v": np.array([True, False, True])}, None)
    got, want, _ = _run(jbs, (0,), [(1, True, True)], [("rs", "agg", "sum", 2, 1, False),
                                                       ("rc", "agg", "count", 2, 1, False)])
    _assert_rows(got, want)
    assert [r[3:] for r in got] == [(1.0, 1), (1.0, 1), (4.0, 2)]


def test_nth_value_ties_share_visibility():
    jbs = _fixed({"g": np.ones(4, np.int64), "o": np.array([1, 1, 2, 3], np.int32),
                  "v": np.array([10.0, 20.0, 30.0, 40.0])})
    got, want, _ = _run(jbs, (0,), [(1, True, True)], [("n2", "nth_value", None, 2, 2, False),
                                                       ("n3", "nth_value", None, 2, 3, False)])
    _assert_rows(got, want)
    assert [r[3:] for r in got] == [(20.0, None), (20.0, None), (20.0, 30.0), (20.0, 30.0)]


@pytest.mark.parametrize("n_rows,tiles", [(7, 3), (2, 4), (1, 5), (12, 4)])
def test_ntile(n_rows, tiles):
    jbs = _fixed({"g": np.ones(n_rows, np.int64), "o": np.arange(n_rows, dtype=np.int32),
                  "v": np.zeros(n_rows)})
    got, want, _ = _run(jbs, (0,), [(1, True, True)], [("nt", "ntile", None, None, tiles, False)])
    _assert_rows(got, want)
    size, extra = divmod(n_rows, tiles)
    expect = [t + 1 for t in range(tiles) for _ in range(size + (t < extra))]
    assert [r[3] for r in got] == expect


def test_min_max_strings_lexicographic():
    jbs = _fixed({"g": np.array([1, 1, 1, 2, 2], np.int64),
                  "o": np.array([0, 1, 2, 0, 1], np.int32),
                  "s": np.array(["zebra", "apple", "mango", "pear", "fig"], dtype=object)})
    specs = [("mn", "agg", "min", 2, 1, True), ("mx", "agg", "max", 2, 1, True),
             ("rmn", "agg", "min", 2, 1, False), ("rmx", "agg", "max", 2, 1, False)]
    got, want, _ = _run(jbs, (0,), [(1, True, True)], specs)
    _assert_rows(got, want)
    assert [r[3:] for r in got] == [
        ("apple", "zebra", "zebra", "zebra"), ("apple", "zebra", "apple", "zebra"),
        ("apple", "zebra", "apple", "zebra"), ("fig", "pear", "pear", "pear"),
        ("fig", "pear", "fig", "pear")]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_min_max_nan_and_signed_zero(dtype):
    """jnp.minimum/jnp.maximum propagate NaN and order -0.0 below 0.0 (min
    picks -0.0, max 0.0 in either argument order), which the whole-partition
    min shows; the reference's running scan returns every zero as +0.0 (it
    interleaves by adding zero-padded halves). The port's order key, NaN
    rule and running zero give the same."""
    v = np.array([0.0, -0.0, 1.5, np.nan, -2.0, -0.0, 0.0, 3.0, np.nan, -0.0, 0.0, 2.0],
                 dtype=dtype)
    g = np.array([1, 1, 1, 1, 1, 2, 2, 3, 3, 3, 3, 3], np.int64)
    jbs = _batches({"g": g, "o": np.arange(12, dtype=np.int32), "v": v},
                   {"v": np.array([True] * 11 + [False])}, 5)
    specs = [("rmin", "agg", "min", 2, 1, False), ("rmax", "agg", "max", 2, 1, False),
             ("tmin", "agg", "min", 2, 1, True), ("tmax", "agg", "max", 2, 1, True)]
    got, want, _ = _run(jbs, (0,), [(1, True, True)], specs)
    _assert_rows(got, want)
    assert not np.signbit(got[1][3]) and not np.signbit(got[1][4])  # running: +0.0
    assert np.signbit(got[5][5]) and not np.signbit(got[5][6])  # whole: -0.0 / 0.0
    assert np.isnan(got[3][3]) and np.isnan(got[4][6])


def test_running_min_max_match_a_serial_scan():
    """The doubling scan equals a serial per-segment scan on random keys."""
    rng = np.random.default_rng(5)
    n = 1000
    seg = np.sort(rng.integers(0, 37, n))
    start = np.searchsorted(seg, seg)
    keys = rng.integers(-(2**62), 2**62, n)
    for reduce, fn in (("amin", np.minimum), ("amax", np.maximum)):
        want = keys.copy()
        for i in range(1, n):
            if start[i] < i:
                want[i] = fn(want[i - 1], keys[i])
        got = pseg.seg_running_extreme(torch.from_numpy(keys), torch.from_numpy(start), reduce)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("rank_like", ["row_number", "rank", "dense_rank"])
def test_window_group_limit(rank_like):
    cols, valid = _data(300, 33, order_range=10)
    got, want, _ = _run(_batches(cols, valid, 70), (0,), [(1, True, True)], [], limit=3,
                        rank_like=rank_like)
    _assert_rows(got, want)
    per_group = np.bincount([r[0] for r in got])
    assert per_group.max() >= 3 and (rank_like != "row_number" or per_group.max() == 3)


def test_chunked_emission_matches_reference():
    """More live rows than one batch: the output leaves in batch-size
    chunks, chunk for chunk as the reference's."""
    cols, valid = _data(700, 34, order_range=50)
    jbs = _batches(cols, valid, 200)
    got, want, pbs = _run(jbs, (0,), [(1, True, True)], RANKS[:2], batch_size=128)
    _assert_rows(got, want)
    assert [b.capacity for b in pbs] == [128] * 6 and sum(b.num_rows() for b in pbs) == 700


def test_decimal_window_sum_is_not_in_this_slice():
    """Decimal window sums came with slice 10 (the refusal this test held
    is gone): a decimal(10,2) sum is typed decimal(20,2) and its average
    decimal(14,6), as the JAX WindowExec types them, and both compute the
    JAX package's values."""
    import decimal as pydec

    from auron_tpu import types as JT
    from auron_tpu.columnar import Batch as JBatch

    from torch_carry import canon, carry, rows

    jschema = JT.Schema.of(JT.Field("g", JT.INT64), JT.Field("d", JT.decimal(10, 2)))
    jb = JBatch.from_pydict({"g": [1, 1, 2, 2, 2], "d": [pydec.Decimal("1.25"), None,
                                                         pydec.Decimal("-3.10"),
                                                         pydec.Decimal("0.05"),
                                                         pydec.Decimal("99999999.99")]},
                            schema=jschema)
    funcs = [("agg", "sum", 1, "s"), ("agg", "avg", 1, "a")]
    jw = JWindow(JScan([[jb]], jschema), [jir.col(0)], [],
                 [(JFunc(k, agg=a, expr=jir.col(c)), n) for k, a, c, n in funcs])
    pb = carry(jb)
    pw = PWindow(PScan([[pb]], pb.schema), [pir.col(0)], [],
                 [(PFunc(k, agg=a, expr=pir.col(c)), n) for k, a, c, n in funcs])
    assert [repr(f.dtype) for f in pw.schema][2:] == ["decimal(20,2)", "decimal(14,6)"]
    got = canon(rows(list(pw.execute(0, PCtx(device="cpu")))))
    assert got == canon(rows(list(jw.execute(0, JCtx()))))
    assert got[0][2:] == (pydec.Decimal("1.25"), pydec.Decimal("1.250000"))
