"""The port's decimal and ``first`` aggregates against the JAX package's
(``tests/test_agg_exec.py::test_decimal_sum_avg``,
``::test_first_and_first_ignores_null``, ``::test_wide_decimal_sum_no_wrap``
and ``::test_min_max_over_strings_lexicographic``, plus the edges): partial
-> final over the same seeded batches in both packages, rows compared
exactly (decimals as Decimals). Also the FINAL precision check (a decimal64
sum past its precision is NULL), the dense table over decimal64 inputs,
states parked by a spill and merged back (limbs, ``#seen`` lanes, wide
min/max), and decimal window sums and averages."""

import decimal as d

import numpy as np
import pytest

from auron_tpu import types as JT
from auron_tpu.columnar import Batch as JBatch
from auron_tpu.exec.agg_exec import FINAL as JFINAL
from auron_tpu.exec.agg_exec import PARTIAL as JPARTIAL
from auron_tpu.exec.agg_exec import AggExpr as JAgg
from auron_tpu.exec.agg_exec import HashAggExec as JHashAgg
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exprs import ir as jir
from auron_tpu.memory import memmgr as JM

from auron_tpu_torch.exec.agg_exec import FINAL, PARTIAL, AggExpr, HashAggExec
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.memory import memmgr as PM
from torch_carry import canon, carry, rows


@pytest.fixture(autouse=True)
def _restore_managers():
    try:
        yield
    finally:
        JM.MemManager.init()
        PM.MemManager.init()


def _pkg(side):
    if side == "jax":
        return JScan, JHashAgg, JAgg, jir, (JPARTIAL, JFINAL), JCtx
    return PScan, HashAggExec, AggExpr, pir, (PARTIAL, FINAL), lambda: PCtx(device="cpu")


def _pipeline(side, jbs, n_keys: int, aggs, split: bool = False):
    """(final rows, partial metrics): partial aggregation of ``jbs`` (one
    task, or one per batch with ``split``), then FINAL over the states.
    ``aggs`` is [(func, input column or None, name)]."""
    Scan, Agg, Expr, ir, modes, ctx_of = _pkg(side)
    if side != "jax":
        jbs = [carry(b) for b in jbs]
    keys = [(ir.col(i), f"k{i}") for i in range(n_keys)]
    specs = [(Expr(f, ir.col(c) if c is not None else None), name) for f, c, name in aggs]
    pctx = ctx_of()
    groups = [[b] for b in jbs] if split else [jbs]
    inter = []
    for g in groups:
        inter += list(Agg(Scan([g], g[0].schema), keys, specs, modes[0]).execute(0, pctx))
    fspecs = [(Expr(f, ir.col(n_keys) if c is not None else None), name)
              for f, c, name in aggs]
    final = Agg(Scan([inter], inter[0].schema), keys, fspecs, modes[1])
    return rows(list(final.execute(0, ctx_of()))), pctx.metrics.values


def both(jbs, n_keys, aggs, split=False):
    want, _ = _pipeline("jax", jbs, n_keys, aggs, split)
    got, metrics = _pipeline("port", jbs, n_keys, aggs, split)
    assert canon(got) == canon(want)
    return canon(got), metrics


def _schema(*fields):
    return JT.Schema.of(*[JT.Field(n, t) for n, t in fields])


def test_decimal_sum_avg():
    b = JBatch.from_pydict(
        {"k": [1, 1, 2], "v": [d.Decimal("1.10"), d.Decimal("2.05"), d.Decimal("-0.50")]},
        schema=_schema(("k", JT.INT32), ("v", JT.decimal(7, 2))))
    got, _ = both([b], 1, [("sum", 1, "s"), ("avg", 1, "a")])
    assert got == [(1, d.Decimal("3.15"), d.Decimal("1.575000")),
                   (2, d.Decimal("-0.50"), d.Decimal("-0.500000"))]


@pytest.mark.parametrize("func,want", [("first_ignores_null", [5, None]),
                                       ("first", [None, None])])
def test_first_and_first_ignores_null(func, want):
    b = JBatch.from_pydict({"k": [1, 1, 2], "v": [None, 5, None]},
                           schema=_schema(("k", JT.INT32), ("v", JT.INT64)))
    got, _ = both([b], 1, [(func, 1, "f")])
    assert [r[1] for r in got] == want


def test_first_over_batches_and_decimals():
    rng = np.random.default_rng(8)
    bs = []
    for i in range(4):
        k = rng.integers(0, 40, 300) * 1_000_003  # the generic path
        v = [d.Decimal(int(x)).scaleb(-2) if x % 4 else None for x in rng.integers(0, 10**6, 300)]
        bs.append(JBatch.from_pydict({"k": k.tolist(), "v": v},
                                     schema=_schema(("k", JT.INT64), ("v", JT.decimal(9, 2)))))
    both(bs, 1, [("first_ignores_null", 1, "f"), ("first", 1, "g"), ("count", 1, "c")],
         split=True)


def test_wide_decimal_sum_no_wrap():
    big = d.Decimal(5 * 10**13)  # 200k rows: 1e19 > int64 max
    n = 200_000
    b = JBatch.from_pydict({"k": [1] * n + [2] * 3, "v": [big] * n + [d.Decimal(5)] * 3},
                           schema=_schema(("k", JT.INT32), ("v", JT.decimal(18, 0))))
    got, _ = both([b], 1, [("sum", 1, "s"), ("avg", 1, "a")])
    assert got[0][1] == d.Decimal(10) ** 19 and int(got[0][2]) == 5 * 10**13
    assert got[1][1] == d.Decimal(15) and int(got[1][2]) == 5


def test_wide_sum_within_domain_is_exact():
    vals = [d.Decimal(10**16 + i) for i in range(50)]
    b = JBatch.from_pydict({"k": [1] * 50, "v": vals},
                           schema=_schema(("k", JT.INT32), ("v", JT.decimal(18, 0))))
    got, _ = both([b], 1, [("sum", 1, "s")])
    assert got == [(1, sum(vals))]


def test_min_max_over_strings_lexicographic():
    b = JBatch.from_pydict({"k": [1, 1, 1, 2, 2], "s": ["zebra", "apple", "mango", "pear", None]},
                           schema=_schema(("k", JT.INT64), ("s", JT.STRING)))
    got, _ = both([b], 1, [("min", 1, "mn"), ("max", 1, "mx")])
    assert got == [(1, "apple", "zebra"), (2, "pear", "pear")]


def test_min_max_over_wide_decimals_numeric():
    vals = [d.Decimal("1e25"), d.Decimal("-3e20"), d.Decimal("7.5"), d.Decimal("-0.0001"), None,
            d.Decimal("2e30")]
    b = JBatch.from_pydict({"k": [1, 1, 1, 2, 2, 2], "v": vals},
                           schema=_schema(("k", JT.INT64), ("v", JT.decimal(38, 4))))
    got, _ = both([b], 1, [("min", 1, "mn"), ("max", 1, "mx"), ("sum", 1, "s")])
    assert got[0][1:3] == (d.Decimal("-3e20"), d.Decimal("1e25"))
    assert got[1][1:3] == (d.Decimal("-0.0001"), d.Decimal("2e30"))


def test_decimal64_final_sum_past_precision_is_null():
    """The FINAL stage checks a decimal64 sum against its precision
    (decimal(17,2) here) after the int64 accumulation."""
    inter = _schema(("k", JT.INT64), ("s#sum", JT.decimal(17, 2)))
    parts = [JBatch.from_pydict({"k": [1, 2, 3], "s#sum": [d.Decimal("6e14"), d.Decimal("1"),
                                                           d.Decimal("-9e14")]}, schema=inter)
             for _ in range(2)]
    sides = []
    for side in ("jax", "port"):
        Scan, Agg, Expr, ir, modes, ctx_of = _pkg(side)
        bs = parts if side == "jax" else [carry(b) for b in parts]
        op = Agg(Scan([bs], bs[0].schema), [(ir.col(0), "k")],
                 [(Expr("sum", ir.col(1)), "s")], modes[1])
        sides.append(canon(rows(list(op.execute(0, ctx_of())))))
    assert sides[0] == sides[1] == [(1, None), (2, d.Decimal("2.00")), (3, None)]


@pytest.mark.parametrize("keys", [1, 2])
def test_dense_table_over_decimal64(keys):
    """Small integer keys take the dense table: decimal64 sums, averages
    (HALF_UP ties of both signs), min and max folded by scatters."""
    rng = np.random.default_rng(keys)
    bs = []
    for _ in range(3):
        n = 500
        cents = rng.integers(-(10**7), 10**7, n)
        cents[:4] = [5, -5, 15, -15]
        v = [d.Decimal(int(c)).scaleb(-2) if ok else None
             for c, ok in zip(cents, rng.random(n) > 0.1)]
        bs.append(JBatch.from_pydict(
            {"a": rng.integers(0, 5, n).tolist(), "b": rng.integers(0, 3, n).tolist(), "v": v},
            schema=_schema(("a", JT.INT32), ("b", JT.INT32), ("v", JT.decimal(9, 2)))))
    if keys == 1:
        bs = [JBatch.from_pydict({"a": b.to_pydict()["a"], "v": b.to_pydict()["v"]},
                                 schema=_schema(("a", JT.INT32), ("v", JT.decimal(9, 2))))
              for b in bs]
    c = keys
    both(bs, keys, [("sum", c, "s"), ("avg", c, "av"), ("min", c, "mn"), ("max", c, "mx"),
                    ("count", c, "n")])


def _spill_input(seed=31, n=12_000, chunk=1500):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1500, n) * 1_000_003  # wide range: the generic path spills
    cents = rng.integers(-(10**9), 10**9, n)
    valid = rng.random(n) > 0.1
    price = [d.Decimal(int(c)).scaleb(-2) if ok else None for c, ok in zip(cents, valid)]
    # first's inputs are functions of the key: any merge order gives one answer
    tag = [int(x % 97) for x in k]
    tagn = [t if ok else None for t, ok in zip(tag, valid)]
    wide = [d.Decimal(int(x)).scaleb(-4) * 10**12 if ok else None
            for x, ok in zip(k, rng.random(n) > 0.2)]
    s = _schema(("k", JT.INT64), ("p", JT.decimal(18, 2)), ("t", JT.INT64), ("tn", JT.INT64),
                ("w", JT.decimal(38, 4)))
    return [JBatch.from_pydict({"k": k[i:i + chunk].tolist(), "p": price[i:i + chunk],
                                "t": tag[i:i + chunk], "tn": tagn[i:i + chunk],
                                "w": wide[i:i + chunk]}, schema=s)
            for i in range(0, n, chunk)]


SPILL_AGGS = [("sum", 1, "s"), ("avg", 1, "a"), ("first", 2, "f"),
              ("first_ignores_null", 3, "fi"), ("min", 4, "wmin"), ("max", 4, "wmax"),
              ("sum", 4, "ws"), ("count_star", None, "n")]


def test_decimal_and_first_states_survive_spills():
    """A partial aggregate parks its decimal64 sums, wide-sum limbs, #seen
    lanes and wide min/max in spilled runs and merges them back: the
    answer equals the unspilled one and the JAX package's, spilled there
    too."""
    bs = _spill_input()
    free, pm = _pipeline("port", bs, 1, SPILL_AGGS)
    assert "spilled_aggs" not in pm
    JM.MemManager.init(budget_bytes=150_000)
    PM.MemManager.init(budget_bytes=150_000)
    got, metrics = both(bs, 1, SPILL_AGGS)
    assert metrics["spilled_aggs"] >= 2
    assert got == canon(free)


def test_decimal_window_sum_and_avg():
    """Running and whole-partition sums and averages of a decimal64
    (decimal(7,2) -> sum decimal(17,2), avg decimal(11,6) HALF_UP)."""
    from auron_tpu.exec.window_exec import WindowExec as JWin
    from auron_tpu.exec.window_exec import WindowFunc as JFunc
    from auron_tpu.ops.sortkeys import SortSpec as JSpec

    from auron_tpu_torch.exec.window_exec import WindowExec as PWin
    from auron_tpu_torch.exec.window_exec import WindowFunc as PFunc
    from auron_tpu_torch.ops.sortkeys import SortSpec as PSpec

    rng = np.random.default_rng(4)
    n = 700
    cents = rng.integers(-99999, 99999, n)
    v = [d.Decimal(int(c)).scaleb(-2) if ok else None for c, ok in zip(cents, rng.random(n) > 0.1)]
    b = JBatch.from_pydict({"g": rng.integers(0, 9, n).tolist(),
                            "o": rng.integers(0, 50, n).tolist(), "v": v},
                           schema=_schema(("g", JT.INT64), ("o", JT.INT64),
                                          ("v", JT.decimal(7, 2))))
    out = []
    for Win, Func, Spec, ir, bs, ctx in ((JWin, JFunc, JSpec, jir, [b], JCtx()),
                                         (PWin, PFunc, PSpec, pir, [carry(b)], PCtx(device="cpu"))):
        scan = (JScan if ir is jir else PScan)([bs], bs[0].schema)
        w = Win(scan, [ir.col(0)], [(ir.col(1), Spec())],
                [(Func("agg", agg="sum", expr=ir.col(2)), "run"),
                 (Func("agg", agg="avg", expr=ir.col(2)), "ravg"),
                 (Func("agg", agg="sum", expr=ir.col(2), frame_whole=True), "tot"),
                 (Func("agg", agg="avg", expr=ir.col(2), frame_whole=True), "av")])
        out.append(canon(rows(list(w.execute(0, ctx)))))
    assert out[0] == out[1]
    assert isinstance(out[1][0][3], d.Decimal)
