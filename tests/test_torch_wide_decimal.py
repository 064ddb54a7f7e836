"""Wide decimal(38,x) columns through the port against the JAX package (the
fifteen cases of ``tests/test_wide_decimal.py``): scan -> join -> two-stage
aggregate, file shuffles read across the two packages in both directions
(a decimal64 and a wide column, hash-partitioned on either), wide join
keys, sorts, sums past 38 digits (NULL), comparisons against literals and
integers, Coalesce and CASE over wide branches, exact literal and
column-pair arithmetic, windowed sums and averages. Every plan is built
once with the JAX package's builders and decoded by both planners (a
memory scan stands in for the reference's parquet scan); rows compare
exactly, decimals as Decimals, against each other and against a Python
``decimal`` oracle."""

import decimal as pydec

import numpy as np
import pytest

from auron_tpu import types as JT
from auron_tpu.columnar import Batch as JBatch
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exprs.ir import BinaryOp, Case, Coalesce, col, lit
from auron_tpu.ops.sortkeys import SortSpec
from auron_tpu.plan import builders as B
from auron_tpu.plan import planner as jplanner
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.plan import planner as pplanner
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import canon, carry, rows

DEC38_4 = JT.decimal(38, 4)
FACT_SCHEMA = JT.Schema.of(JT.Field("fk", JT.INT64), JT.Field("amount", DEC38_4))
DIM_SCHEMA = JT.Schema.of(JT.Field("dk", JT.INT64), JT.Field("grp", JT.INT64))


def _dec38(rng, n, scale=4):
    """decimal(38, scale) values far beyond int64, sized so that per-group
    exact sums stay inside 38 digits."""
    out = []
    for _ in range(n):
        mag = int(rng.integers(0, 22))
        u = int(rng.integers(1, 10**9)) * (10**mag) * int(rng.choice([-1, 1]))
        out.append(pydec.Decimal(u).scaleb(-scale))
    return out


@pytest.fixture(scope="module")
def wide_data():
    rng = np.random.default_rng(77)
    n = 500
    fact = {"fk": rng.integers(0, 12, n).astype(np.int64).tolist(), "amount": _dec38(rng, n)}
    dim = {"dk": np.arange(12, dtype=np.int64).tolist(),
           "grp": (np.arange(12) % 3).astype(np.int64).tolist()}
    return fact, dim


def _batches(data: dict, schema, size: int = 128) -> list:
    """The columns as reference batches of ``size`` rows (several batches,
    so dictionaries differ from batch to batch and get merged)."""
    n = len(next(iter(data.values())))
    return [JBatch.from_pydict({k: v[s:s + size] for k, v in data.items()}, schema=schema)
            for s in range(0, n, size)]


def run_both(plan, resources: dict, conf: dict | None = None) -> list:
    """The plan's rows from both packages (resource id -> reference batches
    of one partition); asserts they hold the same rows and returns them."""
    jctx = JCtx(conf=JConf(dict(conf or {})),
                resources={k: [list(v)] for k, v in resources.items()})
    want = rows(list(jplanner.plan_from_proto(plan).execute(0, jctx)))
    port_proto = pplanner._pb().PhysicalPlanNode.FromString(plan.SerializeToString())
    pctx = PCtx(conf=PConf(dict(conf or {})), device="cpu",
                resources={k: [[carry(b) for b in v]] for k, v in resources.items()})
    got = rows(list(pplanner.plan_from_proto(port_proto).execute(0, pctx)))
    assert canon(got) == canon(want)
    return got


def _oracle(fact, dim):
    rows_: dict = {}
    grp_of = dict(zip(dim["dk"], dim["grp"]))
    for fk, amt in zip(fact["fk"], fact["amount"]):
        g = grp_of[fk]
        s, c, mn, mx = rows_.get(g, (pydec.Decimal(0), 0, None, None))
        rows_[g] = (s + amt, c + 1, amt if mn is None or amt < mn else mn,
                    amt if mx is None or amt > mx else mx)
    return dict(sorted(rows_.items()))


def test_wide_decimal_scan_join_agg_exact(wide_data):
    fact, dim = wide_data
    j = B.hash_join(B.memory_scan(FACT_SCHEMA, "f"), B.memory_scan(DIM_SCHEMA, "d"),
                    [col(0)], [col(0)], "inner", build_side="right")
    proj = B.project(j, [(col(3), "grp"), (col(1), "amount")])
    aggs = [("sum", col(1), "s"), ("count", col(1), "c"), ("min", col(1), "mn"),
            ("max", col(1), "mx")]
    final = B.hash_agg(B.hash_agg(proj, [(col(0), "grp")], aggs, "partial"),
                       [(col(0), "grp")], aggs, "final")
    got = run_both(final, {"f": _batches(fact, FACT_SCHEMA),
                           "d": [JBatch.from_pydict(dim, schema=DIM_SCHEMA)]})
    with pydec.localcontext() as hp:
        hp.prec = 100
        want = _oracle(fact, dim)
    assert sorted(got) == [(g, s, c, mn, mx) for g, (s, c, mn, mx) in want.items()]


def _write(side, batches, tmp_path, key: int, n_out: int, tag: str):
    from auron_tpu.exec.basic import MemoryScanExec as JScan
    from auron_tpu.exec.shuffle.partitioning import HashPartitioning as JHash
    from auron_tpu.exec.shuffle.writer import ShuffleWriterExec as JWriter

    from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning as PHash
    from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec as PWriter
    from auron_tpu_torch.exprs.ir import col as pcol

    d, i = str(tmp_path / f"{tag}.data"), str(tmp_path / f"{tag}.index")
    conf = {"exec.shuffle.encoding.fallback.codec": "none"}
    if side == "jax":
        w = JWriter(JScan([batches], batches[0].schema), JHash([col(key)], n_out), d, i)
        list(w.execute(0, JCtx(conf=JConf(conf))))
    else:
        pbs = [carry(b) for b in batches]
        w = PWriter(PScan([pbs], pbs[0].schema), PHash([pcol(key)], n_out), d, i)
        list(w.execute(0, PCtx(conf=PConf(conf), device="cpu")))
    return [(d, i)]


def _read(side, pairs, schema, partition: int) -> list:
    from auron_tpu.exec.shuffle.reader import IpcReaderExec as JReader
    from auron_tpu.exec.shuffle.reader import MultiMapBlockProvider as JProvider

    from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec as PReader
    from auron_tpu_torch.exec.shuffle.reader import MultiMapBlockProvider as PProvider
    from torch_carry import port_schema

    if side == "jax":
        ctx = JCtx(resources={"blocks": JProvider(pairs)})
        return rows(list(JReader(schema, "blocks").execute(partition, ctx)))
    ctx = PCtx(resources={"blocks": PProvider(pairs)}, device="cpu")
    return rows(list(PReader(port_schema(schema), "blocks").execute(partition, ctx)))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype,key", [((38, 4), 0), ((38, 4), 1), ((12, 2), 0), ((12, 2), 1)])
def test_decimal_shuffle_files_read_across_packages(wide_data, tmp_path, writer, dtype, key):
    """A decimal64 and a wide column, hash-partitioned on an int64 or on the
    decimal itself (Spark's murmur3 of the unscaled value): each package
    reads the other's dec128 (and, from the JAX writer, ENC_DICT) columns
    and gets the same rows per partition as the writer's own reader."""
    fact, _ = wide_data
    amounts = fact["amount"] if dtype[0] > 18 else [
        pydec.Decimal(int(a.as_tuple().digits[0]) * 1234567 - 5000000).scaleb(-2)
        for a in fact["amount"]]
    amounts = [a if i % 9 else None for i, a in enumerate(amounts)]
    schema = JT.Schema.of(JT.Field("fk", JT.INT64), JT.Field("amount", JT.decimal(*dtype)))
    batches = _batches({"fk": fact["fk"], "amount": amounts}, schema, 200)
    other = "port" if writer == "jax" else "jax"
    mine = _write(writer, batches, tmp_path, key, 3, writer)
    theirs = _write(other, batches, tmp_path, key, 3, other)
    total = []
    for p in range(3):
        want = _read(writer, mine, schema, p)
        assert _read(other, mine, schema, p) == want
        assert canon(_read(writer, theirs, schema, p)) == canon(want)
        total += want
    assert canon(total) == canon(list(zip(fact["fk"], amounts)))


def test_wide_decimal_join_keys():
    amounts = [pydec.Decimal("123456789012345678901234.5678"),
               pydec.Decimal("-99999999999999999999.0001"), pydec.Decimal("0.0001")]
    ls = JT.Schema.of(JT.Field("a", DEC38_4), JT.Field("x", JT.INT64))
    rs = JT.Schema.of(JT.Field("a2", DEC38_4), JT.Field("tag", JT.INT64))
    left = JBatch.from_pydict({"a": amounts * 2, "x": list(range(6))}, schema=ls)
    right = JBatch.from_pydict({"a2": amounts[:2], "tag": [10, 20]}, schema=rs)
    j = B.hash_join(B.memory_scan(ls, "l"), B.memory_scan(rs, "r"), [col(0)], [col(0)],
                    "inner", build_side="right")
    got = run_both(j, {"l": [left], "r": [right]})
    assert len(got) == 4
    for a, _, a2, tag in got:
        assert a == a2 and tag == (10 if a == amounts[0] else 20)


def test_wide_decimal_sort():
    vals = [pydec.Decimal("1e20"), pydec.Decimal("-3e25"), pydec.Decimal("7.5"), None,
            pydec.Decimal("-0.5")]
    s = JT.Schema.of(JT.Field("a", DEC38_4))
    plan = B.sort(B.memory_scan(s, "s"), [(col(0), SortSpec())])
    got = run_both(plan, {"s": [JBatch.from_pydict({"a": vals}, schema=s)]})
    assert [r[0] for r in got] == [None, pydec.Decimal("-3e25"), pydec.Decimal("-0.5"),
                                   pydec.Decimal("7.5"), pydec.Decimal("1e20")]


def test_wide_decimal_sum_overflow_goes_null():
    """An exact total past 38 digits is NULL, never a wrapped value; the
    other group's exact sum survives the partial -> final merge."""
    s = JT.Schema.of(JT.Field("k", JT.INT32), JT.Field("v", JT.decimal(38, 0)))
    vals = [pydec.Decimal(10) ** 36] * 200 + [pydec.Decimal(7)] * 3  # 2e38 > p38
    b = JBatch.from_pydict({"k": [1] * 200 + [2] * 3, "v": vals}, schema=s)
    aggs = [("sum", col(1), "s")]
    plan = B.hash_agg(B.hash_agg(B.memory_scan(s, "v"), [(col(0), "k")], aggs, "partial"),
                      [(col(0), "k")], aggs, "final")
    got = run_both(plan, {"v": [b]})
    assert sorted(got) == [(1, None), (2, pydec.Decimal(21))]


def test_wide_decimal_filter_against_literal():
    vals = [pydec.Decimal("1e25"), pydec.Decimal("-5e20"), pydec.Decimal("100.49"),
            pydec.Decimal("100.51"), None]
    s = JT.Schema.of(JT.Field("a", DEC38_4))
    plan = B.filter_(B.memory_scan(s, "w"),
                     [BinaryOp("gt", col(0), lit(pydec.Decimal("100.5"), JT.decimal(5, 1)))])
    got = run_both(plan, {"w": [JBatch.from_pydict({"a": vals}, schema=s)]})
    assert [r[0] for r in got] == [pydec.Decimal("1e25"), pydec.Decimal("100.51")]


def test_wide_decimal_outer_join_null_side():
    ls = JT.Schema.of(JT.Field("k", JT.INT64))
    rs = JT.Schema.of(JT.Field("k2", JT.INT64), JT.Field("amt", JT.decimal(38, 2)))
    left = JBatch.from_pydict({"k": [1, 2, 3]}, schema=ls)
    right = JBatch.from_pydict({"k2": [1], "amt": [pydec.Decimal("1e20")]}, schema=rs)
    j = B.hash_join(B.memory_scan(ls, "l"), B.memory_scan(rs, "r"), [col(0)], [col(0)], "left",
                    build_side="right")
    got = sorted(run_both(j, {"l": [left], "r": [right]}))
    assert got[0][2] == pydec.Decimal("1e20") and got[1][2] is None and got[2][2] is None


def test_wide_decimal_scalar_fn_fails_loudly():
    """A scalar function over a wide decimal (its values are dictionary
    codes) is refused when it runs, by both packages' registries: abs of a
    decimal(38,2) raises naming the wide decimal."""
    from auron_tpu.exprs.ir import ScalarFunc

    s = JT.Schema.of(JT.Field("a", JT.decimal(38, 2)))
    b = JBatch.from_pydict({"a": [pydec.Decimal("1.50"), None]}, schema=s)
    plan = B.project(B.memory_scan(s, "w"), [(ScalarFunc("abs", (col(0),)), "r")])
    with pytest.raises(NotImplementedError, match="decimal"):
        run_both(plan, {"w": [b]})
    port_proto = pplanner._pb().PhysicalPlanNode.FromString(plan.SerializeToString())
    op = pplanner.plan_from_proto(port_proto)
    with pytest.raises(NotImplementedError, match="decimal"):
        list(op.execute(0, PCtx(device="cpu", resources={"w": [[carry(b)]]})))


def test_wide_decimal_vs_int_compare():
    s = JT.Schema.of(JT.Field("a", JT.decimal(38, 0)), JT.Field("n", JT.INT64))
    b = JBatch.from_pydict({"a": [pydec.Decimal("5"), pydec.Decimal("1e20"), pydec.Decimal("-3")],
                            "n": [5, 7, -3]}, schema=s)
    plan = B.project(B.memory_scan(s, "w"), [(BinaryOp("eq", col(0), col(1)), "e"),
                                             (BinaryOp("gt", col(0), col(1)), "g")])
    assert run_both(plan, {"w": [b]}) == [(True, False), (False, True), (True, False)]


def test_wide_decimal_coalesce_and_case_branches():
    """Coalesce and CASE over wide branches of different scales: one
    vocabulary at the widened branch type (least/greatest are scalar
    functions, not in the port)."""
    a = [pydec.Decimal("1e25"), None, pydec.Decimal("-5")]
    c = [pydec.Decimal("3"), pydec.Decimal("2e30"), pydec.Decimal("-1e21")]
    s = JT.Schema.of(JT.Field("a", JT.decimal(38, 2)), JT.Field("c", JT.decimal(36, 4)))
    b = JBatch.from_pydict({"a": a, "c": c}, schema=s)
    plan = B.project(B.memory_scan(s, "w"), [
        (Coalesce((col(0), col(1))), "co"),
        (Case(((BinaryOp("gt", col(0), col(1)), col(0)),), col(1)), "mx")])
    got = run_both(plan, {"w": [b]})
    assert [r[0] for r in got] == [pydec.Decimal("1e25"), pydec.Decimal("2e30"),
                                   pydec.Decimal("-5")]
    assert [r[1] for r in got] == [pydec.Decimal("1e25"), pydec.Decimal("2e30"),
                                   pydec.Decimal("-5")]


def test_wide_decimal_literal_arithmetic_exact():
    vals = [pydec.Decimal("1e24"), pydec.Decimal("-250.5"), None, pydec.Decimal("0.0001")]
    s = JT.Schema.of(JT.Field("a", DEC38_4))
    b = JBatch.from_pydict({"a": vals}, schema=s)
    plan = B.project(B.memory_scan(s, "wa"), [
        (BinaryOp("mul", col(0), lit(pydec.Decimal("1.2"), JT.decimal(2, 1))), "m"),
        (BinaryOp("add", col(0), lit(pydec.Decimal("100"), JT.decimal(3, 0))), "p"),
        (BinaryOp("div", col(0), lit(pydec.Decimal("4"), JT.decimal(1, 0))), "d"),
        (BinaryOp("add", col(0), col(0)), "x")])
    got = run_both(plan, {"wa": [b]})
    assert got[0][0] == pydec.Decimal("1.2e24") and got[1][0] == pydec.Decimal("-300.6")
    assert got[2] == (None, None, None, None)
    assert got[0][1] == pydec.Decimal("1e24") + 100 and got[1][1] == pydec.Decimal("-150.5")
    assert got[3][2] == pydec.Decimal("0.0001") / 4
    assert got[0][3] == pydec.Decimal("2e24") and got[1][3] == pydec.Decimal("-501.0")


def test_wide_decimal_filter_with_literal_arith():
    s = JT.Schema.of(JT.Field("a", JT.decimal(38, 2)))
    b = JBatch.from_pydict({"a": [pydec.Decimal("100"), pydec.Decimal("130"),
                                  pydec.Decimal("1e22")]}, schema=s)
    pred = BinaryOp("gt", col(0), BinaryOp("mul", lit(pydec.Decimal("1.2"), JT.decimal(2, 1)),
                                           lit(pydec.Decimal("100"), JT.decimal(38, 2))))
    got = run_both(B.filter_(B.memory_scan(s, "w"), [pred]), {"w": [b]})
    assert [r[0] for r in got] == [pydec.Decimal("130"), pydec.Decimal("1e22")]


def test_window_wide_decimal_running_sum_and_avg():
    vals = [pydec.Decimal("1e22"), pydec.Decimal("2.5"), pydec.Decimal("-1e22"),
            pydec.Decimal("7"), None]
    s = JT.Schema.of(JT.Field("g", JT.INT64), JT.Field("o", JT.INT64),
                     JT.Field("a", JT.decimal(38, 2)))
    b = JBatch.from_pydict({"g": [1, 1, 1, 2, 2], "o": [0, 1, 2, 0, 1], "a": vals}, schema=s)
    plan = B.window(B.memory_scan(s, "w"), [col(0)], [(col(1), SortSpec())],
                    [("agg", "sum", col(2), 1, False, "run"),
                     ("agg", "sum", col(2), 1, True, "tot"),
                     ("agg", "avg", col(2), 1, True, "av")])
    got = sorted(run_both(plan, {"w": [b]}), key=lambda r: (r[0], r[1]))
    assert got[0][3] == pydec.Decimal("1e22")
    assert got[1][3] == pydec.Decimal("1e22") + pydec.Decimal("2.5")
    assert got[2][3] == pydec.Decimal("2.5")
    assert all(got[i][4] == pydec.Decimal("2.5") for i in range(3))
    with pydec.localcontext() as hp:
        hp.prec = 100
        want_av = (pydec.Decimal("2.5") / 3).quantize(pydec.Decimal(1).scaleb(-6),
                                                      rounding=pydec.ROUND_HALF_UP)
    assert got[0][5] == want_av and got[3][5] == pydec.Decimal("7")


def test_wide_decimal_column_pair_arith_pipeline():
    """price * qty over two wide columns through join -> agg -> window,
    exact against Python Decimals."""
    from auron_tpu.exprs import ir as _ir

    rng = np.random.default_rng(5)
    n = 300
    price = _dec38(rng, n, scale=4)
    qty = [pydec.Decimal(int(rng.integers(1, 50))).scaleb(-1) for _ in range(n)]
    fk = rng.integers(0, 8, n).astype(np.int64).tolist()
    schema = JT.Schema.of(JT.Field("fk", JT.INT64), JT.Field("price", DEC38_4),
                          JT.Field("qty", JT.decimal(20, 1)))
    dim = {"dk": np.arange(8, dtype=np.int64).tolist(),
           "grp": (np.arange(8) % 2).astype(np.int64).tolist()}
    j = B.hash_join(B.memory_scan(schema, "f"), B.memory_scan(DIM_SCHEMA, "d"),
                    [col(0)], [col(0)], "inner", build_side="right")
    ext = B.project(j, [(col(4), "grp"), (BinaryOp("mul", col(1), col(2)), "ext")])
    aggs = [("sum", col(1), "s"), ("count", col(1), "c")]
    final = B.hash_agg(B.hash_agg(ext, [(col(0), "grp")], aggs, "partial"),
                       [(col(0), "grp")], aggs, "final")
    w = B.window(final, [], [(col(0), SortSpec())], [("agg", "sum", col(1), 1, False, "run")])
    got = {r[0]: r for r in run_both(w, {
        "f": _batches({"fk": fk, "price": price, "qty": qty}, schema, 64),
        "d": [JBatch.from_pydict(dim, schema=DIM_SCHEMA)]})}
    out_t = _ir.arith_result_type("mul", DEC38_4, JT.decimal(20, 1))
    q = pydec.Decimal(1).scaleb(-out_t.scale)
    bound = pydec.Decimal(10) ** (out_t.precision - out_t.scale)
    grp_of = dict(zip(dim["dk"], dim["grp"]))
    want: dict = {}
    with pydec.localcontext() as hp:
        hp.prec = 100
        for k, p, qv in zip(fk, price, qty):
            v = (p * qv).quantize(q, rounding=pydec.ROUND_HALF_UP)
            s, c = want.get(grp_of[k], (pydec.Decimal(0), 0))
            want[grp_of[k]] = (s, c) if abs(v) >= bound else (s + v, c + 1)
        run = pydec.Decimal(0)
        for g in sorted(want):
            s, c = want[g]
            run += s
            assert got[g][1:] == (s, c, run), g


def test_wide_decimal_pair_div_mod_and_extreme_scales():
    from auron_tpu.exprs import ir as _ir

    a = [pydec.Decimal("1e25"), pydec.Decimal("-7.5"), pydec.Decimal("100"), None]
    bv = [pydec.Decimal("3"), pydec.Decimal("2"), pydec.Decimal("0"), pydec.Decimal("4")]
    s = JT.Schema.of(JT.Field("a", DEC38_4), JT.Field("b", JT.decimal(20, 4)))
    plan = B.project(B.memory_scan(s, "w"), [(BinaryOp("div", col(0), col(1)), "d"),
                                             (BinaryOp("mod", col(0), col(1)), "m")])
    got = run_both(plan, {"w": [JBatch.from_pydict({"a": a, "b": bv}, schema=s)]})
    dt = _ir.arith_result_type("div", DEC38_4, JT.decimal(20, 4))
    with pydec.localcontext() as hp:
        hp.prec = 100
        assert got[0][0] == (a[0] / bv[0]).quantize(pydec.Decimal(1).scaleb(-dt.scale),
                                                    rounding=pydec.ROUND_HALF_UP)
    assert got[1] == (pydec.Decimal("-3.75"), pydec.Decimal("-1.5"))
    assert got[2] == (None, None) and got[3] == (None, None)
    s2 = JT.Schema.of(JT.Field("x", JT.decimal(38, 0)), JT.Field("y", JT.decimal(38, 38)))
    b2 = JBatch.from_pydict({"x": [pydec.Decimal(10) ** 37, pydec.Decimal(1)],
                             "y": [pydec.Decimal("0." + "9" * 38), pydec.Decimal("0.5")]},
                            schema=s2)
    plan2 = B.project(B.memory_scan(s2, "c"), [(BinaryOp("gt", col(0), col(1)), "g")])
    assert run_both(plan2, {"c": [b2]}) == [(True,), (True,)]


def test_port_wide_murmur3_matches_reference():
    """Spark murmur3 of wide decimals (the minimal big-endian bytes of the
    unscaled value) and decimal64 (16 LE bytes), chained with an int64."""
    from auron_tpu.ops.hash_dispatch import hash_batch as jhash

    from auron_tpu_torch.ops.hash_dispatch import hash_batch as phash

    rng = np.random.default_rng(11)
    vals = _dec38(rng, 300) + [None, pydec.Decimal(0), pydec.Decimal("-0.0001")]
    n = len(vals)
    s = JT.Schema.of(JT.Field("a", DEC38_4), JT.Field("k", JT.INT64),
                     JT.Field("b", JT.decimal(12, 2)))
    small = [pydec.Decimal(int(x)).scaleb(-2) for x in rng.integers(-(10**11), 10**11, n)]
    jb = JBatch.from_pydict({"a": vals, "k": list(range(n)), "b": small}, schema=s)
    want = np.asarray(jhash(jb, [0, 1, 2]))
    got = phash(carry(jb), [0, 1, 2]).numpy()
    np.testing.assert_array_equal(got[:n], want[:n])


@pytest.mark.parametrize("dtype", [(7, 2), (38, 2)])
def test_planner_decimal_in_list_and_first(dtype):
    """The planner keeps a decimal IN item as a typed literal (a bare
    Decimal carries no type), so ``x IN (1.25, 1e15, NULL)`` compares
    values on a decimal64 and a wide column; ``first`` and
    ``first_ignores_null`` decode from the proto. The JAX planner hands
    the evaluator bare Decimals, which it cannot type: the port is held
    against a Python oracle here."""
    from auron_tpu.exprs.ir import In, Literal

    vals = [pydec.Decimal("1.25"), pydec.Decimal("3.50"), None, pydec.Decimal("1.25"),
            pydec.Decimal("-7.00")]
    if dtype[0] > 18:
        vals[1] = pydec.Decimal("1e15")
    s = JT.Schema.of(JT.Field("k", JT.INT64), JT.Field("a", JT.decimal(*dtype)))
    b = JBatch.from_pydict({"k": [1, 1, 2, 2, 3], "a": vals}, schema=s)
    items = (Literal(pydec.Decimal("1.25"), JT.decimal(5, 2)),
             Literal(pydec.Decimal("1e15"), JT.decimal(38, 2)), Literal(None, JT.decimal(5, 2)))
    plan = B.project(B.memory_scan(s, "w"), [(col(0), "k"), (In(col(1), items), "hit")])
    aggs = [("first", col(1), "f"), ("first_ignores_null", col(1), "fi")]
    agg = B.hash_agg(B.hash_agg(B.memory_scan(s, "w"), [(col(0), "k")], aggs, "partial"),
                     [(col(0), "k")], aggs, "final")
    port = pplanner._pb().PhysicalPlanNode
    ctx = PCtx(device="cpu", resources={"w": [[carry(b)]]})
    got = rows(list(pplanner.plan_from_proto(port.FromString(plan.SerializeToString()))
                    .execute(0, ctx)))
    wanted = {pydec.Decimal("1.25"), pydec.Decimal("1e15")}
    # SQL: no match and a NULL in the list -> NULL; a NULL input -> NULL
    assert [r[1] for r in got] == [True if v in wanted else None for v in vals]
    got = canon(rows(list(pplanner.plan_from_proto(port.FromString(agg.SerializeToString()))
                          .execute(0, PCtx(device="cpu", resources={"w": [[carry(b)]]})))))
    assert got == [(1, vals[0], vals[0]), (2, None, vals[3]), (3, vals[4], vals[4])]
