"""The port's ``collect_list`` and ``collect_set`` against the JAX
package's (``tests/test_agg_exec.py::test_collect_list_and_set``,
``::test_collect_list_multi_batch``): the same seeded batches through
PARTIAL -> PARTIAL_MERGE -> FINAL (and PARTIAL -> FINAL in one task) in
both packages, over INT, FLOAT and FLOAT32 (NaN, +-0.0), STRING, DATE,
decimal64, wide decimal and BOOL values, with NULL values and a NULL key;
the global aggregate; the generic path it takes; and states parked by a
spill.

``collect_set`` is compared exactly, in the reference's order (the text of
each value; 0.0 and -0.0 one value, the first seen kept; every NaN kept).
``collect_list`` is compared exactly too: the reference pins its order,
each group's values in input order (a stable segment sort, and partial
lists extended in row order). Floats compare exactly up to the sign of a
zero, where the reference is at fault (ROADMAP Queue 3): merging partial
states it shares one vocabulary entry between two lists that differ only
in the sign of a zero (``_vocab_key`` compares them with Python ``==``),
so a 0.0 can come back as -0.0, in a list and as a set's first-seen zero.
``test_collect_keeps_each_zero`` holds the port to the input's values bit
for bit there (a Python oracle)."""

import datetime as dt
import decimal as d
import math

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu.columnar import Batch as JBatch
from auron_tpu.exec.agg_exec import FINAL as JFINAL
from auron_tpu.exec.agg_exec import PARTIAL as JPARTIAL
from auron_tpu.exec.agg_exec import PARTIAL_MERGE as JMERGE
from auron_tpu.exec.agg_exec import AggExpr as JAgg
from auron_tpu.exec.agg_exec import HashAggExec as JHashAgg
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exprs import ir as jir
from auron_tpu.memory import memmgr as JM

from auron_tpu_torch.exec.agg_exec import FINAL, PARTIAL, PARTIAL_MERGE, AggExpr, HashAggExec
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.memory import memmgr as PM
from torch_carry import carry, rows

AGGS = [("collect_set", "s"), ("collect_list", "l")]


@pytest.fixture(autouse=True)
def _restore_managers():
    try:
        yield
    finally:
        JM.MemManager.init()
        PM.MemManager.init()


def _pkg(side):
    if side == "jax":
        return JScan, JHashAgg, JAgg, jir, (JPARTIAL, JMERGE, JFINAL), JCtx
    return (PScan, HashAggExec, AggExpr, pir, (PARTIAL, PARTIAL_MERGE, FINAL),
            lambda: PCtx(device="cpu"))


def _run(side, jbs, aggs=AGGS, n_keys=1, merge: bool = True):
    """(final rows, the PARTIAL context's metrics): PARTIAL of each batch
    as its own task, PARTIAL_MERGE of the states in two tasks, FINAL in
    one; without ``merge`` one PARTIAL task over every batch, then FINAL."""
    Scan, Agg, Expr, ir, (p, pm, f), ctx_of = _pkg(side)
    if side != "jax":
        jbs = [carry(b) for b in jbs]
    keys = [(ir.col(i), f"k{i}") for i in range(n_keys)]
    pctx = ctx_of()

    def agg(inputs, mode, col_of):
        specs = [(Expr(fn, ir.col(col_of(i))), name) for i, (fn, name) in enumerate(aggs)]
        out = []
        for group in inputs:
            out += list(Agg(Scan([group], group[0].schema), keys, specs, mode).execute(
                0, pctx if mode == p else ctx_of()))
        return out

    inter = agg([[b] for b in jbs] if merge else [jbs], p, lambda i: n_keys)
    if merge:
        half = max(len(inter) // 2, 1)
        inter = agg([g for g in (inter[:half], inter[half:]) if g], pm, lambda i: n_keys + i)
    return rows(agg([inter], f, lambda i: n_keys + i)), pctx.metrics.values


def _sorted(rs):
    return sorted(rs, key=lambda r: tuple((x is None, x if x is not None else 0)
                                          for x in r[:1]))


def _same_float(a, b) -> bool:
    return a == b or (isinstance(a, float) and isinstance(b, float) and math.isnan(a)
                      and math.isnan(b))


def _same_items(g: list, w: list, zero_sign: bool) -> bool:
    """Equal lists, in order: by repr, or with ``zero_sign`` False floats
    up to the sign of a zero (NaN equal to NaN)."""
    if zero_sign:
        return repr(g) == repr(w)
    return len(g) == len(w) and all(_same_float(a, b) for a, b in zip(g, w))


def _assert_match(got, want, n_keys=1, zero_sign=True):
    """collect_set (column n_keys), then collect_list, each in order."""
    got, want = _sorted(got), _sorted(want)
    assert [r[:n_keys] for r in got] == [r[:n_keys] for r in want]
    for g, w in zip(got, want):
        for c in (n_keys, n_keys + 1):
            assert _same_items(g[c], w[c], zero_sign), (g[0], g[c], w[c])


def _batches(typ, gen, seed, n=300, n_batches=4, n_keys=30):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        k = [int(x) if x % 7 else None for x in rng.integers(0, n_keys, n)]
        v = [gen(rng) for _ in range(n)]
        out.append(JBatch.from_arrow(pa.RecordBatch.from_arrays(
            [pa.array(k, pa.int64()), pa.array(v, typ)], names=["k", "v"])))
    return out


def _maybe(p, fn):
    return lambda rng: fn(rng) if rng.random() > p else None


_FLOATS = [0.0, -0.0, float("nan"), 1.5, -2.25, 1e16, 10.0, 2.0]
VALUES = {
    "int": (pa.int32(), _maybe(0.1, lambda r: int(r.integers(-5, 25)))),
    "float": (pa.float64(), _maybe(0.1, lambda r: _FLOATS[int(r.integers(0, len(_FLOATS)))])),
    "float32": (pa.float32(), _maybe(0.1, lambda r: [0.0, -0.0, float("nan"), 0.1, 3.0][
        int(r.integers(0, 5))])),
    "string": (pa.string(), _maybe(0.1, lambda r: ["b", "a", "10", "2", "", "héllo"][
        int(r.integers(0, 6))])),
    "date": (pa.date32(), _maybe(0.1, lambda r: dt.date(1999, 12, 25)
                                 + dt.timedelta(days=int(r.integers(0, 40))))),
    "decimal": (pa.decimal128(9, 2), _maybe(0.1, lambda r: d.Decimal(
        int(r.integers(-300, 3000))).scaleb(-2))),
    "wide_decimal": (pa.decimal128(30, 3), _maybe(0.1, lambda r: d.Decimal(
        int(r.integers(-30, 3000))).scaleb(-3))),
    "bool": (pa.bool_(), _maybe(0.1, lambda r: bool(r.integers(0, 2)))),
}


@pytest.mark.parametrize("merge", [True, False], ids=["three_modes", "partial_final"])
@pytest.mark.parametrize("kind", list(VALUES))
def test_collect_matches_the_reference(kind, merge):
    typ, gen = VALUES[kind]
    jbs = _batches(typ, gen, seed=len(kind))
    got, metrics = _run("port", jbs, merge=merge)
    want, _ = _run("jax", jbs, merge=merge)
    _assert_match(got, want, zero_sign=not kind.startswith("float"))
    assert any(r[0] is None for r in got)  # the NULL key is a group
    # a group whose values are all NULL collects empty lists, not NULL
    assert all(r[1] is not None and r[2] is not None for r in got)


def _set_oracle(values: list) -> list:
    """The reference's set rule on the input's own values: the first of
    equal values kept (0.0 equals -0.0; no NaN equals a NaN), ordered by
    text."""
    kept: list = []
    for v in values:
        if not any(v == k for k in kept):
            kept.append(v)
    return sorted(kept, key=str)


@pytest.mark.parametrize("merge", [True, False], ids=["three_modes", "partial_final"])
def test_collect_keeps_each_zero(merge):
    """The port's collect_list over floats holds each input value bit for
    bit, in input order, and its collect_set the first of 0.0 and -0.0 a
    group saw (a Python oracle over the inputs): where the reference turns
    a 0.0 into -0.0 merging partial lists."""
    typ, gen = VALUES["float32"]
    jbs = _batches(typ, gen, seed=len("float32"))
    got, _ = _run("port", jbs, merge=merge)
    want: dict = {}
    for b in jbs:
        p = b.to_pydict()
        for k, v in zip(p["k"], p["v"]):
            want.setdefault(k, []).extend([] if v is None else [v])
    bits = lambda xs: [int(np.float32(x).view(np.int32)) for x in xs]  # noqa: E731
    assert {k: (bits(s), bits(lst)) for k, s, lst in got} == \
        {k: (bits(_set_oracle(v)), bits(v)) for k, v in want.items()}


def test_collect_of_several_keys_and_a_global_aggregate():
    rng = np.random.default_rng(11)
    jbs = []
    for _ in range(3):
        k1 = rng.integers(0, 4, 200).tolist()
        k2 = [str(x) for x in rng.integers(0, 3, 200)]
        v = [int(x) if x % 5 else None for x in rng.integers(0, 40, 200)]
        jbs.append(JBatch.from_arrow(pa.RecordBatch.from_arrays(
            [pa.array(k1, pa.int64()), pa.array(k2), pa.array(v, pa.int64())],
            names=["k1", "k2", "v"])))
    got, _ = _run("port", jbs, n_keys=2)
    want, _ = _run("jax", jbs, n_keys=2)
    key = lambda r: (r[0], r[1])  # noqa: E731
    assert [(key(r), r[2], r[3]) for r in sorted(got, key=key)] == \
        [(key(r), r[2], r[3]) for r in sorted(want, key=key)]
    g0, _ = _run("port", jbs, n_keys=0)
    w0, _ = _run("jax", jbs, n_keys=0)
    assert g0 == w0 and len(g0) == 1  # the set and the list of every k1
    assert sorted(set(g0[0][1]), key=str) == g0[0][0] and len(g0[0][1]) == 600


def test_collect_takes_the_generic_path():
    """Integer keys of a small range fold into the dense table for sums;
    with a collect the aggregate takes the generic path, as the
    reference's ``_has_host_aggs`` does, and reduces its batches coalesced
    (three batches of 300 rows: one reduce)."""
    typ, gen = VALUES["int"]
    jbs = _batches(typ, gen, seed=2, n_batches=3)
    _, metrics = _run("port", jbs, merge=False)
    assert metrics.get("dense_batches", 0) == 0
    assert metrics["generic_batches"] == 1
    agg = HashAggExec(PScan([[carry(jbs[0])]], carry(jbs[0]).schema), [(pir.col(0), "k")],
                      [(AggExpr("collect_set", pir.col(1)), "s")], PARTIAL)
    assert agg._has_host_aggs and not agg._dense_eligible()
    assert not agg._probe_eligible(PCtx(device="cpu").conf, "cuda")


def _as_multisets(rs):
    """Rows with each collect_list sorted: a spill merges the parked runs
    after the resident state, so neither package pins the list order."""
    return [(k, st, sorted(lst, key=repr)) for k, st, lst in rs]


def test_collect_states_survive_spills():
    """Partial LIST states parked by a spill under a small budget carry
    their vocabulary (an ENC_DICT block) and merge back: the answer equals
    the unbudgeted one and the reference's, spilled there too; each set
    exactly, each list as a multiset."""
    typ, gen = VALUES["string"]
    jbs = _batches(typ, gen, seed=5, n=400, n_batches=10, n_keys=300)
    free, pm = _run("port", jbs, merge=False)
    assert "spilled_aggs" not in pm
    JM.MemManager.init(budget_bytes=40_000)
    PM.MemManager.init(budget_bytes=40_000)
    got, metrics = _run("port", jbs, merge=False)
    want, jm = _run("jax", jbs, merge=False)
    assert metrics["spilled_aggs"] >= 2 and jm["spilled_aggs"] >= 2
    _assert_match(_as_multisets(got), _as_multisets(free))
    _assert_match(_as_multisets(got), _as_multisets(want))
