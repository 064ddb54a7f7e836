"""The port's spilled paths against auron_tpu's, each beside its unspilled
run: SortExec with several parked runs merged on the device (numeric keys
with ties, so the merge order shows, and dictionary-string keys), spilled
by the row threshold and by a memory budget; HashAggExec parking several
runs in partial and final mode; q3 with 4 map tasks over 4,096-row
batches under a 4,096-byte budget (the counterpart of
tests/test_tpcds.py::test_q3_concurrent_maps_with_spills, the port's map
tasks running one after another); the shuffle writer's staging spilled to
disk and read back by the JAX reader; and the classes the chip smoke
test runs under budgets (q67, q72 with its probe-side sort, q93). Both
managers are pinned to the same budget and restored in a ``finally``."""

import numpy as np
import pytest

from auron_tpu.exec.agg_exec import FINAL as JFINAL
from auron_tpu.exec.agg_exec import PARTIAL as JPARTIAL
from auron_tpu.exec.agg_exec import AggExpr as JAgg
from auron_tpu.exec.agg_exec import HashAggExec as JHashAgg
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exec.shuffle.reader import IpcReaderExec as JReader
from auron_tpu.exec.shuffle.reader import MultiMapBlockProvider as JProvider
from auron_tpu.exec.sort_exec import SortExec as JSort
from auron_tpu.exprs import ir as jir
from auron_tpu.memory import memmgr as JM
from auron_tpu.models import tpcds as jt
from auron_tpu.ops.sortkeys import SortSpec as JSpec
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.exec.agg_exec import FINAL, PARTIAL, AggExpr, HashAggExec
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec
from auron_tpu_torch.exec.sort_exec import SortExec as PSort
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.memory import memmgr as PM
from auron_tpu_torch.models import tpcds as pt
from auron_tpu_torch.ops.sortkeys import SortSpec as PSpec
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import canon, carry, jax_batch, rows

_NO_CODEC = {"exec.shuffle.encoding.fallback.codec": "none"}


@pytest.fixture(autouse=True)
def _restore_managers():
    try:
        yield
    finally:
        JM.MemManager.init()
        PM.MemManager.init()


def _budget(nbytes: int | None) -> None:
    """Pin both packages' managers to ``nbytes`` (None: the default)."""
    JM.MemManager.init(budget_bytes=nbytes)
    PM.MemManager.init(budget_bytes=nbytes)


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------


def _sort_input(seed=3, n=4000, chunk=500):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 50, n).astype(np.int64)  # ties everywhere
    s = np.empty(n, dtype=object)
    s[:] = [f"w{i:03d}" for i in rng.integers(0, 300, n)]
    cols = {"x": x, "s": s, "r": np.arange(n, dtype=np.int64),
            "f": np.round(rng.normal(size=n), 1)}
    valid = {"x": rng.random(n) > 0.1, "f": rng.random(n) > 0.2}
    return [jax_batch({k: v[i:i + chunk] for k, v in cols.items()},
                      {k: v[i:i + chunk] for k, v in valid.items()})
            for i in range(0, n, chunk)]


def _sorted_both(jbs, keys, specs, threshold, fetch=None):
    """(JAX rows, port rows, port metrics) of one SortExec over ``jbs``."""
    js = JSort(JScan([jbs], jbs[0].schema), [jir.col(c) for c in keys],
               [JSpec(asc=a, nulls_first=nf) for a, nf in specs], fetch=fetch,
               spill_threshold_rows=threshold)
    want = rows(list(js.execute(0, JCtx())))
    pbs = [carry(b) for b in jbs]
    ctx = PCtx(device="cpu")
    ps = PSort(PScan([pbs], pbs[0].schema), [pir.col(c) for c in keys],
               [PSpec(asc=a, nulls_first=nf) for a, nf in specs], fetch=fetch,
               spill_threshold_rows=threshold)
    return want, rows(list(ps.execute(0, ctx))), ctx.metrics.values


SORT_CASES = {
    "x": ([0], [(True, True)]),
    "x desc nulls last": ([0], [(False, False)]),
    "f, x": ([3, 0], [(True, False), (False, True)]),
}


@pytest.mark.parametrize("case", SORT_CASES)
@pytest.mark.parametrize("threshold", [900, 1 << 23])
def test_spilled_sort_matches_reference(case, threshold):
    """Spilled runs merge in the reference's stable order: key, then run,
    then row (the row-number column ``r`` shows every tie's order)."""
    keys, specs = SORT_CASES[case]
    jbs = _sort_input()
    want, got, metrics = _sorted_both(jbs, keys, specs, threshold)
    assert got == want and len(got) == 4000
    assert metrics.get("spilled_runs", 0) == (4 if threshold == 900 else 0)
    unspilled = _sorted_both(jbs, keys, specs, 1 << 23)[1]
    assert got == unspilled


@pytest.mark.parametrize("threshold", [500, 1 << 23])
def test_spilled_sort_on_dictionary_keys(threshold):
    """Per-run dictionary ranks do not compare across runs: every run comes
    back and the whole input re-sorts (tests/test_sort_exec.py:121)."""
    jbs = _sort_input(seed=9, n=2000, chunk=250)
    want, got, metrics = _sorted_both(jbs, [1], [(True, True)], threshold)
    assert got == want and len(got) == 2000
    assert metrics.get("spilled_runs", 0) == (4 if threshold == 500 else 0)
    assert ("merge_time" in metrics) == (threshold == 500)


def test_spilled_sort_with_fetch():
    jbs = _sort_input(seed=5)
    want, got, metrics = _sorted_both(jbs, [0, 2], [(False, True), (True, True)], 700,
                                      fetch=37)
    assert got == want and len(got) == 37 and metrics["spilled_runs"] == 4


def test_sort_spilled_by_memory_budget():
    """The budget, not the row threshold, spills: each batch's acquire
    finds the pending run over budget and spills it."""
    jbs = _sort_input(seed=7)
    unspilled = _sorted_both(jbs, [0], [(True, True)], 1 << 23)[1]
    _budget(40_000)
    want, got, metrics = _sorted_both(jbs, [0], [(True, True)], 1 << 23)
    assert got == want == unspilled
    assert metrics["spilled_runs"] >= 2
    assert PM.MemManager.get().num_spills == metrics["spilled_runs"]


def test_run_merge_order_on_cpu_is_the_plain_network():
    """bitonic.merge_runs on CPU tensors: the plain network's pairwise
    merge equals a stable lexsort of the concatenated runs."""
    import torch

    from auron_tpu_torch.ops import bitonic

    rng = np.random.default_rng(11)
    runs, base = [], 0
    for n in (700, 1, 1500, 333):
        w = np.sort(rng.integers(0, 40, n)).astype(np.int64) << 33
        runs.append((torch.from_numpy(w), torch.arange(base, base + n, dtype=torch.int32)))
        base += n
    got = bitonic.merge_runs(runs, narrow=(False, False), kinds=("u64", "u32"))
    cat = [torch.cat([r[i] for r in runs]) for i in range(2)]
    want = bitonic.lex_sorted(tuple(cat), ("u64", "u32"))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------


def _agg_input(seed=31, n=20_000, chunk=2000):
    rng = np.random.default_rng(seed)
    # a wide key range keeps the dense table ineligible: the generic path spills
    k = rng.integers(0, 3000, n) * 1_000_003
    v = rng.normal(size=n)
    c = rng.integers(-50, 50, n)
    return [jax_batch({"k": k[i:i + chunk], "v": v[i:i + chunk], "c": c[i:i + chunk]},
                      {"c": rng.random(chunk) > 0.1}) for i in range(0, n, chunk)]


def _aggs(pkg_agg, ir, mode):
    if mode == "partial":
        return [(pkg_agg("sum", ir.col(1)), "s"), (pkg_agg("avg", ir.col(2)), "a"),
                (pkg_agg("min", ir.col(2)), "m"), (pkg_agg("count_star"), "n")]
    return [(pkg_agg("sum", ir.col(1)), "s"), (pkg_agg("avg", ir.col(2)), "a"),
            (pkg_agg("min", ir.col(4)), "m"), (pkg_agg("count_star"), "n")]


def _run_agg(side, jbs):
    """(final rows, partial metrics, final metrics): a partial aggregate by
    k over all of ``jbs`` (one task), and a final aggregate over the partial
    states of each batch alone (one task of several inputs)."""
    if side == "jax":
        Scan, Agg, Expr, ir, modes = JScan, JHashAgg, JAgg, jir, (JPARTIAL, JFINAL)
        ctx_of = JCtx
    else:
        jbs = [carry(b) for b in jbs]
        Scan, Agg, Expr, ir, modes = PScan, HashAggExec, AggExpr, pir, (PARTIAL, FINAL)
        ctx_of = lambda: PCtx(device="cpu")  # noqa: E731

    def partial(batches, ctx):
        op = Agg(Scan([batches], batches[0].schema), [(ir.col(0), "k")],
                 _aggs(Expr, ir, "partial"), modes[0])
        return list(op.execute(0, ctx))

    pctx = ctx_of()
    partial(jbs, pctx)
    inter = [out for b in jbs for out in partial([b], ctx_of())]
    final = Agg(Scan([inter], inter[0].schema), [(ir.col(0), "k")], _aggs(Expr, ir, "final"),
                modes[1])
    fctx = ctx_of()
    got = rows(list(final.execute(0, fctx)))
    return got, pctx.metrics.values, fctx.metrics.values


def _assert_groups(got, want):
    got, want = canon(got), canon(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g[0], g[3], g[4]) == (w[0], w[3], w[4])
        assert g[1] == pytest.approx(w[1], rel=1e-9, abs=1e-12)
        assert g[2] == pytest.approx(w[2], rel=1e-9)


def test_agg_spilled_in_partial_and_final_mode_matches_reference():
    jbs = _agg_input()
    unspilled, p0, f0 = _run_agg("port", jbs)
    assert "spilled_aggs" not in p0 and "spilled_aggs" not in f0
    _budget(200_000)
    want, jp, jf = _run_agg("jax", jbs)
    got, pp, fp = _run_agg("port", jbs)
    _assert_groups(got, want)
    _assert_groups(got, unspilled)
    assert jp["spilled_aggs"] >= 2 and pp["spilled_aggs"] >= 2  # several parked runs
    assert jf["spilled_aggs"] >= 2 and fp["spilled_aggs"] >= 2  # and in final mode
    assert "partial_agg_skipped" not in pp


def test_partial_skipping_does_not_engage_once_a_run_is_parked():
    """All-distinct keys would switch partial aggregation to pass-through,
    but not after the table parked a run (reference agg_exec.py:501)."""
    rng = np.random.default_rng(2)
    n = 30_000
    k = rng.permutation(n) * 1.5  # a float key: the generic path from the start
    jbs = [jax_batch({"k": k[i:i + 3000], "v": rng.normal(size=3000)})
           for i in range(0, n, 3000)]
    pbs = [carry(b) for b in jbs]

    def partial(budget):
        PM.MemManager.init(budget_bytes=budget)
        ctx = PCtx(device="cpu", conf=PConf({"partial.agg.skipping.min.rows": 10_000}))
        op = HashAggExec(PScan([pbs], pbs[0].schema), [(pir.col(0), "k")],
                         [(AggExpr("sum", pir.col(1)), "s")], PARTIAL)
        return rows(list(op.execute(0, ctx))), ctx.metrics.values

    free_rows, free = partial(None)
    assert free["partial_agg_skipped"] == 1
    tight_rows, tight = partial(20_000)
    assert tight["spilled_aggs"] >= 1 and "partial_agg_skipped" not in tight
    assert canon(tight_rows) == canon(free_rows)


# ---------------------------------------------------------------------------
# shuffle staging
# ---------------------------------------------------------------------------


def _shuffle_input(seed=4, n_batches=4, n=3000):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        s = np.empty(n, dtype=object)
        s[:] = rng.choice(["a", "bb", "ccc"], n)
        out.append(jax_batch(
            {"k": rng.integers(1, 100_000, n, dtype=np.int64),
             "price": np.round(rng.gamma(2.0, 25.0, n), 2), "s": s},
            {"k": rng.random(n) > 0.85}))
    return out


def test_spilled_shuffle_staging_read_by_reference(tmp_path):
    """Under a tiny budget every map task's staging parks its blocks in
    ``.shuffle.spill`` files; the committed files hold each partition's
    rows in the unspilled order, and the JAX reader reads them."""
    jbs = _shuffle_input()
    schema = jbs[0].schema
    n_out = 3

    def write(tag):
        pairs, spilled = [], 0
        for m in range(2):
            pbs = [carry(b) for b in jbs]
            d, i = str(tmp_path / f"{tag}{m}.data"), str(tmp_path / f"{tag}{m}.index")
            ctx = PCtx(conf=PConf({**_NO_CODEC, "shuffle.compression.target.buf.size": 20_000}),
                       device="cpu")
            w = ShuffleWriterExec(PScan([pbs], pbs[0].schema),
                                  HashPartitioning([pir.col(0)], n_out), d, i)
            list(w.execute(0, ctx))
            spilled += ctx.metrics.values.get("spilled_shuffle_runs", 0)
            pairs.append((d, i))
        return pairs, spilled

    plain, none = write("plain")
    PM.MemManager.init(budget_bytes=30_000)
    spilled_pairs, spilled = write("spilled")
    assert none == 0 and spilled >= 4  # at least two a map task
    assert PM.MemManager.get().num_spills == spilled
    total = 0
    for p in range(n_out):
        def read(pairs):
            ctx = JCtx(conf=JConf(dict(_NO_CODEC)), resources={"blocks": JProvider(pairs)})
            return rows(list(JReader(schema, "blocks").execute(p, ctx)))

        want = read(plain)
        assert read(spilled_pairs) == want
        total += len(want)
    assert total == 2 * 4 * 3000


# ---------------------------------------------------------------------------
# whole classes under budgets
# ---------------------------------------------------------------------------

SF = 0.02


@pytest.fixture(scope="module")
def data():
    return jt.generate(SF, 42), pt.generate(SF, 42)


def test_q3_maps_under_a_tiny_budget(data, tmp_path):
    """q3, 4 map tasks over 4,096-row batches under a 4,096-byte budget: the
    JAX function's answer and the oracle's. The port runs its map tasks one
    after another, and the one spillable consumer of a q3 task (its
    shuffle staging) holds nothing when it first acquires, so unlike the
    JAX package's concurrent maps nothing spills; every acquire found the
    pool over budget and none of them waited."""
    jd, pd_ = data
    w = jt.run_q3_class(jd, n_map=4, n_reduce=2, work_dir=str(tmp_path))
    want = {"d_year": w["d_year"].to_numpy(np.int32),
            "i_brand_id": w["i_brand_id"].to_numpy(np.int32), "s": w["s"].to_numpy()}
    fact = pt.to_batches(pd_.store_sales, 4, 4096, device="cpu")
    ingested = pt.ingest_q3(pd_, 4, device="cpu", fact=fact)
    stats: dict = {}
    got = pt.run_q3_class(n_reduce=2, device="cpu", ingested=ingested, stats=stats,
                          conf={"memory.hbm.budget.bytes": 4096})
    for k in ("d_year", "i_brand_id"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)
    o = pt.q3_class_oracle(pd_)
    np.testing.assert_array_equal(got["i_brand_id"], o["i_brand_id"])
    mem = stats["memory"]
    assert mem["budget_bytes"] == int(4096 * 0.6)
    assert (mem["num_spills"], mem["num_waits"]) == (0, 0)
    assert PM.MemManager.get().budget > 4096  # the process manager came back


def _small_batches(pd_, name):
    """Each class's inputs in small batches, so that a tiny budget meets
    several staged batches (SF 8 on the card has 22 fact batches)."""
    if name == "q93":
        return pt.ingest_q93(pd_, 4, "cpu", fact=pt.to_batches(pd_.store_sales, 4, 2048, "cpu"))
    if name == "q72":
        return pt.ingest_q72(pd_, 4, "cpu")
    cut = pt._prefixed(pd_, pt.WINDOW_PREFIX[name])
    return pt.ingest_q3(cut, 1, "cpu", fact=pt.to_batches(cut.store_sales, 1, 500, "cpu"))


@pytest.mark.parametrize("name,conf,counter", [
    ("q93", {"memory.hbm.budget.bytes": 100_000}, "ShuffleWriterExec.spilled_shuffle_runs"),
    ("q72", {"memory.hbm.budget.bytes": 400_000, "auron.smj.elide.sorts": "build",
             "batch.size": 2048}, "SortExec.spilled_runs"),
    ("q67", {"memory.hbm.budget.bytes": 120_000, "memory.host.spill.budget.bytes": 20_000},
     "HashAggExec.spilled_aggs"),
])
def test_budgeted_classes_equal_their_unbudgeted_runs(data, name, conf, counter):
    """The chip smoke test's budgeted runs, at a small scale: each equals its
    oracle and its own run without a budget, and its operators spilled (q67
    also demotes host spills to disk)."""
    _, pd_ = data
    run = getattr(pt, f"run_{name}_class")
    ingested = _small_batches(pd_, name)
    kw = {"rows": pt.WINDOW_PREFIX[name]} if name == "q67" else {}
    base_conf = {k: v for k, v in conf.items() if not k.startswith("memory.")}
    free = run(device="cpu", conf=base_conf, ingested=ingested)
    stats: dict = {}
    got = run(device="cpu", conf=conf, stats=stats, ingested=ingested)
    want = getattr(pt, f"{name}_class_oracle")(pd_, **kw)
    for other in (free, want):
        assert sorted(got) == sorted(other)
        for k, w in other.items():
            if got[k].dtype.kind == "f":
                np.testing.assert_allclose(got[k], w, rtol=1e-9, atol=1e-12)
            else:
                np.testing.assert_array_equal(got[k], w)
    assert stats["counters"][counter] >= 2
    assert stats["memory"]["num_spills"] >= 2
    if name == "q67":
        assert stats["memory"]["demotions"] >= 1 and stats["memory"]["disk_bytes"] > 0
