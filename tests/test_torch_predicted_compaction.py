"""Predicted compaction in the port (exec/selectivity.py, runtime/
transfer.py): with the predictor on and off, a broadcast hash join, a
sort-merge join, a fused chain and a partial aggregate give bit-identical
rows, equal to auron_tpu's; a selectivity that shifts mid-stream under
headroom 1.0 and patience 1 forces bucket repairs (``sel_mispredicts``)
without changing a row; and the dense aggregate's deferred fold takes its
restart path when the key range outgrows the anchored table."""

import numpy as np
import pytest

from auron_tpu.exec import agg_exec as jagg
from auron_tpu.exec import basic as jbasic
from auron_tpu_torch.exec import agg_exec as pagg
from auron_tpu_torch.exec import basic as pbasic
from torch_joins import JAX, PORT, batches, counter, join, run, scan, star

#: forces mispredicts: no headroom over the EWMA, shrink after one low batch
TIGHT = {"exec.selectivity.headroom": 1.0, "exec.selectivity.shrink.patience": 1}


def _shifting_fact(n=12000, chunk=1000, seed=0):
    """Per 1000-row batch, a share of matching keys that jumps around:
    ~0 %, 100 %, 3 %, 60 %, ... (keys >= 5000 match no build row)."""
    rng = np.random.default_rng(seed)
    shares = np.array([0.001, 1.0, 0.03, 0.6, 0.01, 0.9, 0.2, 1.0, 0.0, 0.5, 0.05, 0.8])
    share = np.repeat(shares, chunk)[:n]
    hit = rng.random(n) < share
    k = np.where(hit, rng.integers(0, 64, n), rng.integers(5000, 6000, n))
    return {"k": k, "amt": rng.normal(size=n), "q": rng.integers(0, 100, n)}


def _dim(n=64):
    return batches({"id": np.arange(n, dtype=np.int64), "v": np.arange(n) * 3.5})


def _modes(make_op, conf):
    """{mode: (rows, metrics)} of the port with the predictor on and off."""
    return {mode: run(PORT, make_op(PORT), {**conf, "exec.selectivity.predictor": mode},
                      metrics=True) for mode in ("on", "off")}


@pytest.mark.parametrize("conf", ({}, TIGHT), ids=("default", "tight"))
@pytest.mark.parametrize("kind", ("bhj_right", "smj"))
def test_join_bit_identical_on_and_off(kind, conf):
    fact = batches(_shifting_fact(), None, 1000)
    modes = _modes(lambda pkg: join(pkg, kind, fact, _dim(), "inner"), conf)
    want = run(JAX, join(JAX, kind, fact, _dim(), "inner"), conf)
    (on, snap), (off, snap_off) = modes["on"], modes["off"]
    assert on == off == want
    assert counter(snap, "blocking_reads") == counter(snap, "unique_streams") == 1
    assert counter(snap_off, "blocking_reads") == 12
    if conf:
        assert counter(snap, "sel_mispredicts") > 0


@pytest.mark.parametrize("conf", ({}, TIGHT), ids=("default", "tight"))
def test_chain_bit_identical_on_and_off(conf):
    f = _shifting_fact()
    f["k2"] = f["q"] % 10
    fact = batches(f, None, 1000)
    d2 = batches({"id": np.arange(8, dtype=np.int64), "w": np.arange(8) * 2})
    modes = _modes(lambda pkg: star(pkg, fact, [_dim(), d2], [0, 3]), conf)
    want = run(JAX, star(JAX, fact, [_dim(), d2], [0, 3]), conf)
    (on, snap), (off, _) = modes["on"], modes["off"]
    assert on == off == want
    assert counter(snap, "blocking_reads") == 1
    if conf:
        assert counter(snap, "sel_mispredicts") > 0


def _partial_agg(pkg, fact):
    """Filter (shifting selectivity) -> PARTIAL aggregate keyed by a
    float (never the dense table): sum, count, min, avg."""
    ir = pkg[0]
    basic, agg = (pbasic, pagg) if pkg is PORT else (jbasic, jagg)
    flt = basic.FilterExec(scan(pkg, fact), [ir.BinaryOp("lt", ir.col(0), ir.lit(5000))])
    key = ir.Cast(ir.BinaryOp("mod", ir.col(2), ir.lit(7)), _f64(pkg))
    return agg.HashAggExec(flt, [(key, "g")], [
        (agg.AggExpr("sum", ir.col(1)), "s"), (agg.AggExpr("count", ir.col(1)), "c"),
        (agg.AggExpr("min", ir.col(2)), "mn"), (agg.AggExpr("avg", ir.col(1)), "a")],
        "partial")


def _f64(pkg):
    if pkg is PORT:
        from auron_tpu_torch import types as T
    else:
        from auron_tpu import types as T
    return T.FLOAT64


@pytest.mark.parametrize("conf", ({}, TIGHT, {"exec.agg.partial.defer": "off"}),
                         ids=("default", "tight", "defer_off"))
def test_partial_aggregate_bit_identical_on_and_off(conf):
    fact = batches(_shifting_fact(seed=3), None, 1000)
    modes = _modes(lambda pkg: _partial_agg(pkg, fact), conf)
    (on, snap), (off, _) = modes["on"], modes["off"]
    assert on == off
    want = run(JAX, _partial_agg(JAX, fact), conf)
    assert len(on) == len(want)
    for g, w in zip(on, want):
        assert g[0] == w[0] and g[2:4] == w[2:4]  # key, count, min exact
        assert g[1] == pytest.approx(w[1], rel=1e-9) and g[4] == pytest.approx(w[4], rel=1e-9)
    if conf == TIGHT:
        assert counter(snap, "sel_mispredicts") > 0
    if conf.get("exec.agg.partial.defer") != "off":
        # the (live, group) counts rode the window: no blocking read but repairs
        assert counter(snap, "async_reads") + counter(snap, "drain_waits") == 12
        assert counter(snap, "blocking_reads") == counter(snap, "sel_mispredicts")


def _dense_agg(pkg, fact, mode):
    ir = pkg[0]
    agg = pagg if pkg is PORT else jagg
    p = agg.HashAggExec(scan(pkg, fact), [(ir.col(0), "k")],
                        [(agg.AggExpr("sum", ir.col(1)), "s"),
                         (agg.AggExpr("count_star", None), "n")], "partial")
    if mode == "partial":
        return p
    return agg.HashAggExec(p, [(ir.col(0), "k")],
                           [(agg.AggExpr("sum", ir.col(1)), "s"),
                            (agg.AggExpr("count", ir.col(2)), "n")], "final")


@pytest.mark.parametrize("depth", (1, 4))
@pytest.mark.parametrize("mode", ("partial", "final"))
def test_dense_aggregate_restart_path(monkeypatch, mode, depth):
    """Key ranges grow batch by batch past the anchored table: the deferred
    range flags come back false, the table drains and re-anchors, and the
    answer stays the reference's."""
    restarts = []
    orig = pagg._DenseAggState.reset_with_retry

    def spy(self):
        out = orig(self)
        restarts.append(len(out))
        return out

    monkeypatch.setattr(pagg._DenseAggState, "reset_with_retry", spy)
    rng = np.random.default_rng(9)
    spans = [10, 12, 300, 310, 5000, 5100, 90000, 90000]
    k = np.concatenate([rng.integers(-s // 3, s, 700) for s in spans])
    fact = batches({"k": k, "v": np.round(rng.normal(size=len(k)), 3)}, None, 700)
    conf = {"runtime.transfer.window.depth": depth}
    got = run(PORT, _dense_agg(PORT, fact, mode), conf)
    want = run(JAX, _dense_agg(JAX, fact, mode), conf)
    assert restarts and max(restarts) >= 1
    if mode == "final":
        assert [r[0] for r in got] == [r[0] for r in want]
        assert [r[2] for r in got] == [r[2] for r in want]
        np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=1e-9)
    else:  # partial states merge differently: compare per key
        def by_key(rs):
            out = {}
            for key, s, n in rs:
                ps, pn = out.get(key, (0.0, 0))
                out[key] = (ps + s, pn + n)
            return out
        g, w = by_key(got), by_key(want)
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key][1] == w[key][1]
            assert g[key][0] == pytest.approx(w[key][0], rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("shape", ("bhj", "smj", "chain", "agg"))
def test_early_close_releases_windows(monkeypatch, shape):
    """A LIMIT above the operator stops the stream early: every transfer
    window is emptied and every memory consumer the task registered is
    gone."""
    from auron_tpu_torch.exec.basic import LimitExec
    from auron_tpu_torch.memory.memmgr import MemManager
    from auron_tpu_torch.runtime import transfer
    from torch_carry import run_tree
    from auron_tpu_torch.utils.config import Configuration

    windows = []
    orig = transfer.TransferWindow.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        windows.append(self)

    for mod in ("auron_tpu_torch.exec.joins.driver", "auron_tpu_torch.exec.joins.chain",
                "auron_tpu_torch.exec.agg_exec"):
        monkeypatch.setattr(f"{mod}.TransferWindow.__init__", spy)
    f = _shifting_fact()
    f["k2"] = f["q"] % 10
    fact = batches(f, None, 1000)
    d2 = batches({"id": np.arange(8, dtype=np.int64), "w": np.arange(8) * 2})
    op = {"bhj": lambda: join(PORT, "bhj_right", fact, _dim(), "inner"),
          "smj": lambda: join(PORT, "smj", fact, _dim(), "inner"),
          "chain": lambda: star(PORT, fact, [_dim(), d2], [0, 3]),
          "agg": lambda: _partial_agg(PORT, fact)}[shape]()
    before = list(MemManager.get()._consumers)
    out, _ = run_tree(LimitExec(op, 5), {}, conf=Configuration(dict(TIGHT)), device="cpu")
    assert sum(int(b.device.sel.sum()) for b in out) == 5
    assert windows and all(len(w) == 0 and w.nbytes == 0 for w in windows)
    assert MemManager.get()._consumers == before
