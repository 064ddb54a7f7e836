"""The port's fused star-schema join chain (exec/joins/chain.py) against
auron_tpu on the cases of tests/test_join_chain.py: two- and three-level
chains, NULL keys, a non-unique build that falls back without building
twice, all rows surviving (dense), compaction off, a selectivity jump that
forces bucket repairs, selectivity fuzz, and window depth 1. Each run's
rows equal the JAX run's; the fused path must have run where it applies."""

import numpy as np
import pytest

from auron_tpu_torch.exec.joins import chain as chain_mod
from auron_tpu_torch.exec.joins.driver import EquiJoinDriver
from torch_joins import JAX, PORT, batches, counter, run, star


@pytest.fixture
def fused_calls(monkeypatch):
    calls = []
    orig = chain_mod._run_chain

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(chain_mod, "_run_chain", spy)
    return calls


def _dim(n: int, mult: int):
    return batches({"id": np.arange(n, dtype=np.int64),
                    "v": np.arange(n, dtype=np.int64) * mult})


def _fact_dims(n=500, nd1=40, nd2=25, seed=0):
    rng = np.random.default_rng(seed)
    fact = {"k0": rng.integers(0, nd1 + 5, n), "k1": rng.integers(0, nd2 + 5, n),
            "amt": rng.normal(size=n).round(3)}
    return fact, _dim(nd1, 10), _dim(nd2, 7)


def _both(fact, dims, keys, chunk, conf=None, valid=None):
    """(port rows, port metrics, reference rows) of the star join."""
    fb = batches(fact, valid, chunk)
    got, snap = run(PORT, star(PORT, fb, dims, keys), conf, metrics=True)
    want = run(JAX, star(JAX, fb, dims, keys), conf)
    return got, snap, want


def test_fused_two_level_chain(fused_calls):
    fact, d1, d2 = _fact_dims()
    got, snap, want = _both(fact, [d1, d2], [0, 1], 37)
    assert got == want and got
    assert fused_calls == [1]
    # one probe stream: one seed read, the rest rode the window
    assert counter(snap, "unique_streams") == 1
    assert counter(snap, "blocking_reads") == 1
    assert counter(snap, "async_reads") + counter(snap, "drain_waits") == 13


def test_three_level_chain_with_nulls(fused_calls):
    rng = np.random.default_rng(2)
    n = 400
    fact = {"k0": rng.integers(0, 20, n), "k1": rng.integers(0, 15, n),
            "k2": rng.integers(0, 10, n), "amt": rng.normal(size=n).round(3)}
    valid = {"k0": np.arange(n) % 11 != 0}
    got, _, want = _both(fact, [_dim(20, 10), _dim(15, 7), _dim(10, 3)], [0, 1, 2], 64,
                         valid=valid)
    assert got == want and got
    assert fused_calls == [1]


def test_non_unique_build_falls_back_without_rebuilding(monkeypatch, fused_calls):
    fact, d1, d2 = _fact_dims(n=300)
    d2_dup = batches({"id": np.r_[np.arange(25), 3], "v": np.r_[np.arange(25) * 7, 99]})
    prepares = []
    orig = EquiJoinDriver.prepare

    def counting(self, b, device):
        prepares.append(1)
        return orig(self, b, device)

    monkeypatch.setattr(EquiJoinDriver, "prepare", counting)
    got, snap, want = _both(fact, [d1, d2_dup], [0, 1], 37)
    assert got == want and got
    assert fused_calls == [] and len(prepares) == 2


def test_dense_survival_chain(fused_calls):
    rng = np.random.default_rng(1)
    n = 256
    fact = {"k0": rng.integers(0, 8, n), "k1": rng.integers(0, 4, n), "amt": np.arange(n)}
    got, _, want = _both(fact, [_dim(8, 10), _dim(4, 7)], [0, 1], None)
    assert got == want and len(got) == n
    assert fused_calls == [1]


def test_compaction_off_emits_dense_without_reads(fused_calls):
    fact, d1, d2 = _fact_dims(n=300, seed=7)
    conf = {"join.compact.output": "off"}
    got, snap, want = _both(fact, [d1, d2], [0, 1], 37, conf)
    assert got == want and got
    assert fused_calls == [1]
    assert counter(snap, "blocking_reads") == counter(snap, "async_reads") == 0


@pytest.mark.parametrize("predictor", ("on", "off"))
def test_forced_mispredict_repair(predictor, fused_calls):
    """Selectivity jumps from ~0 to 100 % mid-stream: the predicted bucket
    is far too small, the repair re-takes, and the rows stay the reference's."""
    n = 6000
    k0 = np.where(np.arange(n) < 1000, 999, np.arange(n) % 8)
    fact = {"k0": k0, "k1": np.arange(n) % 4, "amt": np.arange(n)}
    conf = {"join.compact.output": "on", "exec.selectivity.predictor": predictor}
    got, snap, want = _both(fact, [_dim(8, 10), _dim(4, 7)], [0, 1], 1000, conf)
    assert got == want and len(got) == 5000
    if predictor == "on":
        assert counter(snap, "sel_mispredicts") > 0
        assert counter(snap, "blocking_reads") == 1
    else:  # every live count rides the window
        assert counter(snap, "blocking_reads") == 0
        assert counter(snap, "async_reads") + counter(snap, "drain_waits") == 6


@pytest.mark.parametrize("seed", range(4))
def test_predictor_parity_fuzz(seed, fused_calls):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(800, 4000))
    nd1, nd2 = int(rng.integers(4, 60)), int(rng.integers(4, 40))
    regime = rng.integers(1, 4, size=n)
    hi = nd1 + int(rng.integers(1, 30))
    k0 = np.where(regime == 1, rng.integers(0, max(nd1 // 4, 1), n),
                  np.where(regime == 2, rng.integers(0, hi, n), rng.integers(nd1, hi, n)))
    fact = {"k0": k0, "k1": rng.integers(0, nd2 + 3, n), "amt": rng.normal(size=n).round(3)}
    dims = [_dim(nd1, 10), _dim(nd2, 7)]
    on, _, want = _both(fact, dims, [0, 1], 257, {"exec.selectivity.predictor": "on"})
    off, _, _ = _both(fact, dims, [0, 1], 257, {"exec.selectivity.predictor": "off"})
    assert on == off == want


def test_window_depth_one(fused_calls):
    fact, d1, d2 = _fact_dims(n=700, seed=5)
    got, _, want = _both(fact, [d1, d2], [0, 1], 37, {"runtime.transfer.window.depth": 1})
    assert got == want and got
    assert fused_calls == [1]


def test_single_join_predictor_parity_with_mispredict(fused_calls):
    """One unique-build BHJ (the driver's compaction boundary, no chain):
    the predicted path equals the blocking one and the reference, through
    a forced repair."""
    n = 6000
    k0 = np.where(np.arange(n) < 1000, 99999, np.arange(n) % 16)
    fact = {"k0": k0, "amt": np.arange(n) * 1.5}
    dims = [_dim(16, 10)]
    on, snap, want = _both(fact, dims, [0], 1000, {"exec.selectivity.predictor": "on"})
    off, snap_off, _ = _both(fact, dims, [0], 1000, {"exec.selectivity.predictor": "off"})
    assert on == off == want
    assert fused_calls == []
    assert counter(snap, "sel_mispredicts") > 0
    assert counter(snap, "blocking_reads") == 1
    assert counter(snap_off, "blocking_reads") == 6
