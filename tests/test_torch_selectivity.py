"""The port's selectivity predictor against auron_tpu's, and its transfer
window on the CPU: the same observation streams give the same predicted
buckets and mispredict counts (growth, shrink after the patience, the
clamp to the input capacity, the knob resolution); the window keeps FIFO
order and its depth, and counts its reads."""

import numpy as np
import pytest
import torch

from auron_tpu.exec.selectivity import (
    SelectivityPredictor as JPred, predictor_enabled as j_enabled,
)
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.exec.metrics import MetricNode
from auron_tpu_torch.exec.selectivity import (
    SelectivityPredictor as PPred, predictor_enabled as p_enabled,
)
from auron_tpu_torch.runtime.transfer import (
    TransferWindow, WindowGuard, blocking_read, harvest, start_host_transfer,
)
from auron_tpu_torch.utils.config import Configuration as PConf


def _stream(kind: str, rng) -> list[tuple[int, int]]:
    """(input capacity, live count) per batch."""
    if kind == "growth":
        return [(1 << 16, int(x)) for x in np.geomspace(10, 60000, 30)]
    if kind == "shrink":
        return [(1 << 16, 50000)] * 5 + [(1 << 16, 300)] * 12 + [(1 << 16, 40)] * 12
    if kind == "clamp":  # live counts near capacity, capacity shrinking
        caps = [1 << 17] * 6 + [1 << 12] * 6 + [128] * 6
        return [(c, c - 3) for c in caps]
    if kind == "oscillate":
        return [(1 << 15, 30000 if i % 3 else 200) for i in range(40)]
    return [(int(c), int(rng.integers(0, c + 1)))
            for c in rng.choice([128, 1 << 10, 1 << 14, 1 << 20], 60)]


CONFS = (
    {},
    {"exec.selectivity.headroom": 1.0, "exec.selectivity.shrink.patience": 1},
    {"exec.selectivity.ewma.alpha": 0.9, "exec.selectivity.headroom": 3.0},
    {"exec.selectivity.ewma.alpha": 0.0001, "exec.selectivity.shrink.patience": 0},
)


@pytest.mark.parametrize("conf", CONFS)
@pytest.mark.parametrize("kind", ("growth", "shrink", "clamp", "oscillate", "random"))
def test_predict_sequence_matches_reference(kind, conf):
    rng = np.random.default_rng(len(kind))
    jp, pp = JPred(JConf(dict(conf))), PPred(PConf(dict(conf)))
    seq_j, seq_p = [], []
    for cap, n in _stream(kind, rng):
        a, b = jp.predict(cap), pp.predict(cap)
        seq_j.append(a)
        seq_p.append(b)
        jp.observe(n, predicted=a)
        pp.observe(n, predicted=b)
    assert seq_p == seq_j
    assert (pp.mispredicts, pp.predictions) == (jp.mispredicts, jp.predictions)
    assert seq_p[0] is None  # no history: the caller seeds with a blocking read
    if kind == "clamp":
        assert max(b for (cap, _), b in zip(_stream(kind, rng), seq_p)
                   if b is not None and cap == 128) == 128
    if kind == "shrink" and conf.get("exec.selectivity.shrink.patience") == 1:
        assert seq_p[-1] < seq_p[5]


@pytest.mark.parametrize("compact", ("on", "off", "auto"))
@pytest.mark.parametrize("mode", ("on", "off", "auto"))
def test_knob_resolution_matches_reference(compact, mode):
    conf = {"join.compact.output": compact, "exec.selectivity.predictor": mode}
    assert p_enabled(PConf(dict(conf))) == j_enabled(JConf(dict(conf)))


def test_window_fifo_and_depth_on_cpu():
    m = MetricNode("w")
    w = TransferWindow(3, m)
    out = []
    for i in range(10):
        for resolved, payload in w.push((torch.tensor(i), torch.arange(i + 1)), f"p{i}",
                                        nbytes=8):
            out.append((int(resolved[0]), int(resolved[1].sum()), payload))
        assert len(w) == min(i + 1, 3)
        assert w.nbytes == 8 * len(w)
    assert [p for _, _, p in out] == [f"p{i}" for i in range(7)]
    out += [(int(r[0]), int(r[1].sum()), p) for r, p in w.drain()]
    assert [(v, s) for v, s, _ in out] == [(i, i * (i + 1) // 2) for i in range(10)]
    assert len(w) == 0 and w.nbytes == 0
    # CPU tensors are not copied: every harvest is an async read
    assert m.values == {"async_reads": 10}


def test_window_depth_one_and_clear():
    w = TransferWindow(0)  # depth clamps to 1
    assert w.depth == 1
    assert w.push((torch.tensor(1),), "a") == []
    ((r, p),) = w.push((torch.tensor(2),), "b")
    assert (int(r[0]), p) == (1, "a")
    guard = WindowGuard("g", w)
    w.push((torch.tensor(3),), "c", nbytes=100)
    assert guard.mem_used() > 0 and guard.spill() == 0
    w.clear()
    assert len(w) == 0 and guard.mem_used() == 0
    assert list(w.drain()) == []


def test_harvest_and_blocking_read_count():
    m = MetricNode("r")
    (a,) = harvest(start_host_transfer(torch.tensor([1, 2, 3])), m)
    assert a.tolist() == [1, 2, 3]
    (b,) = blocking_read(m, torch.tensor(7))
    assert int(b) == 7
    assert m.values == {"async_reads": 1, "blocking_reads": 1}


def test_harvest_that_waits_counts_apart_from_blocking_reads(monkeypatch):
    """A harvest whose copy is not done yet (the card is behind the host)
    is a ``waited_reads`` (``drain_waits`` at the end of a stream), never a
    ``blocking_reads``: that counter holds only the reads the code chose to
    block on, so "one blocking read a probe stream" does not depend on how
    far the card lags."""
    from auron_tpu_torch.runtime import transfer
    from auron_tpu_torch.runtime.transfer import HostTransfer

    class _Pending:
        def query(self):
            return False

        def synchronize(self):
            pass

    real = transfer.start_host_transfer

    def pending(*tensors):
        return HostTransfer(real(*tensors).host, _Pending())

    monkeypatch.setattr(transfer, "start_host_transfer", pending)
    m = MetricNode("r")
    (a,) = harvest(pending(torch.tensor(5)), m)
    assert int(a) == 5
    w = TransferWindow(1, m)
    assert w.push((torch.tensor(6),), "x") == []
    ((r, p),) = w.push((torch.tensor(7),), "y")
    assert (int(r[0]), p) == (6, "x")
    assert [p for _, p in w.drain()] == ["y"]
    assert m.values == {"waited_reads": 2, "drain_waits": 1}
