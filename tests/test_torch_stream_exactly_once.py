"""Exactly-once crash-resume of the port's continuous queries
(``auron_tpu_torch/stream``) on the CPU, against the JAX package.

Every case of ``tests/test_stream_exactly_once.py`` on the port: a
pipeline killed at any instrumented seam (``FAULT_POINTS``: mid-batch,
mid-fold, mid-emission, mid-barrier) and resumed from its newest
committed checkpoint emits, emission for emission, what the never-killed
run emits, and the never-killed run's emissions equal the JAX package's
on the same records, bit for bit. Also: the gate's view
(``models/streamgate.py``) over its 5,000-event corpus gives the
reference's emission JSON and checkpoint sections (meta, offsets, state)
byte for byte, fused and eager, and the checkpoint files' framing is the
reference's.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from auron_tpu import stream as jstream
from auron_tpu import types as JT
from auron_tpu.exec import streaming as JS
from auron_tpu.utils import config as jconfig
from auron_tpu_torch import types as T
from auron_tpu_torch.exec.streaming import JsonRowDeserializer, MockKafkaSource
from auron_tpu_torch.stream import (
    CollectSink,
    JsonlFileSink,
    StreamKilled,
    StreamPipeline,
    lower_streaming_view,
)
from auron_tpu_torch.stream.pipeline import FAULT_POINTS
from auron_tpu_torch.utils.config import (
    STREAM_CALC_FUSE,
    STREAM_CHECKPOINT_INTERVAL,
    STREAM_POLL_MAX_RECORDS,
    Configuration,
)

SCHEMA = T.Schema.of(T.Field("k", T.STRING), T.Field("v", T.FLOAT64), T.Field("ts", T.INT64))
JSCHEMA = JT.Schema.of(JT.Field("k", JT.STRING), JT.Field("v", JT.FLOAT64),
                       JT.Field("ts", JT.INT64))

TUMBLE_VIEW = """
CREATE STREAMING VIEW orders_1s
  WATERMARK FOR ts AS ts - INTERVAL '2' SECOND
AS SELECT k, window_start, window_end, SUM(v) AS total, COUNT(*) AS n,
          AVG(v) AS mean, MIN(v) AS lo, MAX(v) AS hi
   FROM orders
   WHERE v >= 0
   GROUP BY k, TUMBLE(ts, INTERVAL '1' SECOND)
"""

HOP_VIEW = """
CREATE STREAMING VIEW orders_hop
  WATERMARK FOR ts AS ts - INTERVAL '1' SECOND
AS SELECT k, window_start, SUM(v) AS total, COUNT(*) AS n
   FROM orders
   GROUP BY k, HOP(ts, INTERVAL '1' SECOND, INTERVAL '3' SECOND)
"""


def _records(n=1200, seed=5, null_every=0):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        row = {"k": "kab"[int(rng.integers(0, 3))],
               "v": round(float(rng.random()) * 10 - 0.5, 3),
               "ts": int(i * 11 + int(rng.integers(0, 5)))}
        if null_every and i % null_every == 0:
            row["ts"] = None
        recs.append(json.dumps(row).encode())
    return [recs[: n // 2], recs[n // 2:]]


def _conf(poll=64, interval=2):
    c = Configuration()
    c.set(STREAM_POLL_MAX_RECORDS, poll)
    c.set(STREAM_CHECKPOINT_INTERVAL, interval)
    return c


def _factory(parts):
    return lambda mode, offsets: MockKafkaSource(parts, startup_mode=mode,
                                                 start_offsets=offsets)


def _baseline(view, parts, tmp_path, sub="base", **kw):
    plan = lower_streaming_view(view, SCHEMA)
    sink = CollectSink()
    p = StreamPipeline(plan, _factory(parts)("earliest", {}), JsonRowDeserializer(SCHEMA), sink,
                       conf=_conf(**kw), checkpoint_dir=str(tmp_path / sub), device="cpu")
    p.run(drain=True)
    p.close()
    return plan, [e.to_json() for e in sink.emissions]


def _reference(view, parts, ckdir=None, poll=64, interval=2, fuse="auto"):
    """The JAX package's pipeline over the same records: (emissions, the
    newest checkpoint's sections or None)."""
    c = jconfig.Configuration()
    c.set(jconfig.STREAM_POLL_MAX_RECORDS, poll)
    c.set(jconfig.STREAM_CHECKPOINT_INTERVAL, interval)
    c.set(jconfig.STREAM_CALC_FUSE, fuse)
    sink = jstream.CollectSink()
    p = jstream.StreamPipeline(jstream.lower_streaming_view(view, JSCHEMA),
                               JS.MockKafkaSource(parts), JS.JsonRowDeserializer(JSCHEMA),
                               sink, conf=c, checkpoint_dir=ckdir)
    p.run(drain=True)
    p.close()
    latest = p.coordinator.latest() if ckdir is not None else None
    return [e.to_json() for e in sink.emissions], latest


@pytest.fixture(scope="module")
def tumble(tmp_path_factory):
    """The never-killed TUMBLE run's emissions, held against the
    reference's once for the module."""
    parts = _records()
    tmp = tmp_path_factory.mktemp("tumble")
    plan, want = _baseline(TUMBLE_VIEW, parts, tmp)
    ref, _ = _reference(TUMBLE_VIEW, parts)
    assert want == ref
    return parts, plan, want


class _KillAt:
    """Raise StreamKilled at the n-th occurrence of one fault point."""

    def __init__(self, point, n):
        self.point, self.n, self.count = point, n, 0
        self.fired = False

    def __call__(self, pt):
        if pt == self.point:
            self.count += 1
            if self.count == self.n:
                self.fired = True
                raise StreamKilled(f"{pt}#{self.n}")


def _run_killed_then_resume(plan, parts, sink, ckdir, kill, conf):
    """One crash-resume cycle: run until the injected kill (or the clean
    end), then resume from the checkpoint dir and run to completion."""
    factory = _factory(parts)
    p = StreamPipeline(plan, factory("earliest", {}), JsonRowDeserializer(SCHEMA), sink,
                       conf=conf, checkpoint_dir=ckdir, fault=kill, device="cpu")
    try:
        p.run(drain=True)
        killed = False
    except StreamKilled:
        killed = True
    if killed:
        p2 = StreamPipeline.restore(plan, factory, JsonRowDeserializer(SCHEMA), sink, ckdir,
                                    conf=conf, device="cpu")
        p2.run(drain=True)
        p2.close()
    else:
        p.close()
    return killed


@pytest.mark.parametrize("point", FAULT_POINTS)
@pytest.mark.parametrize("occurrence", [1, 2, 3])
def test_kill_resume_bit_identical_tumble(tmp_path, tumble, point, occurrence):
    """9 fault points x 3 occurrences = 27 kill points; each killed and
    resumed run matches the baseline (the reference's) emission for
    emission."""
    parts, plan, want = tumble
    sink = CollectSink()
    kill = _KillAt(point, occurrence)
    killed = _run_killed_then_resume(plan, parts, sink, str(tmp_path / f"{point}-{occurrence}"),
                                     kill, _conf())
    got = [e.to_json() for e in sink.emissions]
    assert got == want, (f"kill at {point}#{occurrence} (fired={kill.fired}, "
                         f"killed={killed}) diverged from the baseline")


def test_kill_points_actually_fire(tmp_path, tumble):
    """Every fault point is reachable in the fuzz shape (a point that never
    fires proves nothing), and each matches the reference's list."""
    from auron_tpu.stream.pipeline import FAULT_POINTS as JPOINTS

    assert FAULT_POINTS == JPOINTS
    parts, plan, _ = tumble
    for point in FAULT_POINTS:
        kill = _KillAt(point, 1)
        _run_killed_then_resume(plan, parts, CollectSink(), str(tmp_path / f"v-{point}"),
                                kill, _conf())
        assert kill.fired, f"fault point {point} never fired"


@pytest.mark.parametrize("occurrence", [1, 2, 4, 6])
def test_kill_resume_hop_windows(tmp_path, occurrence):
    """Sliding windows: rows live in 3 overlapping windows; the fold,
    emission and checkpoint cycle still replays bit-identically, and the
    baseline is the reference's."""
    parts = _records(seed=9)
    plan, want = _baseline(HOP_VIEW, parts, tmp_path)
    if occurrence == 1:
        assert want == _reference(HOP_VIEW, parts)[0]
    sink = CollectSink()
    _run_killed_then_resume(plan, parts, sink, str(tmp_path / f"hop-{occurrence}"),
                            _KillAt("post-fold", occurrence), _conf())
    assert [e.to_json() for e in sink.emissions] == want


def test_double_kill_resume(tmp_path, tumble):
    """Two crashes in one logical stream (kill, resume, kill again, resume
    again) still converge to the baseline."""
    parts, plan, want = tumble
    conf = _conf()
    factory = _factory(parts)
    sink = CollectSink()
    ckdir = str(tmp_path / "double")
    p = StreamPipeline(plan, factory("earliest", {}), JsonRowDeserializer(SCHEMA), sink,
                       conf=conf, checkpoint_dir=ckdir, fault=_KillAt("post-emit", 1),
                       device="cpu")
    with pytest.raises(StreamKilled):
        p.run(drain=True)
    p2 = StreamPipeline.restore(plan, factory, JsonRowDeserializer(SCHEMA), sink, ckdir,
                                conf=conf, fault=_KillAt("mid-barrier", 1), device="cpu")
    with pytest.raises(StreamKilled):
        p2.run(drain=True)
    p3 = StreamPipeline.restore(plan, factory, JsonRowDeserializer(SCHEMA), sink, ckdir,
                                conf=conf, device="cpu")
    p3.run(drain=True)
    p3.close()
    assert [e.to_json() for e in sink.emissions] == want


def test_mock_source_offset_resume_regression(tmp_path):
    """A killed pipeline's checkpointed offsets seek the replacement source
    to the exact record positions: no record lost or folded twice."""
    parts = _records(n=400)
    plan = lower_streaming_view(TUMBLE_VIEW, SCHEMA)
    conf = _conf(poll=32, interval=1)
    sink = CollectSink()
    ckdir = str(tmp_path / "offsets")
    p = StreamPipeline(plan, _factory(parts)("earliest", {}), JsonRowDeserializer(SCHEMA), sink,
                       conf=conf, checkpoint_dir=ckdir, fault=_KillAt("poll", 5), device="cpu")
    with pytest.raises(StreamKilled):
        p.run(drain=True)
    ckpt_offsets = p.source.offsets()
    p2 = StreamPipeline.restore(plan, _factory(parts), JsonRowDeserializer(SCHEMA), sink, ckdir,
                                conf=conf, device="cpu")
    # at a poll-boundary kill the checkpointed positions are the crashed
    # source's positions
    assert p2.source.offsets() == ckpt_offsets
    before = p2.metrics["events_in"]
    p2.run(drain=True)
    p2.close()
    total = sum(len(part) for part in parts)
    assert p2.metrics["events_in"] - before == total - sum(ckpt_offsets.values())


def test_restore_refuses_poll_size_drift(tmp_path):
    """stream.poll.max.records is part of the checkpoint manifest: changing
    it shifts micro-batch boundaries, so restore refuses."""
    parts = _records(n=300)
    plan = lower_streaming_view(TUMBLE_VIEW, SCHEMA)
    ckdir = str(tmp_path / "drift")
    p = StreamPipeline(plan, _factory(parts)("earliest", {}), JsonRowDeserializer(SCHEMA),
                       CollectSink(), conf=_conf(poll=32, interval=1), checkpoint_dir=ckdir,
                       device="cpu")
    p.run(max_steps=3)
    p.close()
    with pytest.raises(ValueError, match="poll.max.records"):
        StreamPipeline.restore(plan, _factory(parts), JsonRowDeserializer(SCHEMA),
                               CollectSink(), ckdir, conf=_conf(poll=16, interval=1),
                               device="cpu")


def test_checkpoint_partial_write_invisible(tmp_path):
    """A kill mid-write (the temp file exists, the replace never ran) is
    invisible to latest(): resume sees the previous barrier. The file's
    bytes are the reference coordinator's."""
    from auron_tpu.stream.checkpoint import encode_checkpoint as jencode
    from auron_tpu_torch.stream.checkpoint import CheckpointCoordinator, snapshot_tmp

    coord = CheckpointCoordinator(str(tmp_path / "ck"), keep=3)
    coord.write(0, {"meta": b"a", "state": b"{}"})
    with open(snapshot_tmp(coord.path_of(1)), "wb") as f:
        f.write(b"garbage-partial")
    seq, sections = coord.latest()
    assert seq == 0 and sections == {"meta": b"a", "state": b"{}"}
    with open(coord.path_of(0), "rb") as f:
        assert f.read() == jencode({"meta": b"a", "state": b"{}"})


def test_checkpoint_prune_keeps_newest(tmp_path):
    from auron_tpu_torch.stream.checkpoint import CheckpointCoordinator

    coord = CheckpointCoordinator(str(tmp_path / "ck"), keep=2)
    for i in range(5):
        coord.write(i, {"meta": str(i).encode()})
    assert [s for s, _ in coord._committed()] == [3, 4]
    assert coord.latest()[0] == 4
    # the async writer thread commits the same files
    coord2 = CheckpointCoordinator(str(tmp_path / "ck2"), keep=2, sync=False)
    for i in range(5):
        coord2.write(i, {"meta": str(i).encode()})
    coord2.close()
    assert [s for s, _ in coord2._committed()] == [3, 4]


def test_jsonl_sink_truncate_atomic(tmp_path):
    """The durable sink's truncate drops exactly the uncommitted suffix and
    survives being applied twice; its lines are the reference's."""
    from auron_tpu.stream.sink import Emission as JEmission
    from auron_tpu_torch.stream.sink import Emission

    path = str(tmp_path / "out.jsonl")
    sink = JsonlFileSink(path)
    for i in range(5):
        e = Emission(i, i * 1000, (i + 1) * 1000, ("n",), ((i,),))
        assert e.to_json() == JEmission(i, i * 1000, (i + 1) * 1000, ("n",), ((i,),)).to_json()
        sink.emit(e)
    sink.truncate(3)
    sink.truncate(3)
    with open(path) as f:
        seqs = [json.loads(ln)["seq"] for ln in f]
    assert seqs == [0, 1, 2]


def test_null_event_time_rows_dropped(tmp_path):
    """NULL event time has no window: dropped, counted, and the drop is
    stable across kill/resume and equal to the reference's."""
    parts = _records(n=600, null_every=7)
    plan, want = _baseline(TUMBLE_VIEW, parts, tmp_path, sub="nullbase")
    assert want == _reference(TUMBLE_VIEW, parts)[0]
    sink = CollectSink()
    _run_killed_then_resume(plan, parts, sink, str(tmp_path / "nullkill"),
                            _KillAt("post-fold", 2), _conf())
    assert [e.to_json() for e in sink.emissions] == want


def test_emission_order_deterministic(tumble):
    """Windows emit ascending; rows within a window sort by key — the
    property the bit-identical replay rests on."""
    _, _, want = tumble
    docs = [json.loads(e) for e in want]
    starts = [d["window_start"] for d in docs]
    assert starts == sorted(starts)
    for d in docs:
        ks = [r[0] for r in d["rows"]]
        assert ks == sorted(ks)
    assert [d["seq"] for d in docs] == list(range(len(docs)))


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_gate_view_emissions_and_checkpoints_equal_the_reference(tmp_path, fuse):
    """The gate's view over its 5,000-event corpus, fused and eager: the
    emission JSON and the newest checkpoint's sections (meta, offsets,
    state) are the reference's, byte for byte."""
    from auron_tpu_torch.models import streamgate

    parts = streamgate._corpus(5000)
    c = _conf(poll=512, interval=2)
    c.set(STREAM_CALC_FUSE, fuse)
    sink = CollectSink()
    p = StreamPipeline(lower_streaming_view(streamgate.VIEW, SCHEMA), MockKafkaSource(parts),
                       JsonRowDeserializer(SCHEMA), sink, conf=c,
                       checkpoint_dir=str(tmp_path / "port"), device="cpu")
    p.run(drain=True)
    p.close()
    got = [e.to_json() for e in sink.emissions]
    want, (jseq, jsections) = _reference(streamgate.VIEW, parts, str(tmp_path / "ref"), poll=512,
                                         interval=2, fuse=fuse)
    assert got == want and len(got) == 16
    seq, sections = p.coordinator.latest()
    assert seq == jseq and sorted(sections) == ["meta", "offsets", "state"]
    for name in ("meta", "offsets", "state"):
        assert sections[name] == jsections[name], name
    assert streamgate.oracle_mismatch(got, streamgate.view_oracle(parts, 512)) is None
