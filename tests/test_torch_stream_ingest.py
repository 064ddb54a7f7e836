"""The port's stream ingest against the JAX package, on the CPU.

- ``JsonRowDeserializer`` reads a poll in one columnar parse
  (``pyarrow.json``) only where that equals the record loop, and through
  the record loop otherwise. Each case of ``streamgate.ingest_edge_polls``
  (the three inputs pyarrow's reader reads silently differently among
  them), under each error policy, gives the reference's
  ``auron_tpu.exec.streaming.JsonRowDeserializer`` rows bit for bit
  (doubles by bit pattern), ``errors``, ``coerce_errors`` and raise; so do
  hypothesis polls that mix good and bad records. The columnar read is
  taken on the gate's corpus and on no guarded case.
- The pipeline's host read (``_host_columns``: host planes, strings by
  code) and its upload (``upload_batch``) leave the emissions and every
  checkpoint's bytes what the parent's path (``Batch.to_arrow`` and
  ``_host_column``, ``Batch.from_arrow``, the record loop) gives, fused
  and eager; ``WindowStore.update`` sorting on string codes keeps the
  state bytes.
- ``streamgate.run_gate`` warms each leg once, then times the fused and
  eager runs in turns.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from auron_tpu import types as JT
from auron_tpu.exec import streaming as JS
from auron_tpu_torch import types as T
from auron_tpu_torch.exec import streaming as S
from auron_tpu_torch.models import streamgate

JINGEST_SCHEMA = JT.Schema.of(JT.Field("k", JT.STRING), JT.Field("v", JT.FLOAT64),
                              JT.Field("ts", JT.INT64), JT.Field("i", JT.INT32),
                              JT.Field("b", JT.BOOL))
JSCHEMA = JT.Schema.of(JT.Field("k", JT.STRING), JT.Field("v", JT.FLOAT64),
                       JT.Field("ts", JT.INT64))
POLICIES = ("skip", "null", "fail")
EDGE = streamgate.ingest_edge_polls()
#: the edge cases the columnar read takes (it reads them as the loop does)
COLUMNAR_CASES = {"NULLs, missing and extra fields", "whitespace around"}


def _reference_outcome(schema, poll, policy) -> dict:
    """``streamgate.deserialize_outcome`` of the reference's deserializer."""
    de = JS.JsonRowDeserializer(schema, policy)
    try:
        got = {"rows": streamgate.batch_bits(de.deserialize(poll))}
    except Exception as e:  # noqa: BLE001 — the raise is the outcome
        got = {"raised": f"{type(e).__name__}: {e}"}
    got.update(errors=de.errors, coerce_errors=de.coerce_errors)
    return got


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", range(len(EDGE)), ids=[name for name, _ in EDGE])
def test_edge_case_equals_the_reference(case, policy):
    name, poll = EDGE[case]
    de = S.JsonRowDeserializer(streamgate.INGEST_SCHEMA, policy)
    got = streamgate.deserialize_outcome(de, poll)
    assert got == _reference_outcome(JINGEST_SCHEMA, poll, policy), name
    assert de.columnar_polls + de.loop_polls == 1


def test_the_three_silent_cases_take_the_loop():
    """The inputs pyarrow's reader reads without a word but differently:
    the loop's NULLs and coerce errors, 0.0, and its errors stand."""
    want = {"int past 2^53 in a double": (0, 2), "integer -0 in a double": (0, 0),
            "blank payload, two objects on a line": (2, 0)}
    for name, poll in EDGE:
        if name in want:
            de = S.JsonRowDeserializer(streamgate.INGEST_SCHEMA)
            rb = de.deserialize(poll)
            assert (de.columnar_polls, de.loop_polls) == (0, 1), name
            assert (de.errors, de.coerce_errors) == want[name], name
            if name == "integer -0 in a double":
                v = np.asarray(rb.column("v").fill_null(1.0))
                assert not np.signbit(v).any()  # the loop's 0.0, not -0.0
            if name == "int past 2^53 in a double":
                assert rb.column("v").to_pylist() == [1.5, None, None, 1.5]


@pytest.mark.parametrize("case", range(len(EDGE)), ids=[name for name, _ in EDGE])
def test_columnar_read_taken_only_where_equal(case):
    name, poll = EDGE[case]
    de = S.JsonRowDeserializer(streamgate.INGEST_SCHEMA)
    streamgate.deserialize_outcome(de, poll)
    assert de.columnar_polls == (name in COLUMNAR_CASES), name


def test_gate_corpus_takes_the_columnar_read():
    parts = streamgate._corpus(20_000)
    de = S.JsonRowDeserializer(streamgate.SCHEMA)
    ref = JS.JsonRowDeserializer(JSCHEMA)
    polls = 0
    for part in parts:
        for i in range(0, len(part), 512):
            poll = part[i:i + 512]
            got = streamgate.batch_bits(de.deserialize(poll))
            assert got == streamgate.batch_bits(ref.deserialize(poll))
            polls += 1
    assert (de.columnar_polls, de.loop_polls, de.errors, de.coerce_errors) == (polls, 0, 0, 0)


def test_ingest_self_check_is_clean():
    bad, counts = streamgate.ingest_mismatches()
    assert bad == []
    assert counts["corpus_loop_polls"] == 0 and counts["corpus_columnar_polls"] == 40
    assert counts["edge_columnar_polls"] == len(COLUMNAR_CASES)


def test_other_kinds_take_the_loop():
    """A schema with a kind outside STRING, INT32/64, FLOAT64 and BOOL
    (FLOAT32: its double rounding can differ) always takes the loop."""
    schema = T.Schema.of(T.Field("k", T.STRING), T.Field("f", T.FLOAT32))
    de = S.JsonRowDeserializer(schema)
    rb = de.deserialize([b'{"k":"a","f":0.1}', b'{"k":"b","f":16777217}'])
    ref = JS.JsonRowDeserializer(JT.Schema.of(JT.Field("k", JT.STRING),
                                              JT.Field("f", JT.FLOAT32)))
    assert streamgate.batch_bits(rb) == streamgate.batch_bits(
        ref.deserialize([b'{"k":"a","f":0.1}', b'{"k":"b","f":16777217}']))
    assert (de.columnar_polls, de.loop_polls) == (0, 1)


# ---- hypothesis: good and bad records mixed in one poll --------------------

_BAD = [p for _, poll in EDGE for p in poll[1:-1]]
_KEYS = st.text(alphabet=st.characters(codec="utf-8", exclude_categories=("Cs",)),
                max_size=6)
_DOUBLES = st.one_of(
    st.floats(allow_nan=False, allow_infinity=False).map(repr),
    st.floats(allow_nan=False, allow_infinity=False, width=32).map(lambda x: f"{x:.17e}"),
    st.integers(-(1 << 60), 1 << 60).map(str),
    st.sampled_from(["-0", "0", "-0.0", "1e-400", "5e-324", "1E3", "9007199254740992"]))
_INTS = st.one_of(st.integers(-(1 << 63), (1 << 63) - 1), st.integers(-10, 10)).map(str)


@st.composite
def _good_record(draw) -> bytes:
    fields = []
    if draw(st.booleans()):
        fields.append(("k", json.dumps(draw(_KEYS), ensure_ascii=draw(st.booleans()))))
    if draw(st.booleans()):
        fields.append(("v", draw(st.one_of(_DOUBLES, st.just("null")))))
    if draw(st.booleans()):
        fields.append(("ts", draw(_INTS)))
    if draw(st.booleans()):
        fields.append(("i", str(draw(st.integers(-(1 << 31), (1 << 31) - 1)))))
    if draw(st.booleans()):
        fields.append(("b", draw(st.sampled_from(["true", "false", "null"]))))
    if draw(st.booleans()):
        fields.append(("extra", json.dumps(draw(st.lists(st.integers(), max_size=3)))))
    fields = draw(st.permutations(fields))
    sep = draw(st.sampled_from([",", ", ", " ,\t"]))
    body = sep.join(f'"{n}":{v}' for n, v in fields)
    return (draw(st.sampled_from(["", " ", "\t "])) + "{" + body + "}").encode()


@settings(max_examples=120, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.one_of(_good_record(), _good_record(), st.sampled_from(_BAD)),
                min_size=1, max_size=24),
       st.sampled_from(POLICIES))
def test_mixed_polls_equal_the_reference(poll, policy):
    de = S.JsonRowDeserializer(streamgate.INGEST_SCHEMA, policy)
    assert streamgate.deserialize_outcome(de, poll) == \
        _reference_outcome(JINGEST_SCHEMA, poll, policy)


@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(_good_record(), min_size=1, max_size=24))
def test_good_polls_read_columnar_or_equal(poll):
    """Polls of good records alone: equal to the loop, and read columnar
    unless a guard (a -0, 2^53 or more in a double, an escape of a
    surrogate, ...) sent them to the loop."""
    de = S.JsonRowDeserializer(streamgate.INGEST_SCHEMA)
    got = streamgate.deserialize_outcome(de, poll)
    assert got == _reference_outcome(JINGEST_SCHEMA, poll, "skip")
    assert de.columnar_polls + de.loop_polls == 1


# ---- the host read, the upload and the window store ------------------------


def _parent_path(monkeypatch):
    """The pipeline as the parent ran it: the record loop, ``Batch.from_arrow``
    and ``Batch.to_arrow`` read through ``_host_column``."""
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.stream import pipeline as P

    def host_columns(out, metrics):
        rb = out.to_arrow(metrics)
        return [P._host_column(c) for c in rb.columns], [None] * rb.num_columns

    monkeypatch.setattr(P, "_host_columns", host_columns)
    monkeypatch.setattr(P, "upload_batch", lambda rb, device, conf=None:
                        Batch.from_arrow(rb, device=device, conf=conf))
    monkeypatch.setattr(S.JsonRowDeserializer, "deserialize",
                        S._RowDeserializerBase.deserialize)


def _run_recording(parts, fuse: str, ckdir: str, view: str = streamgate.VIEW,
                   schema: T.Schema = streamgate.SCHEMA, poll: int = 512):
    from auron_tpu_torch.stream import CollectSink, StreamPipeline, lower_streaming_view
    from auron_tpu_torch.utils.config import STREAM_CALC_FUSE

    conf = streamgate._conf(fuse == "on", poll)
    conf.set(STREAM_CALC_FUSE, fuse)
    sink = CollectSink()
    p = StreamPipeline(lower_streaming_view(view, schema), S.MockKafkaSource(parts),
                       S.JsonRowDeserializer(schema), sink, conf=conf, checkpoint_dir=ckdir,
                       device="cpu")
    written = []
    write = p.coordinator.write
    p.coordinator.write = lambda seq, sections: (written.append((seq, dict(sections))),
                                                 write(seq, sections))[1]
    p.run(drain=True)
    p.close()
    return [e.to_json() for e in sink.emissions], written, p.metrics


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_pipeline_equals_the_parent_path(tmp_path, monkeypatch, fuse):
    parts = streamgate._corpus(6000)
    got, ckpts, metrics = _run_recording(parts, fuse, str(tmp_path / "new"))
    _parent_path(monkeypatch)
    want, want_ckpts, want_metrics = _run_recording(parts, fuse, str(tmp_path / "old"))
    assert got == want and len(got) == 18
    assert ckpts == want_ckpts and len(ckpts) == 1
    assert metrics == want_metrics
    assert streamgate.oracle_mismatch(got, streamgate.view_oracle(parts, 512)) is None


_NULL_VIEW = """
CREATE STREAMING VIEW keyed_1s
  WATERMARK FOR ts AS ts - INTERVAL '1' SECOND
AS SELECT k, window_start, SUM(v) AS total, COUNT(*) AS n, MIN(v) AS lo
   FROM events
   GROUP BY k, TUMBLE(ts, INTERVAL '1' SECOND)
"""


def _keyed_parts(n: int = 3000) -> list[list[bytes]]:
    """NULL keys, "" keys, NULL values and non-ASCII keys among the rows."""
    rng = np.random.default_rng(11)
    keys = ["a", "", None, "é", "b", "\u0000"]
    recs = []
    for i in range(n):
        row = {"ts": i * 7}
        k = keys[int(rng.integers(0, len(keys)))]
        if k is not None or rng.random() < 0.5:
            row["k"] = k
        if rng.random() < 0.9:
            row["v"] = float(np.round(rng.random() * 4 - 2, 2))
        recs.append(json.dumps(row, ensure_ascii=bool(rng.random() < 0.5)).encode())
    return [recs[: n // 2], recs[n // 2:]]


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_null_and_empty_keys_equal_the_parent_path(tmp_path, monkeypatch, fuse):
    parts = _keyed_parts()
    got, ckpts, _ = _run_recording(parts, fuse, str(tmp_path / "new"), _NULL_VIEW, poll=128)
    _parent_path(monkeypatch)
    want, want_ckpts, _ = _run_recording(parts, fuse, str(tmp_path / "old"), _NULL_VIEW,
                                         poll=128)
    assert got == want and len(got) == 21
    assert ckpts == want_ckpts and len(ckpts) == 3


def test_host_columns_codes_partition_like_the_strings():
    import pyarrow as pa

    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.stream.pipeline import _host_column, _host_columns

    k = ["b", "", None, "a", "b", None, "", "é"]
    rb = pa.record_batch([pa.array(k, pa.string()),
                          pa.array([1.0, None, -0.0, 2.5, None, 3.0, 4.0, 5.0]),
                          pa.array([1, 2, None, 4, 5, 6, 7, 8], pa.int64()),
                          pa.array([1, None, -3, 4, 5, None, 7, 8], pa.int32())],
                         names=["k", "v", "ts", "i"])
    b = Batch.from_arrow(rb, device="cpu")
    cols, codes = _host_columns(b, None)
    old = [_host_column(c) for c in b.to_arrow().columns]
    for (v, m), (ov, om) in zip(cols, old):
        assert v.dtype == ov.dtype and np.array_equal(m, om)
        if v.dtype.kind == "f":
            assert np.array_equal(v.view(np.uint64), ov.view(np.uint64))
        else:
            assert v.tolist() == ov.tolist()
    strings = cols[0][0].tolist()
    assert codes[1:] == [None, None, None]
    c = codes[0].tolist()
    assert all((c[x] == c[y]) == (strings[x] == strings[y])
               for x in range(len(k)) for y in range(len(k)))
    repeats = np.array(["x", "x", "y", "z"], dtype=object)
    dup = b.with_device(b.device, dicts=(repeats,) + b.dicts[1:])
    assert _host_columns(dup, None)[1][0] is None  # a vocabulary with repeats: no codes


def test_window_store_group_keys_keep_the_state():
    from auron_tpu_torch.stream.state import WindowStore

    rng = np.random.default_rng(3)
    funcs = ["sum", "count_star", "avg", "min", "max", "count"]
    plain, coded = WindowStore(funcs), WindowStore(funcs)
    vocab = np.array(["q", "", "zz", "é"], dtype=object)
    for _ in range(6):
        n = 300
        codes = rng.integers(0, len(vocab), n)
        wins = rng.integers(0, 4, n).astype(np.int64) * 1000
        keys = [vocab[codes], rng.integers(0, 3, n)]
        vals = []
        for f in funcs:
            if f == "count_star":
                vals.append(None)
                continue
            v = rng.standard_normal(n) * 1e6
            v[rng.random(n) < 0.05] = np.nan
            vals.append((v, rng.random(n) < 0.8))
        a = plain.update(wins, keys, vals)
        b = coded.update(wins, keys, vals, [codes, keys[1]])
        assert a == b
        assert plain.snapshot() == coded.snapshot()
    assert repr(plain.emit_closed(10 ** 9, 1000)) == repr(coded.emit_closed(10 ** 9, 1000))


def test_stream_gate_steps_its_legs_in_turns_on_the_cpu(monkeypatch):
    """``streamgate.run_gate`` on the CPU at a small size: a warm-up run of
    each leg, then each timed rep steps a fused and an eager pipeline in
    turns of ``TURN_STEPS`` steps (two here, so a run takes several), then
    the crash-resume leg; every poll of a timed fused run read columnar,
    no capture, and the emissions equal to the numpy oracle of the
    view."""
    from auron_tpu_torch.stream import StreamPipeline

    monkeypatch.setattr(streamgate, "TURN_STEPS", 2)
    order = []
    step = StreamPipeline.step

    def spy(self):
        order.append("f" if self.conf.get(streamgate.STREAM_CALC_FUSE) == "on" else "e")
        return step(self)

    monkeypatch.setattr(StreamPipeline, "step", spy)
    ems: list = []
    rec = streamgate.run_gate(events=3000, reps=2, poll=512, min_fused_speedup=0.0,
                              device="cpu", emissions=ems)
    assert rec["ok"], rec["failures"]
    n = rec["steps"] + 1  # a run's steps and the call that finds the source exhausted
    warm, timed = "".join(order[:2 * n]), "".join(order[2 * n:6 * n])
    assert warm == "f" * n + "e" * n
    turns = "".join("ff"[:min(2, n - i)] + "ee"[:min(2, n - i)] for i in range(0, n, 2))
    assert n > 4 and timed == turns * 2  # two reps, each two fused and two eager steps in turns
    assert set(order[6 * n:]) == {"f"}  # the crash-resume leg is fused
    assert rec["replay_compiles"] == 0 and rec["loop_polls"] == 0
    assert rec["columnar_polls"] == rec["steps"] > 0
    assert streamgate.oracle_mismatch(
        ems, streamgate.view_oracle(streamgate._corpus(3000), 512)) is None
