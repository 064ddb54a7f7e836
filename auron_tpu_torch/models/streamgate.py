"""Streaming throughput and exactly-once gate (port of
``auron_tpu/models/streamgate.py``).

Four legs over one deterministic event corpus (seeded JSON records, two
partitions) and one calc-heavy CREATE STREAMING VIEW, on ``device``:

1. FUSED: the pipeline with ``stream.calc.fuse=on`` — on the card the Calc
   chain replays captured CUDA graphs. The best of ``STREAMGATE_REPS``
   timed runs is the ``fused_events_s`` figure; the emissions of the
   first timed run are the reference output.
2. EAGER: the same corpus with ``stream.calc.fuse=off`` (the unfused
   chain). Emissions must be bit-identical to leg 1, and fused events/s
   must beat eager by ``min_fused_speedup`` (``STREAMGATE_MIN_FUSED_SPEEDUP``,
   default 1.05x).
3. REPLAY STABILITY: the timed fused runs must add ZERO compiles
   (``utils/profiling.EngineCounters``: graph captures and kernel
   builds) — every graph key was met in the warm-up.
4. CRASH-RESUME: the fused pipeline again with checkpointing on,
   hard-stopped mid-run (a step cap landing between barriers), then
   resumed via ``StreamPipeline.restore``. The stitched emission log must
   be bit-identical to leg 1.

Legs 1 and 2 each take a warm-up run first (the fused one captures).
Each timed rep then runs both legs over the corpus at once, their steps
in turns of ``TURN_STEPS`` (eight fused steps, eight eager steps, ...;
``_paired_run``), and a leg's wall is the sum of its own steps and
drain: a host that slows down for a while slows both legs alike, so the
ratio reads the fusion's gain and not how busy the host was at the time,
and a turn is long enough that a leg's steps do not each start where the
other leg left the host's caches.

The gate FAILS on emission divergence in any leg, a fused speedup below
the floor, or any replay compile. The reference's ``PERF_RATCHET.json``
ratchet is left out: that file records the JAX package's CPU runs.

``view_oracle`` is the view computed from the corpus with numpy, which
the on-card check holds every emission against.

Run ``python -m auron_tpu_torch.models.streamgate`` on the card
(``STREAMGATE_DEVICE=cpu`` for the CPU; ``STREAMGATE_EVENTS``,
``STREAMGATE_REPS`` override the defaults).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from auron_tpu_torch import types as T
from auron_tpu_torch.utils.config import (
    STREAM_CALC_FUSE,
    STREAM_CHECKPOINT_INTERVAL,
    STREAM_POLL_MAX_RECORDS,
    Configuration,
)

SCHEMA = T.Schema.of(T.Field("k", T.STRING), T.Field("v", T.FLOAT64),
                     T.Field("ts", T.INT64))

#: calc-heavy on purpose: three WHERE conjuncts and arithmetic in every
#: aggregate argument, so the Calc chain carries real per-batch work for
#: the fused-vs-eager differential (a bare column passthrough measures
#: only json.loads)
VIEW = """
CREATE STREAMING VIEW streamgate_1s
  WATERMARK FOR ts AS ts - INTERVAL '2' SECOND
AS SELECT k, window_start, window_end,
          SUM(v * 2.0 + 1.0) AS total, COUNT(*) AS n,
          AVG(v * v) AS mean, MIN(v - 3.0) AS lo, MAX(v + 3.0) AS hi
   FROM events
   WHERE v >= 0 AND v < 9.5 AND ts >= 0
   GROUP BY k, TUMBLE(ts, INTERVAL '1' SECOND)
"""

#: the view's window and watermark delay (ms), for the oracle
WINDOW_MS = 1000
WATERMARK_DELAY_MS = 2000


def _corpus(n: int, seed: int = 7) -> list[list[bytes]]:
    rng = np.random.default_rng(seed)
    keys = np.array(list("abcdefgh"))[rng.integers(0, 8, n)]
    vals = np.round(rng.random(n) * 10 - 0.5, 3)
    ts = np.arange(n) * 3 + rng.integers(0, 5, n)
    recs = [json.dumps({"k": k, "v": float(v), "ts": int(t)}).encode()
            for k, v, t in zip(keys, vals, ts)]
    return [recs[: n // 2], recs[n // 2:]]


def _conf(fuse: bool, poll: int) -> Configuration:
    c = Configuration()
    c.set(STREAM_CALC_FUSE, "on" if fuse else "off")
    c.set(STREAM_POLL_MAX_RECORDS, poll)
    c.set(STREAM_CHECKPOINT_INTERVAL, 8)
    return c


def _run_once(plan, parts, conf, device, checkpoint_dir=None, max_steps=None):
    """One full (or capped) pipeline run: (events/s, emissions, steps)."""
    from auron_tpu_torch.exec.streaming import JsonRowDeserializer, MockKafkaSource
    from auron_tpu_torch.stream import CollectSink, StreamPipeline

    sink = CollectSink()
    p = StreamPipeline(plan, MockKafkaSource(parts), JsonRowDeserializer(SCHEMA), sink,
                       conf=conf, checkpoint_dir=checkpoint_dir, device=device)
    t0 = time.perf_counter()
    steps = p.run(max_steps=max_steps, drain=max_steps is None)
    wall = time.perf_counter() - t0
    events = p.metrics["events_in"]
    p.close()
    return events / wall if wall else 0.0, [e.to_json() for e in sink.emissions], steps


#: steps a leg takes in one turn of a timed rep (``_paired_run``)
TURN_STEPS = 8


def _paired_run(plan, parts, poll, device, counters, stats=None) -> dict:
    """One timed rep of legs 1 and 2: a fused and an eager pipeline over
    ``parts``, stepped in turns of ``TURN_STEPS`` until both are drained,
    each leg's wall summed over its own ``step`` and ``drain`` calls. Per
    leg ("fused", "eager"): events/s, emissions, steps and the
    ``counters``' compiles and host reads within its own calls. ``stats``
    (optional) gets the fused deserializer's ``columnar_polls`` and
    ``loop_polls``."""
    from auron_tpu_torch.exec.streaming import JsonRowDeserializer, MockKafkaSource
    from auron_tpu_torch.stream import CollectSink, StreamPipeline

    legs = {}
    for leg, fuse in (("fused", True), ("eager", False)):
        sink = CollectSink()
        p = StreamPipeline(plan, MockKafkaSource(parts), JsonRowDeserializer(SCHEMA), sink,
                           conf=_conf(fuse, poll), device=device)
        legs[leg] = {"p": p, "sink": sink, "wall": 0.0, "live": True, "compiles": 0,
                     "reads": 0}
    while any(r["live"] for r in legs.values()):
        for r in legs.values():
            if not r["live"]:
                continue
            c, h, a = counters.compiles, counters.syncs, counters.async_reads
            t0 = time.perf_counter()
            for _ in range(TURN_STEPS):
                r["live"] = r["p"].step()
                if not r["live"]:
                    r["p"].drain()
                    break
            r["wall"] += time.perf_counter() - t0
            r["compiles"] += counters.compiles - c
            r["reads"] += counters.syncs + counters.async_reads - h - a
    out = {}
    for leg, r in legs.items():
        p = r["p"]
        events, steps = p.metrics["events_in"], p.steps
        if leg == "fused" and stats is not None:
            de = p.calc.deserializer
            stats.update(columnar_polls=de.columnar_polls, loop_polls=de.loop_polls)
        p.close()
        out[leg] = {"events_s": events / r["wall"] if r["wall"] else 0.0,
                    "emissions": [e.to_json() for e in r["sink"].emissions], "steps": steps,
                    "compiles": r["compiles"], "reads": r["reads"]}
    return out


def run_gate(events: int | None = None, reps: int | None = None, poll: int = 512,
             min_fused_speedup: float | None = None, device: str = "cuda",
             emissions: list | None = None) -> dict:
    """The four-leg differential; returns the summary record. ``emissions``
    (optional) gets the reference output's JSON lines."""
    import tempfile

    import torch

    from auron_tpu_torch.device import resolve_device
    from auron_tpu_torch.exec.streaming import JsonRowDeserializer, MockKafkaSource
    from auron_tpu_torch.stream import CollectSink, StreamPipeline, lower_streaming_view
    from auron_tpu_torch.utils.profiling import EngineCounters

    device = str(resolve_device(device))
    on_card = device.startswith("cuda")
    counters = EngineCounters.install()
    events = events or int(os.environ.get("STREAMGATE_EVENTS", "60000"))
    reps = reps or int(os.environ.get("STREAMGATE_REPS", "3"))
    if min_fused_speedup is None:
        min_fused_speedup = float(os.environ.get("STREAMGATE_MIN_FUSED_SPEEDUP", "1.05"))
    parts = _corpus(events)
    plan = lower_streaming_view(VIEW, SCHEMA)
    failures: list[str] = []
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # ---- legs 1 and 2: a warm-up run of each (the fused one captures),
    # then the timed reps, both legs' steps in turns of TURN_STEPS; the
    # best rep of each leg is its figure
    fused_eps, eager_eps, reference, ingest = 0.0, 0.0, None, {}
    c0 = counters.compiles
    _, _, steps = _run_once(plan, parts, _conf(True, poll), device)
    compiles_warm = counters.compiles - c0
    _run_once(plan, parts, _conf(False, poll), device)
    replay_compiles = reads = 0
    eager_diverged = False
    for _ in range(reps):
        rep = _paired_run(plan, parts, poll, device, counters,
                          stats=ingest if reference is None else None)
        fused, eager = rep["fused"], rep["eager"]
        replay_compiles += fused["compiles"]
        reads += fused["reads"]
        fused_eps = max(fused_eps, fused["events_s"])
        eager_eps = max(eager_eps, eager["events_s"])
        if reference is None:
            reference = fused["emissions"]
        elif fused["emissions"] != reference:
            failures.append("fused reruns diverged (nondeterminism)")
        eager_diverged = eager_diverged or eager["emissions"] != reference
    if eager_diverged:
        failures.append("eager emissions diverged from fused")

    # ---- leg 3 folded in: the timed fused reps must not compile
    if replay_compiles:
        failures.append(f"fused replay added {replay_compiles} compiles "
                        "(graph captures or kernel builds: the stage cache failed)")
    speedup = fused_eps / eager_eps if eager_eps else 0.0
    if speedup < min_fused_speedup:
        failures.append(f"fused/eager events/s {speedup:.3f}x < required "
                        f"{min_fused_speedup:.2f}x")

    # ---- leg 4: crash-resume bit-identity at gate scale
    with tempfile.TemporaryDirectory() as ckdir:
        conf = _conf(True, poll)
        _, partial, capped = _run_once(plan, parts, conf, device, checkpoint_dir=ckdir,
                                       max_steps=max(3, (events // poll) // 2) + 1)
        sink = CollectSink()  # the crashed run's sink is gone; a fresh one
        p = StreamPipeline.restore(
            plan, lambda mode, off: MockKafkaSource(parts, startup_mode=mode,
                                                    start_offsets=off),
            JsonRowDeserializer(SCHEMA), sink, ckdir, conf=conf, device=device)
        committed = p.emit_seq
        p.run(drain=True)
        p.close()
        checkpoints = p.ckpt_seq
        resumed = partial[:committed] + [e.to_json() for e in sink.emissions]
        if resumed != reference:
            failures.append(f"crash-resume diverged after step cap {capped} "
                            f"(committed seq {committed})")

    if emissions is not None:
        emissions.extend(reference or ())
    return {
        "metric": "streamgate", "device": device, "events": events, "poll": poll,
        "reps": reps,
        "fused_events_s": round(fused_eps, 1),
        "eager_events_s": round(eager_eps, 1),
        "speedup": round(speedup, 3),
        "min_fused_speedup": min_fused_speedup,
        "steps": steps,
        "warm_compiles": compiles_warm,
        "replay_compiles": replay_compiles,
        "host_reads_per_step": round(reads / (reps * steps), 3) if steps else 0.0,
        "columnar_polls": ingest.get("columnar_polls"), "loop_polls": ingest.get("loop_polls"),
        "emissions": len(reference or ()),
        "checkpoints": checkpoints,
        "resumed_at_step": capped, "committed_seq": committed,
        "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None,
        "failures": failures,
        "ok": not failures,
    }


#: a second schema for the ingest checks: the INT32 and BOOL kinds too
INGEST_SCHEMA = T.Schema.of(T.Field("k", T.STRING), T.Field("v", T.FLOAT64),
                            T.Field("ts", T.INT64), T.Field("i", T.INT32),
                            T.Field("b", T.BOOL))
_GOOD = b'{"k":"a","v":1.5,"ts":3,"i":7,"b":true}'


def ingest_edge_polls() -> list[tuple[str, list[bytes]]]:
    """(name, poll) cases where a columnar JSON read could part from the
    record loop: each payload between two good records. The first three
    are the ones pyarrow's reader gets silently different (an integer past
    2^53 or the integer -0 in a double, two objects on one line beside a
    blank payload); the reader refuses most of the rest; the last few it
    reads as the loop does."""
    deep = b"[" * 5000 + b"]" * 5000
    cases = [
        ("int past 2^53 in a double", [b'{"k":"a","v":9007199254740993,"ts":1}',
                                       b'{"v":9223372036854775808}']),
        ("integer -0 in a double", [b'{"k":"a","v":-0,"ts":1}', b'{"v": -0 }']),
        ("blank payload, two objects on a line",
         [b"   ", b'{"k":"a","v":1.0,"ts":1}{"k":"b","v":2.0,"ts":2}']),
        ("two objects on a line, a tab payload", [b'{"ts":1}{"ts":2}', b"\t"]),
        ("two objects on a line", [b'{"k":"x","ts":1} {"k":"y","ts":2}']),
        ("int written 3.5", [b'{"ts":3.5}']),
        ("int written 1E5", [b'{"ts":1E5}']),
        ("int past int64", [b'{"ts":9223372036854775808}']),
        ("int past int32", [b'{"i":2147483648}', b'{"i":-2147483649}']),
        ("int32 written 1.0", [b'{"i":1.0}']),
        ("string for a double", [b'{"v":"1.5"}']),
        ("number for a string", [b'{"k":5}']),
        ("object for a string", [b'{"k":{"a":1}}']),
        ("true for a double", [b'{"v":true}']),
        ("number for a bool", [b'{"b":1}']),
        ("duplicate keys", [b'{"k":"a","k":"b"}', b'{"v":1.0,"v":2.0}']),
        ("1e400", [b'{"v":1e400}']),
        ("Inf, -Inf, -NaN", [b'{"v":Inf}', b'{"v":-Inf}', b'{"v":-NaN}']),
        ("Inf in an extra field", [b'{"x":Inf,"k":"a"}']),
        ("invalid UTF-8", [b'{"k":"\xff"}', b'{"x":"\xff","k":"a"}', b'{"k":"\xc0\x80"}']),
        ("encoded surrogate", [b'{"k":"\xed\xa0\x80"}']),
        ("lone surrogate escapes", [b'{"k":"\\ud800"}', b'{"x":"\\udc00","k":"a"}']),
        ("empty payload", [b""]),
        ("trailing garbage", [b'{"k":"a"}x', b'{"k":"a"} /* c */']),
        ("UTF-16 payload", ['{"k":"a","ts":1}'.encode("utf-16-le"),
                            '{"k":"b"}'.encode("utf-16")]),
        ("UTF-8 BOM", [b'\xef\xbb\xbf{"k":"a"}']),
        ("non-object records", [b"[1,2]", b"null", b'"s"', b"5"]),
        ("newline and CR inside", [b'{"k":\n"a"}', b'{"k":"a",\r"ts":2}']),
        ("control character in a string", [b'{"k":"a\tb"}']),
        ("nesting past the loop's recursion", [b'{"x":' + deep + b',"k":"a"}']),
        ("5000-digit int in an extra field", [b'{"x":' + b"1" * 5000 + b',"k":"a"}']),
        ("NULLs, missing and extra fields",
         [b'{"k":null,"v":null,"ts":null,"i":null,"b":null}', b"{}",
          b'{"x":[1,{"y":2}],"z":"q","k":"c"}']),
        ("NaN, -0.0, subnormals", [b'{"v":NaN}', b'{"v":-0.0}', b'{"v":5e-324}',
                                   b'{"v":-1e-400}', b'{"v":2.2250738585072011e-308}']),
        ("escapes and NUL", [b'{"k":"\\u00e9\\u0000\\n\\/"}', b'{"\\u006b":"e"}',
                             b'{"k":"\\ud83d\\ude00"}']),
        ("whitespace around", [b'  \t{"k":"a", "v" : 2 }\t ', b'{"k":"b"}   ']),
        ("ints, bools and big doubles", [b'{"ts":-9223372036854775808,"i":-2147483648,'
                                         b'"b":false,"v":9007199254740992}',
                                         b'{"v":1e300,"ts":-0}']),
    ]
    return [(name, [_GOOD, *poll, _GOOD]) for name, poll in cases]


def batch_bits(rb) -> list:
    """A RecordBatch as comparable Python values, doubles by bit pattern
    (so -0.0 and NaN payloads count): per column (type, values)."""
    import struct

    out = []
    for f, col in zip(rb.schema, rb.columns):
        vals = col.to_pylist()
        if str(f.type) == "double":
            vals = [None if x is None else struct.pack("<d", x) for x in vals]
        out.append((f.name, str(f.type), vals))
    return out


def deserialize_outcome(de, poll: list[bytes], loop: bool = False) -> dict:
    """What a deserializer makes of a poll: its rows (``batch_bits``) or
    what it raised, and its counters after. ``loop``: through the record
    loop alone (``_RowDeserializerBase.deserialize``)."""
    from auron_tpu_torch.exec.streaming import _RowDeserializerBase

    try:
        rb = _RowDeserializerBase.deserialize(de, poll) if loop else de.deserialize(poll)
        got = {"rows": batch_bits(rb)}
    except Exception as e:  # noqa: BLE001 — the raise is the outcome
        got = {"raised": f"{type(e).__name__}: {e}"}
    got.update(errors=de.errors, coerce_errors=de.coerce_errors)
    return got


def ingest_mismatches() -> tuple[list[str], dict]:
    """The port's JSON deserializer against its own record loop on every
    ``ingest_edge_polls`` case under each error policy (rows bit for bit,
    counters, raises), and on the gate's corpus: (what differs, the
    columnar and loop polls of the edge cases and of the corpus)."""
    from auron_tpu_torch.exec.streaming import JsonRowDeserializer

    bad: list[str] = []
    edge = JsonRowDeserializer(INGEST_SCHEMA)
    for name, poll in ingest_edge_polls():
        for policy in ("skip", "null", "fail"):
            de = JsonRowDeserializer(INGEST_SCHEMA, policy)
            got = deserialize_outcome(de, poll)
            want = deserialize_outcome(JsonRowDeserializer(INGEST_SCHEMA, policy), poll,
                                       loop=True)
            if got != want:
                bad.append(f"{name} ({policy})")
        deserialize_outcome(edge, poll)
    corpus = JsonRowDeserializer(SCHEMA)
    for part in _corpus(20_000):
        for i in range(0, len(part), 512):
            poll = part[i:i + 512]
            if batch_bits(corpus.deserialize(poll)) != \
                    deserialize_outcome(corpus, poll, loop=True)["rows"]:
                bad.append(f"gate corpus poll at {i}")
    return bad, {"edge_columnar_polls": edge.columnar_polls, "edge_loop_polls": edge.loop_polls,
                 "corpus_columnar_polls": corpus.columnar_polls,
                 "corpus_loop_polls": corpus.loop_polls}


def view_oracle(parts: list[list[bytes]], poll: int = 512) -> list[dict]:
    """The view over the corpus in numpy: per 1 s tumbling window (windows
    ascending) the rows of each key (keys ascending) over 0 <= v < 9.5 and
    ts >= 0, as ``{"window_start", "rows": [[k, start, end, total, n,
    mean, lo, hi], ...]}``. A window closes once the watermark (the
    largest ts read so far less 2 s) passes its end; the oracle first
    checks that no row of the corpus, read in polls of ``poll`` records,
    arrives after its window closed, so that each window is emitted
    exactly once and holds every one of its rows."""
    recs = [json.loads(r) for part in parts for r in part]
    k = np.array([r["k"] for r in recs])
    v = np.array([r["v"] for r in recs], dtype=np.float64)
    ts = np.array([r["ts"] for r in recs], dtype=np.int64)
    # the watermark a row meets: the running max of ts through the end of
    # the latest poll that can hold it
    seen = np.maximum.accumulate(ts)
    closed_before = seen[np.minimum(np.arange(len(ts)) + poll - 1, len(ts) - 1)] \
        - WATERMARK_DELAY_MS
    if np.any((ts // WINDOW_MS + 1) * WINDOW_MS <= closed_before):
        raise ValueError("a row arrives after its window closed: the oracle "
                         "assumes none does")
    keep = (v >= 0) & (v < 9.5) & (ts >= 0)
    k, v, ts = k[keep], v[keep], ts[keep]
    win = ts // WINDOW_MS * WINDOW_MS
    out = []
    for w in np.unique(win):
        rows = []
        for key in np.unique(k[win == w]):
            x = v[(win == w) & (k == key)]
            rows.append([str(key), int(w), int(w) + WINDOW_MS, float(np.sum(x * 2.0 + 1.0)),
                         int(len(x)), float(np.mean(x * x)), float(np.min(x - 3.0)),
                         float(np.max(x + 3.0))])
        out.append({"window_start": int(w), "rows": rows})
    return out


def oracle_mismatch(emissions: list[str], want: list[dict], rel: float = 1e-9) -> str | None:
    """None when the emission JSON lines are the oracle's windows in order
    (sequence numbers 0.., keys, bounds and counts exact, the float
    columns at ``rel``); else what differs."""
    if len(emissions) != len(want):
        return f"{len(emissions)} emissions, the oracle has {len(want)} windows"
    for seq, (line, w) in enumerate(zip(emissions, want)):
        e = json.loads(line)
        if e["seq"] != seq or e["window_start"] != w["window_start"] \
                or e["window_end"] != w["window_start"] + WINDOW_MS:
            return f"emission {seq}: seq or bounds differ"
        if len(e["rows"]) != len(w["rows"]):
            return f"emission {seq}: {len(e['rows'])} rows, the oracle has {len(w['rows'])}"
        for got, exp in zip(e["rows"], w["rows"]):
            if got[:3] != exp[:3] or got[4] != exp[4]:
                return f"emission {seq}: key, bounds or count differ: {got} vs {exp}"
            for g, x in zip(got[3:4] + got[5:], exp[3:4] + exp[5:]):
                if abs(g - x) > rel * abs(x):
                    return f"emission {seq}: {got} vs {exp} past rel {rel}"
    return None


def main() -> None:
    import sys

    rec = run_gate(device=os.environ.get("STREAMGATE_DEVICE", "cuda"))
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
