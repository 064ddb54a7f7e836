"""Streaming throughput and exactly-once gate (port of
``auron_tpu/models/streamgate.py``).

Four legs over one deterministic event corpus (seeded JSON records, two
partitions) and one calc-heavy CREATE STREAMING VIEW, on ``device``:

1. FUSED: the pipeline with ``stream.calc.fuse=on`` — on the card the Calc
   chain replays captured CUDA graphs. A warm-up run first, then the best
   of ``STREAMGATE_REPS`` timed runs is the ``fused_events_s`` figure; the
   emissions of the first timed run are the reference output.
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

    # ---- leg 1: fused (a warm-up run captures; the best timed rep is the figure)
    fused_eps, reference = 0.0, None
    c0 = counters.compiles
    _, _, steps = _run_once(plan, parts, _conf(True, poll), device)
    compiles_warm = counters.compiles - c0
    snap0 = counters.snapshot()
    for _ in range(reps):
        eps, ems, _ = _run_once(plan, parts, _conf(True, poll), device)
        fused_eps = max(fused_eps, eps)
        if reference is None:
            reference = ems
        elif ems != reference:
            failures.append("fused reruns diverged (nondeterminism)")
    snap1 = counters.snapshot()

    # ---- leg 3 folded in: the timed fused reps must not compile
    replay_compiles = snap1["compiles"] - snap0["compiles"]
    if replay_compiles:
        failures.append(f"fused replay added {replay_compiles} compiles "
                        "(graph captures or kernel builds: the stage cache failed)")
    reads = (snap1["host_syncs"] + snap1["async_reads"]
             - snap0["host_syncs"] - snap0["async_reads"])

    # ---- leg 2: eager differential
    eager_eps = 0.0
    for _ in range(reps):
        eps, ems, _ = _run_once(plan, parts, _conf(False, poll), device)
        eager_eps = max(eager_eps, eps)
        if ems != reference:
            failures.append("eager emissions diverged from fused")
            break
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
        "emissions": len(reference or ()),
        "checkpoints": checkpoints,
        "resumed_at_step": capped, "committed_seq": committed,
        "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None,
        "failures": failures,
        "ok": not failures,
    }


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
