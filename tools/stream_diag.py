#!/usr/bin/env python3
"""The stream gate's step on the card, taken apart.

    python3 tools/stream_diag.py [--root CHECKOUT] [--tag T]
        [--events 60000,1000000] [--reps 3] [--poll 512] [--no-gate]
        [--gate-runs 1] [--profile] [--exchange-events N] [--exchange-users U]
        [--device cuda]

For each ``--events`` count, over ``streamgate._corpus`` and the gate's
view: one warm-up and ``--reps`` timed runs of the pipeline under each
fuse setting (fused: ``stream.calc.fuse=on``; eager: ``off``), with the
pipeline's calls wrapped from outside (no timer is added to the program):

- ``poll`` (the source), ``deserialize`` (the record deserializer),
  ``upload`` (the micro-batch's ingest, ``Batch.from_arrow``),
  ``calc`` (the Calc chain: host clock, and on the card CUDA events),
  ``host_read`` (the chain output's read back to host planes),
  ``update`` (``WindowStore.update``), ``fold_rest`` (the rest of
  ``_fold``: window assignment, the watermark), ``emit``
  (``_emit_closed``) and ``rest`` (the step less all of these); inside
  them ``upload.import``, ``upload.from_host_arrow``, ``upload.host_plane``,
  ``upload.to_device``, ``upload.dictionary_encode`` (the host Arrow
  batch from pyarrow's, the ingest, its host planes, its staging copy,
  pyarrow's string encoding), ``calc.replay`` (a CUDA graph's replay, its
  input copies and output clones included), ``host_read.planes`` and
  ``host_read.harvest`` (the live planes on the host; the wait for their
  copy);
- the garbage collector's passes and seconds inside the timed runs;
- step time over the first and the last tenth of the steps.

The fastest timed run of each leg is reported. Then (unless
``--no-gate``; ``--gate-runs`` times) ``streamgate.run_gate`` at its
defaults but the floor (0.0 here: the ratio is printed, not held),
unwrapped: fused and eager events/s as the gate takes them.
``--profile``: at the first size, one fused and one eager run under
torch.profiler (device busy as the union of device events, the idle
share). ``--exchange-events``: the planned ``kafka_scan`` exchange
(``models/kafka_exchange.run``) at that size after a warm-up, its wall
and ``deserialize_s``.

``--root`` imports the ``auron_tpu_torch`` of another checkout (a parent
commit unpacked beside this one), so two trees can be measured in turns
within one call. Prints one JSON line (also written to
``chiprun_out/stream_diag[-<tag>].json``). Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

PARTS = ("poll", "deserialize", "upload", "calc", "host_read", "update", "fold_rest", "emit",
         "rest")


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


class _Clock:
    """Per-step seconds by part, from wrappers around the pipeline's calls.
    A part's wrapper counts only its outermost call (a wrapped call inside
    another of the same part is not counted twice)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.steps: list[dict] = []
        self.cur: dict = {}
        self.depth: dict = {}
        self.events: list = []

    def timed(self, part: str, fn):
        def wrapper(*a, **k):
            if self.depth.get(part):
                return fn(*a, **k)
            self.depth[part] = 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.cur[part] = self.cur.get(part, 0.0) + time.perf_counter() - t0
                self.depth[part] = 0
        return wrapper

    def chain(self, execute):
        """The Calc chain's generator, consumed inside the clock (one output
        a micro-batch), with CUDA events around it on the card."""
        import torch

        def wrapper(*a, **k):
            e0 = e1 = None
            if self.cuda:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
            t0 = time.perf_counter()
            outs = list(execute(*a, **k))
            self.cur["calc"] = self.cur.get("calc", 0.0) + time.perf_counter() - t0
            if e1 is not None:
                e1.record()
                self.events.append((e0, e1))
            return iter(outs)
        return wrapper

    def step(self, fn):
        def wrapper(*a, **k):
            self.cur = {}
            t0 = time.perf_counter()
            more = fn(*a, **k)
            total = time.perf_counter() - t0
            if more:
                self.cur["step"] = total
                self.steps.append(self.cur)
            return more
        return wrapper

    def calc_device_ms(self) -> float | None:
        if not self.cuda:
            return None
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def _patch(owner, name: str, wrap) -> tuple | None:
    """Replace ``owner.name`` by ``wrap(old)``; the undo record, or None
    when the attribute does not exist in this tree."""
    old = owner.__dict__.get(name) if isinstance(owner, type) else getattr(owner, name, None)
    if old is None:
        return None
    if isinstance(old, staticmethod):
        setattr(owner, name, staticmethod(wrap(old.__func__)))
    else:
        setattr(owner, name, wrap(old))
    return owner, name, old


def _gc_clock():
    """(callback, totals): the collector's passes and seconds."""
    totals = {"passes": 0, "s": 0.0, "gen2": 0}
    t = [0.0]

    def cb(phase, info):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            totals["passes"] += 1
            totals["s"] += time.perf_counter() - t[0]
            totals["gen2"] += info.get("generation") == 2
    return cb, totals


def _instrumented_run(plan, parts, conf, device: str) -> dict:
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exec.streaming import JsonRowDeserializer, MockKafkaSource
    from auron_tpu_torch.models import streamgate
    from auron_tpu_torch.stream import CollectSink, StreamPipeline
    from auron_tpu_torch.stream import pipeline as pipeline_mod

    from auron_tpu_torch.columnar import arrow_c
    from auron_tpu_torch.columnar import batch as batch_mod
    from auron_tpu_torch.plan import fusion
    from auron_tpu_torch.runtime import transfer
    from auron_tpu_torch.utils.arrowlib import pyarrow

    pyarrow()
    import pyarrow.compute as pc

    clock = _Clock(device.startswith("cuda"))
    sink = CollectSink()
    p = StreamPipeline(plan, MockKafkaSource(parts), JsonRowDeserializer(streamgate.SCHEMA), sink,
                       conf=conf, device=device)
    undo = [u for u in (
        _patch(p.source, "poll", lambda f: clock.timed("poll", f)),
        _patch(p.calc.deserializer, "deserialize", lambda f: clock.timed("deserialize", f)),
        _patch(pipeline_mod, "upload_batch", lambda f: clock.timed("upload", f)),
        _patch(Batch, "from_arrow", lambda f: clock.timed("upload", f)),
        _patch(p._chain, "execute", clock.chain),
        _patch(pipeline_mod, "_host_columns", lambda f: clock.timed("host_read", f)),
        _patch(Batch, "to_arrow", lambda f: clock.timed("host_read", f)),
        _patch(pipeline_mod, "_host_column", lambda f: clock.timed("host_read", f)),
        _patch(p.store, "update", lambda f: clock.timed("update", f)),
        _patch(p, "_fold", lambda f: clock.timed("fold", f)),
        _patch(p, "_emit_closed", lambda f: clock.timed("emit", f)),
        _patch(p, "step", clock.step),
        # inside the parts above: where an upload and a replay spend
        _patch(arrow_c, "import_from", lambda f: clock.timed("upload.import", f)),
        _patch(batch_mod, "host_plane", lambda f: clock.timed("upload.host_plane", f)),
        _patch(batch_mod, "_to_device", lambda f: clock.timed("upload.to_device", f)),
        _patch(batch_mod, "_to_device_packed", lambda f: clock.timed("upload.to_device", f)),
        _patch(fusion._Graph, "replay", lambda f: clock.timed("calc.replay", f)),
        _patch(Batch, "from_host_arrow", lambda f: clock.timed("upload.from_host_arrow", f)),
        _patch(pc, "dictionary_encode", lambda f: clock.timed("upload.dictionary_encode", f)),
        _patch(Batch, "live_host_planes", lambda f: clock.timed("host_read.planes", f)),
        _patch(transfer, "harvest", lambda f: clock.timed("host_read.harvest", f)),
    ) if u is not None]
    cb, gcs = _gc_clock()
    gc.callbacks.append(cb)
    try:
        t0 = time.perf_counter()
        p.run(drain=True)
        if clock.cuda:
            import torch

            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(cb)
        for owner, name, old in reversed(undo):
            if isinstance(owner, type) or owner in (pipeline_mod, batch_mod, arrow_c, pc,
                                                     transfer):
                setattr(owner, name, old)
            else:
                delattr(owner, name)
    p.close()
    steps = clock.steps
    n = len(steps)
    tot = {k: sum(s.get(k, 0.0) for s in steps) for k in ("step", "poll", "deserialize",
           "upload", "calc", "host_read", "update", "fold", "emit")}
    tot["fold_rest"] = tot["fold"] - tot["host_read"] - tot["update"]
    tot["rest"] = tot["step"] - sum(tot[k] for k in ("poll", "deserialize", "upload", "calc",
                                                     "fold", "emit"))
    per = {k: round(tot[k] / n * 1e3, 4) for k in ("step",) + PARTS} if n else {}
    detail = sorted({k for s in steps for k in s if "." in k})
    per_detail = {k: round(sum(s.get(k, 0.0) for s in steps) / n * 1e3, 4)
                  for k in detail} if n else {}
    dev = clock.calc_device_ms()
    tenth = max(1, n // 10)
    de = p.calc.deserializer
    return {
        "steps": n, "events": p.metrics["events_in"], "wall_s": round(wall, 4),
        "events_s": round(p.metrics["events_in"] / wall, 1),
        "ms_per_step": per,
        "detail_ms_per_step": per_detail,
        "calc_device_ms_per_step": round(dev / n, 4) if dev is not None and n else None,
        "step_ms_first_tenth": round(sum(s["step"] for s in steps[:tenth]) / tenth * 1e3, 4),
        "step_ms_last_tenth": round(sum(s["step"] for s in steps[-tenth:]) / tenth * 1e3, 4),
        "gc": {"passes": gcs["passes"], "gen2": gcs["gen2"], "ms": round(gcs["s"] * 1e3, 3)},
        "columnar_polls": getattr(de, "columnar_polls", None),
        "loop_polls": getattr(de, "loop_polls", None),
        "emissions": len(sink.emissions),
    }


def breakdown(events: int, reps: int, poll: int, device: str) -> dict:
    """Per leg (fused, eager) the fastest of ``reps`` wrapped runs after a
    warm-up (``_instrumented_run``), with every run's wall."""
    from auron_tpu_torch.models import streamgate
    from auron_tpu_torch.stream import lower_streaming_view

    parts = streamgate._corpus(events)
    plan = lower_streaming_view(streamgate.VIEW, streamgate.SCHEMA)
    out = {}
    for leg, fuse in (("fused", True), ("eager", False)):
        streamgate._run_once(plan, parts, streamgate._conf(fuse, poll), device)  # warm-up
        runs = [_instrumented_run(plan, parts, streamgate._conf(fuse, poll), device)
                for _ in range(reps)]
        best = min(runs, key=lambda r: r["wall_s"])
        best["walls_s"] = [r["wall_s"] for r in runs]
        out[leg] = best
    return out


def _profiled(events: int, poll: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from auron_tpu_torch.models import servegate, streamgate
    from auron_tpu_torch.stream import lower_streaming_view

    parts = streamgate._corpus(events)
    plan = lower_streaming_view(streamgate.VIEW, streamgate.SCHEMA)
    out = {}
    for leg, fuse in (("fused", True), ("eager", False)):
        conf = streamgate._conf(fuse, poll)
        streamgate._run_once(plan, parts, conf, "cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            streamgate._run_once(plan, parts, conf, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = servegate.union_busy_ms(prof)
        out[leg] = {"wall_ms": round(wall * 1e3, 3), "device_busy_ms": round(busy, 3),
                    "device_idle_share": round(max(0.0, 1 - busy / (wall * 1e3)), 4)}
    return out


def _exchange(events: int, users: int, device: str) -> dict:
    from auron_tpu_torch.models import kafka_exchange as KX

    parts = KX.corpus(events, users)
    KX.run(parts, 4, device=device)  # warm-up: builds, captures
    st: dict = {}
    t0 = time.perf_counter()
    outs = KX.run(parts, 4, device=device, stats=st)
    wall = time.perf_counter() - t0
    err = KX.mismatch(outs, KX.oracle(parts))
    return {"events": events, "wall_s": round(wall, 4), "run_wall_s": st.get("wall_s"),
            "deserialize_s": st.get("deserialize_s"), "map_s": st.get("map_s"),
            "reduce_s": st.get("reduce_s"), "micro_batches": st.get("stream_batches"),
            "mismatch": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout whose auron_tpu_torch to import")
    ap.add_argument("--tag", default="", help="suffix of the JSON file's name")
    ap.add_argument("--events", default="60000,1000000", help="comma-separated gate sizes")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--poll", type=int, default=512)
    ap.add_argument("--no-gate", action="store_true", help="leave out the unwrapped gate run")
    ap.add_argument("--gate-runs", type=int, default=1, help="unwrapped gate runs a size")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--exchange-events", type=int, default=0)
    ap.add_argument("--exchange-users", type=int, default=200_000)
    ap.add_argument("--device", default="cuda", help="cpu for a rehearsal at a small --events")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..")))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("stream_diag: no CUDA device", file=sys.stderr)
        return 2
    import auron_tpu_torch
    from auron_tpu_torch.models import streamgate

    card = _card() if args.device == "cuda" else "cpu (rehearsal)"
    print(f"card: {card}; auron_tpu_torch from {os.path.dirname(auron_tpu_torch.__file__)}",
          flush=True)
    out: dict = {"card": card, "poll": args.poll, "reps": args.reps, "sizes": []}
    ok = True
    for events in (int(e) for e in args.events.split(",") if e):
        rec: dict = {"events": events, "breakdown": breakdown(events, args.reps, args.poll,
                                                               args.device)}
        for leg, r in rec["breakdown"].items():
            print(f"{events:,} events, {leg}: {json.dumps(r)}", flush=True)
        for i in range(0 if args.no_gate else args.gate_runs):
            g = streamgate.run_gate(events=events, reps=args.reps, poll=args.poll,
                                    min_fused_speedup=0.0, device=args.device)
            ok = ok and g["ok"]
            rec["gate" if i == 0 else f"gate{i}"] = gate = {
                k: g[k] for k in ("fused_events_s", "eager_events_s", "speedup",
                                  "replay_compiles", "host_reads_per_step", "failures", "ok")}
            print(f"{events:,} events, gate: {json.dumps(gate)}", flush=True)
        if args.profile and args.device == "cuda" and not out["sizes"]:
            rec["profile"] = _profiled(events, args.poll)
            print(f"{events:,} events, profile: {json.dumps(rec['profile'])}", flush=True)
        out["sizes"].append(rec)
    if args.exchange_events:
        out["exchange"] = _exchange(args.exchange_events, args.exchange_users, args.device)
        ok = ok and out["exchange"]["mismatch"] is None
        print(f"exchange: {json.dumps(out['exchange'])}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    name = f"stream_diag{'-' + args.tag if args.tag else ''}.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({"card": card, "speedups": [s.get("gate", {}).get("speedup")
                                                 for s in out["sizes"]], "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
