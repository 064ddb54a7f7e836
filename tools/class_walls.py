#!/usr/bin/env python3
"""Walls of TPC-DS classes of a checkout's ``auron_tpu_torch`` on the card.

    python3 tools/class_walls.py [--root CHECKOUT] [--sf 8] [--runs 3] q17 q93 q72 ...

For each class: its inputs on the card and its oracle first (the
checkout's own), then a warm-up and ``--runs`` timed runs (host clock
around each run, ending in a synchronize), every answer held against the
oracle. ``--root`` imports the
``auron_tpu_torch`` of another checkout (e.g. a parent commit unpacked
beside this one), so two trees can be timed in turns within one call.
Prints one JSON line: the card and its power limit, and per class the
walls, the peak device memory and the timed runs' summed ``task_bytes``,
``decode_s`` and ``plan_s`` (0 where the checkout's runner built its tree
by hand). Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

#: fact partitions of each class's inputs (its runner's map tasks)
PARTITIONS = {"q93": 4, "q72": 4, "q1": 4, "q6": 2, "q48": 2, "q16": 2, "windowed": 2}


def _inputs(tpcds, name: str, data):
    n = PARTITIONS.get(name, 1)
    if name == "q93":
        return tpcds.ingest_q93(data, n, device="cuda")
    if name == "q72":
        return tpcds.ingest_q72(data, n, device="cuda")
    if name == "windowed2":
        return tpcds.ingest_windowed2(data, device="cuda")
    return tpcds.ingest_q3(data, n, device="cuda")


def _oracle(tpcds, name: str, data) -> dict:
    """What ``_check`` holds a class's answers to (computed once a class)."""
    if name == "windowed":
        return tpcds.windowed_ranks(data)
    return getattr(tpcds, f"{name}_class_oracle")(data)


def _check(tpcds, name: str, want: dict, got: dict) -> None:
    import numpy as np

    if name == "windowed":
        bad = tpcds.windowed_mismatch(got, want)
        assert bad is None, (name, bad)
        return
    assert sorted(got) == sorted(want), (name, sorted(got), sorted(want))
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape, (name, k, g.shape, w.shape)
        if w.dtype.kind == "f":
            bound = (tpcds.running_sum_bound(np.asarray(want[part]), w)
                     if (part := {"run_sum": "ss_item_sk", "run_rev": "item"}.get(k)) else
                     1e-9 * np.abs(w))
            assert (np.abs(g - w) <= bound).all(), (name, k)
        else:
            assert np.array_equal(g, w), (name, k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("classes", nargs="+")
    ap.add_argument("--root", help="the checkout whose auron_tpu_torch to import")
    ap.add_argument("--sf", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root or os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import torch

    if not torch.cuda.is_available():
        print("class_walls: no CUDA device", file=sys.stderr)
        return 2
    from auron_tpu_torch.models import tpcds

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    data = tpcds.generate(args.sf, args.seed)
    out = {"root": args.root or ".", "nvidia_smi": smi, "sf": args.sf, "classes": {}}
    for name in args.classes:
        run = getattr(tpcds, f"run_{name}_class")
        ingested = _inputs(tpcds, name, data)
        want = _oracle(tpcds, name, data)
        _check(tpcds, name, want, run(device="cuda", ingested=ingested))
        walls, peaks, figures = [], [], {"task_bytes": 0, "decode_s": 0.0, "plan_s": 0.0}
        for _ in range(args.runs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stats: dict = {}
            t0 = time.perf_counter()
            got = run(device="cuda", ingested=ingested, stats=stats)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated())
            _check(tpcds, name, want, got)
            for k in figures:
                figures[k] += stats.get(k, 0)
        out["classes"][name] = {"walls_s": walls, "peak_bytes": max(peaks), **figures}
        print(f"{args.root or '.'} {name}: walls {[round(w, 4) for w in walls]} s, peak "
              f"{max(peaks) / 2**30:.3f} GiB, {figures}", file=sys.stderr, flush=True)
        del ingested, want
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
