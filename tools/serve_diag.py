#!/usr/bin/env python3
"""Concurrent SQL serving on the card: the serving gate's legs, measured.

    python3 tools/serve_diag.py [--root CHECKOUT] [--tag T] [--sf 8]
        [--clients 8] [--runs 1] [--profile] [--device cuda]

Runs ``servegate.run_gate`` ``--runs`` times, each on a new
``SqlServer`` (P = 2, the admission defaults) over one
``sqlgate.gate_tables(sf)``, with no speedup floor (its three legs:
warm, serial, ``--clients`` clients at rotated offsets, every answer
bit-identical to the warm leg). Each run prints its concurrent/serial ratio and the
record of each timed leg (``servegate._leg_record``: CPU over wall, host
syncs by site, lock waits, settles, spills, the allocator's counts).
``--profile``: the 24 texts once serially and once shared over the
clients under torch.profiler (``servegate.profiled_pass``: device busy
and idle share).

``--root`` imports the ``auron_tpu_torch`` of another checkout (a parent
commit unpacked beside this one), so two trees can be measured in turns
within one call. Prints one JSON line (also written to
``chiprun_out/serve_diag[-<tag>].json``): the card and its power limit,
each run's ratio and record, the profiles. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout whose auron_tpu_torch to import")
    ap.add_argument("--tag", default="", help="suffix of the JSON file's name")
    ap.add_argument("--sf", type=float, default=8.0)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--runs", type=int, default=1, help="gate runs, a server each")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda", help="cpu for a rehearsal at a tiny --sf")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..")))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("serve_diag: no CUDA device", file=sys.stderr)
        return 2
    import auron_tpu_torch
    from auron_tpu_torch.models import servegate, sqlgate
    from auron_tpu_torch.serve import SqlServer

    card = _card() if args.device == "cuda" else "cpu (rehearsal)"
    print(f"card: {card}; auron_tpu_torch from {os.path.dirname(auron_tpu_torch.__file__)}",
          flush=True)
    t0 = time.perf_counter()
    tables = sqlgate.gate_tables(args.sf)
    out: dict = {"card": card, "sf": args.sf, "clients": args.clients,
                 "setup_s": round(time.perf_counter() - t0, 3), "runs": []}
    ok = True
    for i in range(args.runs):
        # a server of its own: the gate's warm leg must miss the plan cache
        server = SqlServer(sqlgate.gate_catalog(), tables, n_parts=2, device=args.device)
        rec = servegate.run_gate(sf=args.sf, clients=args.clients, server=server,
                                 min_speedup=0.0)
        ok = ok and rec["ok"]
        out["runs"].append({k: v for k, v in rec.items() if k != "launches"})
        print(f"gate run {i}: ok {rec['ok']} serial {rec['serial_s']} s, concurrent "
              f"{rec['concurrent_s']} s, {rec['speedup']}x; failures {rec['failures'][:5]}",
              flush=True)
        for leg, r in rec.get("legs", {}).items():
            print(f"  {leg}: {json.dumps(r)}", flush=True)
    if args.profile and args.device == "cuda":
        names = [c.name for c in sqlgate.CASES]
        out["profile"] = [servegate.profiled_pass(server, names, n) for n in (1, args.clients)]
        for p in out["profile"]:
            print(f"profile, {p['clients']} client(s): {json.dumps(p)}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    name = f"serve_diag{'-' + args.tag if args.tag else ''}.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({"card": card, "speedups": [r["speedup"] for r in out["runs"]],
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
