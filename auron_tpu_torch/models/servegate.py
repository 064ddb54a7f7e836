"""Concurrency differential gate: N clients vs serial, bit-identical (port of
``auron_tpu/models/servegate.py``).

The SQL corpus the sqlgate verifies against pandas oracles is replayed
through :class:`~auron_tpu_torch.serve.server.SqlServer` in three legs —

1. WARM: every corpus query once, serially. Plans compile and cache
   (plan-digest cache + fusion stage cache: CUDA graphs captured, kernel
   sources built); results are recorded as the reference output.
2. SERIAL REPLAY: the corpus again, serially, on the warm server. This
   is the throughput baseline (serial queries/s) AND the replay
   contract: every result must be bit-identical to leg 1 and the leg
   must add ZERO new compiles (``utils/profiling.EngineCounters``: graph
   captures and kernel builds).
3. CONCURRENT: ``serve.gate.clients`` clients each replay the corpus
   once, simultaneously (each client starts at a rotated corpus offset
   so the mix is heterogeneous, like real tenants). Every result must
   again be bit-identical to leg 1, the leg must add zero compiles, and
   every query must carry its own distinct trace id (no cross-query
   attribution bleed).

The gate FAILS on: any result divergence, a plan-cache miss in legs 2-3,
any new compile in legs 2-3, duplicated trace ids, a client error, or
concurrent/serial throughput below the speedup floor. p50/p99 latency is
recorded per leg, and the K1-K4 launches: per query in the serial leg
(the global counts around each submit, which run one at a time) and in
total over the concurrent leg.

The speedup floor follows the reference's rule: ``SERVEGATE_MIN_SPEEDUP``
when set, else 2.0 on the card and 1.4 on the CPU. The reference's
``PERF_RATCHET.json`` ratchet is left out: that file records the JAX
package's CPU runs.

Run ``python -m auron_tpu_torch.models.servegate`` on the card
(``SERVEGATE_DEVICE=cpu`` for the CPU; ``SERVEGATE_SF``,
``SERVEGATE_CLIENTS``, ``SERVEGATE_QUERIES`` override the defaults).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from auron_tpu_torch.utils.config import (
    SERVE_GATE_CLIENTS,
    SERVE_GATE_SF,
    SQL_SHUFFLE_PARTITIONS,
    Configuration,
)


def _percentiles(lat_s: list[float]) -> dict:
    if not lat_s:
        return {"p50_ms": None, "p99_ms": None}
    arr = np.asarray(lat_s, dtype=np.float64) * 1e3
    return {"p50_ms": round(float(np.percentile(arr, 50)), 2),
            "p99_ms": round(float(np.percentile(arr, 99)), 2)}


def _frames_identical(a, b) -> bool:
    """Bit-identity for result frames: same dtypes, same values, same
    row order (executions are deterministic; any reorder is a finding)."""
    if list(a.columns) != list(b.columns) or len(a) != len(b):
        return False
    if list(a.dtypes) != list(b.dtypes):
        return False
    return a.equals(b)


def build_server(sf: Optional[float] = None, n_parts: Optional[int] = None,
                 tables: Optional[dict] = None, conf=None, device="cuda"):
    """A SqlServer over the sqlgate's catalog + the port's TPC-DS tables."""
    from auron_tpu_torch.models import sqlgate
    from auron_tpu_torch.serve import SqlServer

    base = conf if conf is not None else Configuration()
    sf = sf if sf is not None else SERVE_GATE_SF.get(base)
    n_parts = (n_parts if n_parts is not None
               else SQL_SHUFFLE_PARTITIONS.get(base))
    if tables is None:
        tables = sqlgate.gate_tables(sf)
    return SqlServer(sqlgate.gate_catalog(), tables, conf=base,
                     n_parts=n_parts, device=device), sf


def run_gate(sf: Optional[float] = None, clients: Optional[int] = None,
             names: Optional[list[str]] = None,
             tables: Optional[dict] = None,
             min_speedup: Optional[float] = None,
             server=None, device="cuda", answers: Optional[dict] = None) -> dict:
    """The three-leg differential; returns the summary record (``ok``
    plus every failure listed in ``failures``). ``server`` (else one built
    over ``tables`` on ``device``) fixes the device; ``answers`` gets the
    warm leg's result frames by query name."""
    import threading

    from auron_tpu_torch.models import sqlgate
    from auron_tpu_torch.models.sqlgate import _launches
    from auron_tpu_torch.utils.profiling import EngineCounters

    counters = EngineCounters.install()
    conf = Configuration()
    clients = clients if clients is not None else SERVE_GATE_CLIENTS.get(conf)
    if server is None:
        server, sf = build_server(sf=sf, tables=tables, conf=conf, device=device)
    elif sf is None:
        sf = SERVE_GATE_SF.get(conf)
    if min_speedup is None:
        env = os.environ.get("SERVEGATE_MIN_SPEEDUP")
        if env is not None:
            min_speedup = float(env)
        else:
            # the reference's substrate-resolved floor: accelerators claim
            # the 2x, the CPU the 1.4x
            min_speedup = 2.0 if server.device.type == "cuda" else 1.4
    cases = [c for c in sqlgate.CASES
             if names is None or c.name in names]
    failures: list[str] = []

    # ---- leg 1: warm (compile + cache; reference results)
    reference: dict[str, object] = answers if answers is not None else {}
    t0 = time.perf_counter()
    for c in cases:
        df, rec = server.submit(c.sql, tenant="warm")
        reference[c.name] = df
        if rec["cache_hit"]:
            failures.append(f"warm leg unexpectedly hit the cache: {c.name}")
    warm_s = time.perf_counter() - t0
    compiles_warm = counters.compiles

    # ---- leg 2: serial replay on the warm server
    serial_lat: list[float] = []
    serial_launches: dict[str, dict] = {}
    trace_ids: list[int] = []
    t0 = time.perf_counter()
    for c in cases:
        before = _launches()
        df, rec = server.submit(c.sql, tenant="serial")
        serial_launches[c.name] = {k: v - before[k] for k, v in _launches().items()}
        serial_lat.append(rec["wall_s"])
        if "trace_id" in rec:
            trace_ids.append(rec["trace_id"])
        if not rec["cache_hit"]:
            failures.append(f"serial replay missed the plan cache: {c.name}")
        if not _frames_identical(reference[c.name], df):
            failures.append(f"serial replay diverged: {c.name}")
    serial_s = time.perf_counter() - t0
    serial_qps = len(cases) / serial_s if serial_s else 0.0
    replay_compiles = counters.compiles - compiles_warm
    if replay_compiles:
        failures.append(
            f"serial replay added {replay_compiles} compiles "
            "(program cache failed)")

    # ---- leg 3: N clients replay concurrently, rotated offsets
    conc_lat: list[float] = []
    conc_failures: list[str] = []
    lock = threading.Lock()

    def client(i: int) -> None:
        try:
            order = cases[i % len(cases):] + cases[:i % len(cases)]
            for c in order:
                try:
                    df, rec = server.submit(c.sql, tenant=f"client{i}")
                except Exception as e:  # noqa: BLE001 — the gate records
                    with lock:
                        conc_failures.append(
                            f"client{i} {c.name}: {type(e).__name__}: {e}")
                    continue
                with lock:
                    conc_lat.append(rec["wall_s"])
                    if "trace_id" in rec:
                        trace_ids.append(rec["trace_id"])
                    if not rec["cache_hit"]:
                        conc_failures.append(
                            f"client{i} missed the plan cache: {c.name}")
                    if not _frames_identical(reference[c.name], df):
                        conc_failures.append(
                            f"client{i} diverged from serial: {c.name}")
        except BaseException as e:  # noqa: BLE001
            # the comparison code above runs on this client thread too: an
            # escaping error would kill the thread silently and the gate
            # would under-count — record it as a failure instead
            with lock:
                conc_failures.append(
                    f"client{i} crashed: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    compiles_before = counters.compiles
    launches_before = _launches()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    conc_s = time.perf_counter() - t0
    conc_launches = {k: v - launches_before[k] for k, v in _launches().items()}
    failures.extend(conc_failures)
    conc_queries = clients * len(cases)
    conc_qps = conc_queries / conc_s if conc_s else 0.0
    conc_compiles = counters.compiles - compiles_before
    if conc_compiles:
        failures.append(
            f"concurrent leg added {conc_compiles} compiles")
    # every query ran as its OWN trace: duplicated ids = attribution bleed
    if len(trace_ids) != len(set(trace_ids)):
        failures.append("duplicated trace ids across queries (trace bleed)")

    speedup = conc_qps / serial_qps if serial_qps else 0.0
    if speedup < min_speedup:
        failures.append(
            f"concurrent/serial queries/s {speedup:.2f}x < required "
            f"{min_speedup:.2f}x")

    return {
        "metric": "servegate", "sf": sf, "clients": clients,
        "queries": len(cases), "device": str(server.device),
        "warm_s": round(warm_s, 3),
        "serial_s": round(serial_s, 3),
        "serial_qps": round(serial_qps, 3),
        "serial": _percentiles(serial_lat),
        "concurrent_s": round(conc_s, 3),
        "concurrent_qps": round(conc_qps, 3),
        "concurrent": _percentiles(conc_lat),
        "speedup": round(speedup, 3),
        "min_speedup": min_speedup,
        "replay_compiles": replay_compiles,
        "concurrent_compiles": conc_compiles,
        "launches": {"serial": serial_launches, "concurrent": conc_launches},
        "trace_ids": len(trace_ids),
        "server": server.stats(),
        "failures": failures,
        "ok": not failures,
    }


def main() -> None:
    import json
    import sys

    sf = float(os.environ.get("SERVEGATE_SF", "0") or 0) or None
    clients = int(os.environ.get("SERVEGATE_CLIENTS", "0") or 0) or None
    names = [n for n in os.environ.get("SERVEGATE_QUERIES", "").split(",")
             if n] or None
    device = os.environ.get("SERVEGATE_DEVICE", "cuda")
    rec = run_gate(sf=sf, clients=clients, names=names, device=device)
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
