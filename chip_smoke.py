#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (auron_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full run: q42, q93 and q3-class at SF 8
    python3 chip_smoke.py --sf 0.5   # smaller end-to-end phases
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of one run of each query

Phases, in order, none of them caught — any failure exits non-zero:

1. identify the card (torch device name + the nvidia-smi name/power line);
2. build every CUDA source of the port (one nvcc per source, started
   together) and print the build seconds;
3. hold each kernel against its plain PyTorch version, bit for bit:
   ``bitonic_sort`` at P in {2048, 16384, 2^20} with 3 and 8 planes,
   ``bitonic_merge`` on bitonic inputs at the same shapes (both also
   against a numpy stable lexsort), the operand-level ``bitonic_sort``
   (int32 planes split and joined on the card) against the plain network
   and the library lexsort, and the partition-id kernel ``murmur3_pmod``
   (K1) at n in {1, 1000, 2^20, 2^20 + 37, 5.76 M} rows x n_parts in
   {1, 3, 4, 200, 4096}, 85 % and 0 % NULL keys, with INT64_MIN, INT64_MAX,
   0 and -1 among the keys, and the routing histogram kernel
   ``partition_histogram`` (K2) at n in {0, 1, 1000, 2^20 + 37, 5,767,168,
   23,040,000} x n_parts in {1, 2, 4, 8, 200, 4096, one past its
   shared-memory branch} x 0 %, 50 % and 100 % live rows, with -1, n_parts,
   INT32_MIN and INT32_MAX among the ids (also against numpy's bincount);
   time kernels, plain versions and library calls with CUDA events
   (bitonic at the q42 shape P = 16384, 8 planes; K1 at 2^20 rows, 4
   partitions; K2 at a q93 map shard, 8,388,608 rows of which 5,760,000
   live, 4 partitions, ~89 % to one);
4. generate the data once (all later phases share it) and drive the
   q42-class query (scan -> broadcast hash join -> partial and final hash
   aggregate -> SortExec with fetch 10) end to end on ``cuda`` through the
   task runtime, check it against the numpy oracle (brand and order exact,
   revenue at rel 1e-9), and require that the SortExec went through both
   bitonic kernels;
5. the q93-class query: map tasks (scan -> CASE key -> file shuffle on one
   nullable int64 key, ~85 % NULL) then reduce tasks (shuffle read -> left
   broadcast hash join -> partial and final aggregate by key IS NULL),
   4 map x 4 reduce; a warm-up run, then a timed run, each in its own
   temporary directory; rows and matched exact and s at rel 1e-9 against
   the numpy oracle, and the shuffle writer must have launched K1;
6. the q3-class query (two inner broadcast hash joins -> partial aggregate
   -> file shuffle on two int32 keys -> final aggregate -> driver top-k),
   4 x 4, warm-up then timed; keys and order exact, s at rel 1e-9;
7. q93-mesh and q3-mesh: the same two queries as one plan each through the
   planned-exchange driver (``parallel/mesh_driver.py``) on P = 4 logical
   partitions of the card, once with ``exchange.mode`` = mesh (device-
   resident exchange) and once = file; q3 then runs its single-task
   collect stage (SortExec fetch 100 -> LimitExec 100). Each mode gets a
   warm-up and a timed run; every answer equals its oracle and the two
   transports agree; K2 must launch exactly P times in every timed run, K1
   in q93's and K3/K4 in q3's. The operands of q3's collect sort, recorded
   in the warm-up run, go through K3/K4 and through the plain network on
   the card once more, bit for bit (the kernels at the main path's own
   shapes). The routing matrix, mode, slot capacity, stage walls and peak
   device memory are printed;
8. print the kernel table as one JSON line, then the final status line.

Every launch count is set to 0 just before the timed run of a query and
read just after it; launches made to compare kernels are not counted.

Needs no network, no pyarrow, no pandas and no protobuf; imports nothing
of the JAX package. Exits with code 2 when no CUDA device is visible.
Detailed results also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
NON_TENSOR_OPS_PER_S = 67e12  # H100 SXM fp32 non-tensor peak (no int32 row in the table)
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def _event_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _planes(rng, NP: int, P: int):
    """(NP, P) uint32 planes as int64 carriers: tie-heavy leading planes,
    full-range middle planes, a distinct payload (iota) as the last plane."""
    import numpy as np

    out = np.empty((NP, P), dtype=np.int64)
    for p in range(NP - 1):
        hi = 4 if p == 0 else (1 << 32)
        out[p] = rng.integers(0, hi, P, dtype=np.int64)
    out[NP - 1] = np.arange(P, dtype=np.int64)
    return out


def _lexsorted(planes):
    import numpy as np

    return planes[:, np.lexsort(tuple(planes[::-1]))]


def _bitonic_input(planes):
    """First half ascending, second half descending: one bitonic sequence."""
    import numpy as np

    half = planes.shape[1] // 2
    a = _lexsorted(planes[:, :half])
    b = _lexsorted(planes[:, half:])[:, ::-1]
    return np.ascontiguousarray(np.concatenate([a, b], axis=1))


def check_kernels(seed: int) -> dict:
    import numpy as np
    import torch

    from auron_tpu_torch.ops import bitonic

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    checks = []
    err = {"bitonic_sort": 0, "bitonic_merge": 0}
    for P in (2048, 16384, 1 << 20):
        for NP in (3, 8):
            host = _planes(rng, NP, P)
            want = _lexsorted(host)
            x = torch.from_numpy(host).to(dev)
            got_k = bitonic._run(x, P, "pallas", merge=False)
            got_p = bitonic._network(x, P)
            err["bitonic_sort"] = max(err["bitonic_sort"], int((got_k - got_p).abs().max()))
            assert np.array_equal(got_k.cpu().numpy(), want), ("bitonic_sort", P, NP)
            assert torch.equal(got_k, got_p), ("bitonic_sort plain", P, NP)
            bit = _bitonic_input(host)
            xb = torch.from_numpy(bit).to(dev)
            mk = bitonic.bitonic_merge(xb, impl="pallas")
            mp = bitonic._merge_network(xb, P)
            err["bitonic_merge"] = max(err["bitonic_merge"], int((mk - mp).abs().max()))
            assert np.array_equal(mk.cpu().numpy(), want), ("bitonic_merge", P, NP)
            assert torch.equal(mk, mp), ("bitonic_merge plain", P, NP)
            checks.append({"P": P, "NP": NP, "sort_equal": True, "merge_equal": True})
            print(f"kernel check P={P} NP={NP}: sort and merge bit-equal to plain and numpy",
                  flush=True)
    # the operand-level entry: int32 planes split and joined on the card
    for cap in (10_000, (1 << 20) - 3):
        live = torch.from_numpy((rng.random(cap) < 0.1).astype(np.int64)).to(dev)
        words = [torch.from_numpy(rng.integers(-hi, hi, cap, dtype=np.int64)).to(dev)
                 for hi in (1 << 12, 2**63 - 1)]  # many ties, then full 64-bit words
        narrow = torch.from_numpy(rng.integers(0, 50, cap).astype(np.int64)).to(dev)
        iota = torch.arange(cap, dtype=torch.int32, device=dev)
        ops = (live, *words, narrow, iota)
        flags = (True, False, False, True, False)
        got = bitonic.bitonic_sort(ops, impl="pallas", narrow=flags)
        ref = bitonic.bitonic_sort(ops, impl="jnp", narrow=flags)
        want = bitonic.lex_sorted(ops)
        for g, r, w in zip(got, ref, want):
            assert g.dtype == r.dtype and torch.equal(g, r) and torch.equal(g, w), (
                "bitonic_sort operands", cap)
        checks.append({"cap": cap, "operands_equal": True})
        print(f"kernel check operands cap={cap}: bit-equal to plain and lexsort", flush=True)
    return {"checks": checks, "max_abs_err": err}


_I64_EDGES = (-(2**63), 2**63 - 1, 0, -1)


def _device_events(prof):
    """(name, device ms, count) of the device-side events of a trace:
    kernels and copies. A host op's device time is the sum of the kernels
    it launched, so summing host ops as well would count them twice."""
    import torch

    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = us if us is not None else getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out.append((e.key, us / 1e3, e.count))
    return out


def _profiled_kernel_ms(fn, name: str, iters: int, attempts: int = 3):
    """Mean device time of the kernels whose name holds ``name``, from
    torch.profiler over ``iters`` calls (a trace that caught none of them
    is taken again, up to ``attempts`` times); None when no trace had any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [(ms, c) for key, ms, c in _device_events(prof) if name in key]
        if hits:
            return sum(ms for ms, _ in hits) / sum(c for _, c in hits)
    return None


def check_partition_kernel(seed: int) -> dict:
    """K1 against its plain version, bit for bit."""
    import numpy as np
    import torch

    from auron_tpu_torch.ops import partition_kernels as pk

    rng = np.random.default_rng(seed + 2)
    dev = torch.device("cuda")
    err = 0
    checks = []
    for n in (1, 1000, 1 << 20, (1 << 20) + 37, 5_760_000):
        keys = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True)
        keys[: min(n, len(_I64_EDGES))] = _I64_EDGES[: min(n, len(_I64_EDGES))]
        k = torch.from_numpy(keys).to(dev)
        for null_share in (0.85, 0.0):
            valid = torch.from_numpy(rng.random(n) >= null_share).to(dev)
            for n_parts in (1, 3, 4, 200, 4096):
                got = pk.launch_partition_ids(k, valid, n_parts)
                want = pk.plain_partition_ids(k, valid, n_parts)
                torch.cuda.synchronize()
                err = max(err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
                assert torch.equal(got, want), ("murmur3_pmod", n, null_share, n_parts)
                assert bool(((got >= 0) & (got < n_parts)).all()), ("pid range", n, n_parts)
            checks.append({"n": n, "null_share": null_share, "equal": True})
        print(f"kernel check murmur3_pmod n={n}: bit-equal to plain for n_parts "
              f"1/3/4/200/4096 at 85 % and 0 % NULL", flush=True)
    return {"checks": checks, "max_abs_err": err}


def time_partition_kernel(seed: int, n: int = 1 << 20, n_parts: int = 4) -> dict:
    """K1 / plain times at the q93 map batch shape (no one library call
    computes Spark murmur3: library_ms is null)."""
    import numpy as np
    import torch

    from auron_tpu_torch.ops import partition_kernels as pk

    rng = np.random.default_rng(seed + 3)
    k = torch.from_numpy(rng.integers(1, 100_000, n, dtype=np.int64)).cuda()
    valid = torch.from_numpy(rng.random(n) >= 0.85).cuda()
    saved = dict(pk.LAUNCHES)
    ms = _event_ms(lambda: pk.launch_partition_ids(k, valid, n_parts), 200, warmup=5)
    plain_ms = _event_ms(lambda: pk.plain_partition_ids(k, valid, n_parts), 20, warmup=2)
    device_ms = _profiled_kernel_ms(lambda: pk.launch_partition_ids(k, valid, n_parts),
                                    "murmur3_pmod", 50)
    pk.LAUNCHES.update(saved)
    nbytes = n * (8 + 1 + 4)  # key and validity read once, id written once
    ops = n * 30  # two mix rounds, fmix, pmod, select: ~30 integer ops a row
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / NON_TENSOR_OPS_PER_S * 1e3
    r = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "n": n, "n_parts": n_parts,
         "device_ms": device_ms,
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"murmur3_pmod n={n} n_parts={n_parts}: kernel {ms:.4f} ms a call "
          f"(device time {device_ms} ms a launch, torch.profiler), plain {plain_ms:.4f} ms, "
          f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), no library call", flush=True)
    return r


_I32_EDGES = (-1, -(2**31), 2**31 - 1)


def check_histogram_kernel(seed: int) -> dict:
    """K2 against its plain version (bit for bit) and numpy's bincount."""
    import numpy as np
    import torch

    from auron_tpu_torch.ops import partition_kernels as pk

    rng = np.random.default_rng(seed + 4)
    dev = torch.device("cuda")
    shared_parts = pk.histogram_shared_parts()
    parts = (1, 2, 4, 8, 200, 4096, shared_parts + 1)
    err = 0
    checks = []
    for n in (0, 1, 1000, (1 << 20) + 37, 5_767_168, 23_040_000):
        base = rng.integers(0, 2**31, n, dtype=np.int64)
        shares = rng.random(n)
        for n_parts in parts:
            # ids from -3 to n_parts + 2: some out of range on both sides
            pids = (base % (n_parts + 6) - 3).astype(np.int32)
            edges = np.array(_I32_EDGES + (n_parts,), np.int32)[: min(n, 4)]
            pids[: len(edges)] = edges
            p = torch.from_numpy(pids).to(dev)
            for live_share in (0.0, 0.5, 1.0):
                sel = shares < live_share
                s = torch.from_numpy(sel).to(dev)
                got = pk.launch_partition_histogram(p, n_parts, s)
                want = pk.plain_partition_histogram(p, n_parts, s)
                torch.cuda.synchronize()
                err = max(err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
                assert torch.equal(got, want), ("partition_histogram", n, n_parts, live_share)
                keep = sel & (pids >= 0) & (pids < n_parts)
                host = np.bincount(pids[keep], minlength=n_parts)
                assert np.array_equal(got.cpu().numpy(), host), ("bincount", n, n_parts)
            no_sel = pk.launch_partition_histogram(p, n_parts)
            assert torch.equal(no_sel, pk.plain_partition_histogram(p, n_parts)), (
                "partition_histogram without sel", n, n_parts)
        checks.append({"n": n, "n_parts": list(parts), "equal": True})
        print(f"kernel check partition_histogram n={n}: bit-equal to plain and numpy for "
              f"n_parts {parts} at 0/50/100 % live", flush=True)
    return {"checks": checks, "max_abs_err": err, "shared_parts": shared_parts}


def time_histogram_kernel(seed: int, n_parts: int = 4) -> dict:
    """K2 / plain / torch.bincount at one q93 map shard: six fact batches
    concatenated to 8,388,608 rows of capacity, 5,760,000 live, ~89 % of
    the live ids on one partition (the NULL-key skew); the same timings on
    uniform ids beside it."""
    import numpy as np
    import torch

    from auron_tpu_torch.columnar.batch import bucket_capacity
    from auron_tpu_torch.ops import partition_kernels as pk

    rng = np.random.default_rng(seed + 5)
    n = bucket_capacity(5 * (1 << 20) + (1 << 19))
    live = 5_760_000
    sel = torch.zeros(n, dtype=torch.bool, device="cuda")
    sel[:live] = True
    saved = dict(pk.LAUNCHES)
    res = {}
    for shape in ("skewed", "uniform"):
        ids = rng.integers(0, n_parts, n)
        if shape == "skewed":
            ids = np.where(rng.random(n) < 0.89, 42 % n_parts, ids)
        p = torch.from_numpy(ids.astype(np.int32)).cuda()
        blended = torch.where(sel, p.to(torch.int64), n_parts)
        r = {
            "ms": _event_ms(lambda: pk.launch_partition_histogram(p, n_parts, sel), 200,
                            warmup=5),
            "plain_ms": _event_ms(lambda: pk.plain_partition_histogram(p, n_parts, sel), 50),
            # one library call on the blended ids (the blend itself not timed)
            "library_ms": _event_ms(lambda: torch.bincount(blended, minlength=n_parts + 1),
                                    50),
            "device_ms": _profiled_kernel_ms(
                lambda: pk.launch_partition_histogram(p, n_parts, sel), "histogram", 50),
        }
        res[shape] = r
    pk.LAUNCHES.update(saved)
    # every sel byte read once, the id of each live row read once (a dead
    # row's id is not needed), the counts written once
    nbytes = n * 1 + int(sel.sum()) * 4 + n_parts * 4
    ops = n * 4  # range check, sel test, match, add: a few integer ops a row
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / NON_TENSOR_OPS_PER_S * 1e3
    out = {**res["skewed"], "uniform": res["uniform"], "n": n, "live": live,
           "n_parts": n_parts, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    for shape, r in res.items():
        print(f"partition_histogram n={n} live={live} n_parts={n_parts} {shape}: kernel "
              f"{r['ms']:.4f} ms a call (device time {r['device_ms']} ms a launch, "
              f"torch.profiler), plain {r['plain_ms']:.4f} ms, torch.bincount "
              f"{r['library_ms']:.4f} ms, bound {out['bound_ms']:.6f} ms ({out['bound_by']})",
              flush=True)
    return out


def _reset_launches() -> None:
    from auron_tpu_torch.ops import bitonic, partition_kernels

    for counts in (bitonic.LAUNCHES, partition_kernels.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launches() -> dict:
    from auron_tpu_torch.ops import bitonic, partition_kernels

    return {**bitonic.LAUNCHES, **partition_kernels.LAUNCHES}


def time_kernels(seed: int, P: int = 16384, NP: int = 8) -> dict:
    """Kernel / plain / library times at the q42 sort shape."""
    import math

    import numpy as np
    import torch

    from auron_tpu_torch.ops import bitonic
    from auron_tpu_torch.ops.uwords import i32_of_u32

    rng = np.random.default_rng(seed + 1)
    dev = torch.device("cuda")
    host = _planes(rng, NP, P)
    x = torch.from_numpy(host).to(dev)
    x32 = i32_of_u32(x).contiguous()
    sorted32 = i32_of_u32(torch.from_numpy(_lexsorted(host)).to(dev)).contiguous()
    bit = torch.from_numpy(_bitonic_input(host)).to(dev)
    cols = tuple(x[p] for p in range(NP))
    bit_cols = tuple(bit[p] for p in range(NP))
    kinds = ("i64",) * NP
    L = int(math.log2(P))
    T = bitonic.tile_for(NP, P)
    saved = dict(bitonic.LAUNCHES)
    res = {}
    iters = 50
    # sort: the tile sort + merge stages (the data-oblivious network takes
    # the same time on any input, so re-sorting one buffer is a fair loop)
    res["bitonic_sort"] = {
        "ms": _event_ms(lambda: bitonic.kernel_sort_(x32), iters),
        "plain_ms": _event_ms(lambda: bitonic._network(x, P), 5, warmup=1),
        "library_ms": _event_ms(lambda: bitonic.lexsort(cols, kinds), iters),
        "compare_exchanges": (P // 2) * L * (L + 1) // 2,
    }
    # merge of one bitonic sequence (an ascending run is bitonic, so the
    # in-place loop keeps a valid input)
    res["bitonic_merge"] = {
        "ms": _event_ms(lambda: bitonic.kernel_merge_(sorted32), iters),
        "plain_ms": _event_ms(lambda: bitonic._merge_network(bit, P), 5, warmup=1),
        "library_ms": _event_ms(lambda: bitonic.lexsort(bit_cols, kinds), iters),
        "compare_exchanges": (P // 2) * L,
    }
    bitonic.LAUNCHES.update(saved)
    for name, r in res.items():
        nbytes = 2 * NP * P * 4  # each plane read once and written once
        ops = 3 * NP * r["compare_exchanges"]  # compare, equality chain, select per plane
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / NON_TENSOR_OPS_PER_S * 1e3
        r.update({
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "P": P, "NP": NP, "tile": T,
        })
        print(f"{name} P={P} NP={NP} tile={T}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, torch.sort lexsort {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})", flush=True)
    return res


def run_q42(data, sf: float, t_gen: float) -> dict:
    import numpy as np
    import torch

    from auron_tpu_torch.models import tpcds

    t0 = time.perf_counter()
    ingested = tpcds.ingest_q42(data, device="cuda")
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    oracle = tpcds.q42_class_oracle(data)
    # warm-up run (first launches, allocator), checked like the timed one
    warm = tpcds.run_q42_class(device="cuda", ingested=ingested)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tpcds.run_q42_class(device="cuda", ingested=ingested)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    for out in (warm, got):
        assert out["brand"].shape == (10,) and np.isfinite(out["rev"]).all(), out
        assert np.array_equal(out["brand"], oracle["brand"]), (out["brand"], oracle["brand"])
        np.testing.assert_allclose(out["rev"], oracle["rev"], rtol=1e-9, atol=0)
    for name in ("bitonic_sort", "bitonic_merge"):
        assert launches[name] > 0, f"q42 main path launched {name} no time: {launches}"
    rows = data.fact_rows()
    print(f"q42-class SF {sf}: {rows} fact rows, wall {wall:.4f} s, "
          f"{rows / wall:.1f} fact rows/s, launches {launches}, top brand "
          f"{int(got['brand'][0])} rev {float(got['rev'][0]):.2f}", flush=True)
    return {"sf": sf, "fact_rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
            "generate_s": t_gen, "ingest_s": t_ingest, "launches": launches,
            "brand": got["brand"].tolist(), "rev": got["rev"].tolist()}, ingested


def _print_timers(query: str, stats: dict) -> None:
    for k, v in sorted(stats["timers"].items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {query} host timer {v * 1e3:9.3f} ms  {k}", flush=True)


def profile_run(query: str, fn) -> dict:
    """One more run under torch.profiler: device busy time (sum of the
    device-side events, one stream) against the wall, and the top kernels.
    Its launches are not counted in the kernel table."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    saved = _launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from auron_tpu_torch.ops import bitonic, partition_kernels

    for counts in (bitonic.LAUNCHES, partition_kernels.LAUNCHES):
        counts.update({k: saved[k] for k in counts})
    kernels = sorted(_device_events(prof), key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1 - busy_ms / (wall * 1e3)),
           "top_kernels": [{"name": n, "ms": ms, "count": c} for n, ms, c in kernels[:12]]}
    print(f"{query} profile: wall {out['wall_ms']:.3f} ms (profiled), device busy "
          f"{busy_ms:.3f} ms, idle share {out['device_idle_share']:.3f}", flush=True)
    for n, ms, c in kernels[:8]:
        print(f"  kernel {ms:9.4f} ms x{c:5d}  {n[:100]}", flush=True)
    return out


def run_q93(data, fact) -> dict:
    """q93-class, 4 map x 4 reduce: warm-up, then the timed run."""
    import torch

    from auron_tpu_torch.models import tpcds

    ingested = tpcds.ingest_q93(data, 4, device="cuda", fact=fact)
    oracle = tpcds.q93_class_oracle(data)
    warm = tpcds.run_q93_class(device="cuda", ingested=ingested)
    _reset_launches()
    torch.cuda.synchronize()
    stats: dict = {}
    t0 = time.perf_counter()
    got = tpcds.run_q93_class(device="cuda", ingested=ingested, stats=stats)
    wall = time.perf_counter() - t0
    launches = _launches()
    for out in (warm, got):
        _assert_q93(out, oracle)
    assert launches["murmur3_pmod"] > 0, f"q93 main path launched K1 no time: {launches}"
    null_rows = stats["partition_rows"][stats["null_partition"]]
    rows = data.fact_rows()
    print(f"q93-class: {rows} fact rows, wall {wall:.4f} s (map stage {stats['map_s']:.4f} s, "
          f"reduce stage {stats['reduce_s']:.4f} s), shuffle bytes written "
          f"{stats['shuffle_bytes']}, NULL-key partition {stats['null_partition']} got "
          f"{null_rows} rows of {sum(stats['partition_rows'])}, launches {launches}", flush=True)
    _print_timers("q93", stats)
    return {"fact_rows": rows, "wall_s": wall, "rows_per_s": rows / wall, **stats,
            "null_partition_rows": null_rows, "launches": launches,
            "rows": got["rows"].tolist(), "matched": got["matched"].tolist(),
            "s": got["s"].tolist()}


def run_q3(data, fact) -> dict:
    """q3-class, 4 map x 4 reduce: warm-up, then the timed run."""
    import torch

    from auron_tpu_torch.models import tpcds

    ingested = tpcds.ingest_q3(data, 4, device="cuda", fact=fact)
    oracle = tpcds.q3_class_oracle(data)
    warm = tpcds.run_q3_class(device="cuda", ingested=ingested)
    _reset_launches()
    torch.cuda.synchronize()
    stats: dict = {}
    t0 = time.perf_counter()
    got = tpcds.run_q3_class(device="cuda", ingested=ingested, stats=stats)
    wall = time.perf_counter() - t0
    launches = _launches()
    for out in (warm, got):
        _assert_q3(out, oracle)
    rows = data.fact_rows()
    print(f"q3-class: {rows} fact rows, wall {wall:.4f} s (map stage {stats['map_s']:.4f} s, "
          f"reduce stage {stats['reduce_s']:.4f} s), shuffle bytes written "
          f"{stats['shuffle_bytes']}, launches {launches}, first row "
          f"({int(got['d_year'][0])}, {int(got['i_brand_id'][0])}, {float(got['s'][0]):.2f})",
          flush=True)
    _print_timers("q3", stats)
    return {"fact_rows": rows, "wall_s": wall, "rows_per_s": rows / wall, **stats,
            "launches": launches, "top": {k: v[:10].tolist() for k, v in got.items()}}


def _assert_q93(out: dict, want: dict) -> None:
    assert out["k_null"].tolist() == want["k_null"].tolist(), (out, want)
    for k in ("rows", "matched"):
        assert _np_equal(out[k], want[k]), (k, out, want)
    assert all(math.isfinite(x) for x in out["s"])
    _assert_close(out["s"], want["s"])


def _assert_q3(out: dict, want: dict) -> None:
    assert len(out["s"]) == len(want["s"]) > 0 and all(math.isfinite(x) for x in out["s"])
    for k in ("d_year", "i_brand_id"):
        assert _np_equal(out[k], want[k]), (k, out[k][:10], want[k][:10])
    _assert_close(out["s"], want["s"])


def _np_equal(a, b) -> bool:
    import numpy as np

    return bool(np.array_equal(a, b))


def _assert_close(got, want) -> None:
    import numpy as np

    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


@contextlib.contextmanager
def _recording_sorts(record: list):
    """Record a copy of the operands of every ORDER BY sort
    (``SortExec`` calls ``bitonic.ordered_sort``) made inside the block."""
    from auron_tpu_torch.ops import bitonic

    real = bitonic.ordered_sort

    def recording(operands, word_narrow=None, impl=None, conf=None):
        record.append((tuple(o.clone() for o in operands), word_narrow))
        return real(operands, word_narrow=word_narrow, impl=impl, conf=conf)

    bitonic.ordered_sort = recording
    try:
        yield
    finally:
        bitonic.ordered_sort = real


def check_sorts(label: str, record: list) -> list:
    """K3/K4 at a main path's own sort shapes: each recorded operand tuple
    sorted by the CUDA kernels and by the plain network on the card, bit
    for bit, and against the library lexsort. Its launches are not counted."""
    import torch

    from auron_tpu_torch.ops import bitonic

    saved = dict(bitonic.LAUNCHES)
    out = []
    for ops, word_narrow in record:
        n_words = len(ops) - 2
        narrow = (True, *(word_narrow or (False,) * n_words), False)
        before = dict(bitonic.LAUNCHES)
        got = bitonic.bitonic_sort(ops, impl="pallas", narrow=narrow)
        launched = {k: bitonic.LAUNCHES[k] - before[k] for k in before}
        ref = bitonic.bitonic_sort(ops, impl="jnp", narrow=narrow)
        want = bitonic.lex_sorted(ops)
        err = 0
        for g, r, w in zip(got, ref, want):
            assert g.dtype == r.dtype and torch.equal(g, r) and torch.equal(g, w), (
                "collect sort", label)
            err = max(err, int((g.to(torch.int64) - r.to(torch.int64)).abs().max()))
        kinds = tuple(bitonic._default_kind(o) for o in ops)
        cap = ops[0].shape[0]
        shape = {"cap": cap, "P": max(bitonic._next_pow2(cap), 8 * bitonic._LANES),
                 "NP": len(bitonic._split_planes32(ops, narrow, kinds)),
                 "launches": launched, "max_abs_err": err}
        assert launched["bitonic_sort"] > 0, (label, shape)
        out.append(shape)
        print(f"kernel check {label} collect sort: cap {cap}, P {shape['P']}, NP "
              f"{shape['NP']}, kernel launches {launched}: bit-equal to plain and lexsort",
              flush=True)
    bitonic.LAUNCHES.update(saved)
    return out


def run_mesh(query: str, data, fact, n_parts: int = 4) -> dict:
    """q93-mesh or q3-mesh through the planned-exchange driver, once per
    transport (mesh, then file): warm-up, then the timed run."""
    import torch

    from auron_tpu_torch.models import tpcds

    if query == "q93":
        ingested = tpcds.ingest_q93(data, n_parts, device="cuda", fact=fact)
        run, oracle, check = tpcds.run_q93_mesh, tpcds.q93_class_oracle(data), _assert_q93
    else:
        ingested = tpcds.ingest_q3(data, n_parts, device="cuda", fact=fact)
        run, oracle, check = tpcds.run_q3_mesh, tpcds.q3_class_oracle(data), _assert_q3
    out = {}
    answers = {}
    for mode in ("mesh", "file"):
        conf = {"exchange.mode": mode}
        sorts: list = []
        with _recording_sorts(sorts):
            warm = run(n_parts=n_parts, device="cuda", conf=conf, ingested=ingested)
        sort_checks = check_sorts(f"{query}-mesh ({mode})", sorts)
        _reset_launches()
        torch.cuda.synchronize()
        stats: dict = {}
        t0 = time.perf_counter()
        got = run(n_parts=n_parts, device="cuda", conf=conf, stats=stats, ingested=ingested)
        wall = time.perf_counter() - t0
        launches = _launches()
        for ans in (warm, got):
            check(ans, oracle)
        assert stats["mode"] == mode, stats
        assert launches["partition_histogram"] == n_parts, (
            f"{query}-mesh ({mode}) launched K2 {launches['partition_histogram']} times, "
            f"not once per source shard ({n_parts}): {launches}")
        if query == "q93":
            assert launches["murmur3_pmod"] > 0, f"q93-mesh ({mode}) launched K1 no time"
        answers[mode] = got
        rows = data.fact_rows()
        print(f"{query}-mesh exchange.mode={mode}: {rows} fact rows, P={n_parts}, wall "
              f"{wall:.4f} s (map {stats['map_s']:.4f} s, exchange {stats['exchange_s']:.4f} s, "
              f"reduce {stats['reduce_s']:.4f} s"
              + (f", collect {stats['collect_s']:.4f} s" if "collect_s" in stats else "")
              + f"), slot_cap {stats['slot_cap']}, est bytes per shard "
              f"{stats['est_bytes_per_shard']}, coalesced {stats['coalesced_groups']}, peak "
              f"device memory {stats['peak_bytes'] / 2**30:.3f} GiB, launches {launches}",
              flush=True)
        print(f"  {query}-mesh routing matrix [src][dst] (live rows): {stats['routing']}",
              flush=True)
        if query == "q3":
            for name in ("bitonic_sort", "bitonic_merge"):
                assert launches[name] > 0, f"q3-mesh ({mode}) launched {name} no time"
            assert sort_checks, f"q3-mesh ({mode}): no collect sort was recorded"
        out[mode] = {"wall_s": wall, "rows_per_s": rows / wall, **stats, "launches": launches,
                     "sort_checks": sort_checks}
    # the two transports agree with each other
    a, b = answers["mesh"], answers["file"]
    for k in a:
        if k == "s":
            _assert_close(a[k], b[k])
        else:
            assert _np_equal(a[k], b[k]), (query, k)
    return out


def profile_q42(ingested: dict) -> dict:
    """One more q42 run under torch.profiler (``profile_run``), plus the
    operator metric tree's host timers."""
    from auron_tpu_torch.models import tpcds
    from auron_tpu_torch.runtime.task import run_task

    stats: dict = {}

    def run():
        batches, snap = run_task(tpcds.q42_exec_tree(), dict(ingested), device="cuda")
        tpcds.collect(batches)
        tpcds.add_timers(stats, snap)

    out = profile_run("q42", run)
    out["operator_host_ms"] = {k: v * 1e3 for k, v in stats["timers"].items()}
    _print_timers("q42", stats)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=8.0, help="scale factor (default 8)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one q42, q93 and q3 run (device busy share, top kernels)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result", file=sys.stderr)
        return 2
    from auron_tpu_torch.ops import cuda_build

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, cuda {torch.version.cuda})", flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build_s = cuda_build.build_all()
    print(f"built {sorted(build_s)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {build_s})", flush=True)
    for name, log in cuda_build.BUILD_LOG.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)

    # 3. kernels against their plain versions
    checks = check_kernels(args.seed)
    checks["murmur3_pmod"] = check_partition_kernel(args.seed)
    checks["partition_histogram"] = check_histogram_kernel(args.seed)
    timing = time_kernels(args.seed)
    timing["murmur3_pmod"] = time_partition_kernel(args.seed)
    timing["partition_histogram"] = time_histogram_kernel(args.seed)

    # 4. the data, once; q42-class end to end
    from auron_tpu_torch.models import tpcds

    t0 = time.perf_counter()
    data = tpcds.generate(args.sf, args.seed)
    t_gen = time.perf_counter() - t0
    q42, ingested = run_q42(data, args.sf, t_gen)
    if args.profile:
        q42["profile"] = profile_q42(ingested)
    del ingested

    # 5-6. the two-stage queries over one 4-partition ingest of the fact table
    t0 = time.perf_counter()
    fact = tpcds.to_batches(data.store_sales, 4, device="cuda")
    torch.cuda.synchronize()
    print(f"fact table in 4 partitions on the card in {time.perf_counter() - t0:.2f} s",
          flush=True)
    q93 = run_q93(data, fact)
    q3 = run_q3(data, fact)
    if args.profile:
        q93["profile"] = profile_run("q93", lambda: tpcds.run_q93_class(
            device="cuda", ingested=tpcds.ingest_q93(data, 4, device="cuda", fact=fact)))
        q3["profile"] = profile_run("q3", lambda: tpcds.run_q3_class(
            device="cuda", ingested=tpcds.ingest_q3(data, 4, device="cuda", fact=fact)))

    # 7. the same queries through the planned-exchange driver, P = 4
    q93_mesh = run_mesh("q93", data, fact)
    q3_mesh = run_mesh("q3", data, fact)
    if args.profile:
        for mode in ("mesh", "file"):
            conf = {"exchange.mode": mode}
            q93_mesh[mode]["profile"] = profile_run(f"q93-mesh ({mode})", lambda: (
                tpcds.run_q93_mesh(device="cuda", conf=conf, ingested=tpcds.ingest_q93(
                    data, 4, device="cuda", fact=fact))))
            q3_mesh[mode]["profile"] = profile_run(f"q3-mesh ({mode})", lambda: (
                tpcds.run_q3_mesh(device="cuda", conf=conf, ingested=tpcds.ingest_q3(
                    data, 4, device="cuda", fact=fact))))

    # the collect sorts of q3-mesh went through K3/K4 at their own shapes
    checks["q3_mesh_collect_sorts"] = {m: q3_mesh[m]["sort_checks"] for m in q3_mesh}
    sort_err = max(s["max_abs_err"] for m in q3_mesh for s in q3_mesh[m]["sort_checks"])
    for name in ("bitonic_sort", "bitonic_merge"):
        checks["max_abs_err"][name] = max(checks["max_abs_err"][name], sort_err)
    kernels = []
    for name, source, replaces, launches in (
        ("bitonic_sort", "auron_tpu_torch/csrc/bitonic.cu", "auron_tpu/ops/bitonic.py:145",
         q42["launches"]["bitonic_sort"]),
        ("bitonic_merge", "auron_tpu_torch/csrc/bitonic.cu", "auron_tpu/ops/bitonic.py:176",
         q42["launches"]["bitonic_merge"]),
        ("murmur3_pmod", "auron_tpu_torch/csrc/partition.cu",
         "auron_tpu/ops/pallas_kernels.py:26", q93["launches"]["murmur3_pmod"]),
        ("partition_histogram", "auron_tpu_torch/csrc/partition.cu",
         "auron_tpu/ops/pallas_kernels.py:78",
         q93_mesh["mesh"]["launches"]["partition_histogram"]),
    ):
        t = timing[name]
        err = (checks[name]["max_abs_err"] if name in ("murmur3_pmod", "partition_histogram")
               else checks["max_abs_err"][name])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    os.makedirs(os.path.join(REPO_DIR, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO_DIR, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi, "build_s": build_s, "checks": checks,
                   "timing": timing, "q42": q42, "q93": q93, "q3": q3, "q93_mesh": q93_mesh,
                   "q3_mesh": q3_mesh, "kernels": kernels},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
