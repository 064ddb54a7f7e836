#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (auron_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full run: q42, q93 and q3-class at SF 8
    python3 chip_smoke.py --sf 0.5   # smaller end-to-end phases
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of one q42, q93, q3 run

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
   0 and -1 among the keys; time kernels, plain versions and library calls
   with CUDA events (bitonic at the q42 shape P = 16384, 8 planes; K1 at
   2^20 rows, 4 partitions);
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
7. print the kernel table as one JSON line, then the final status line.

Every launch count is set to 0 just before the timed run of a query and
read just after it; launches made to compare kernels are not counted.

Needs no network, no pyarrow, no pandas and no protobuf; imports nothing
of the JAX package. Exits with code 2 when no CUDA device is visible.
Detailed results also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
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


def _profiled_kernel_ms(fn, name: str, iters: int):
    """Mean device time of the kernels whose name holds ``name``, from
    torch.profiler over ``iters`` calls; None when the trace has none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if name in e.key:
            us = getattr(e, "self_device_time_total", None)
            total += us if us is not None else getattr(e, "self_cuda_time_total", 0)
            count += e.count
    return total / 1e3 / count if count else None


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
    """One more run under torch.profiler: device busy time (sum of kernel
    self times, one stream) against the wall, and the top kernels. Its
    launches are not counted in the kernel table."""
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
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append((e.key, us / 1e3, e.count))
    kernels.sort(key=lambda k: -k[1])
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
    import numpy as np
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
        assert out["k_null"].tolist() == oracle["k_null"].tolist(), (out, oracle)
        assert np.array_equal(out["rows"], oracle["rows"]), (out["rows"], oracle["rows"])
        assert np.array_equal(out["matched"], oracle["matched"]), (out, oracle)
        assert np.isfinite(out["s"]).all()
        np.testing.assert_allclose(out["s"], oracle["s"], rtol=1e-9, atol=0)
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
    import numpy as np
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
        assert len(out["s"]) == len(oracle["s"]) > 0 and np.isfinite(out["s"]).all()
        for k in ("d_year", "i_brand_id"):
            assert np.array_equal(out[k], oracle[k]), (k, out[k][:10], oracle[k][:10])
        np.testing.assert_allclose(out["s"], oracle["s"], rtol=1e-9, atol=0)
    rows = data.fact_rows()
    print(f"q3-class: {rows} fact rows, wall {wall:.4f} s (map stage {stats['map_s']:.4f} s, "
          f"reduce stage {stats['reduce_s']:.4f} s), shuffle bytes written "
          f"{stats['shuffle_bytes']}, launches {launches}, first row "
          f"({int(got['d_year'][0])}, {int(got['i_brand_id'][0])}, {float(got['s'][0]):.2f})",
          flush=True)
    _print_timers("q3", stats)
    return {"fact_rows": rows, "wall_s": wall, "rows_per_s": rows / wall, **stats,
            "launches": launches, "top": {k: v[:10].tolist() for k, v in got.items()}}


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
    timing = time_kernels(args.seed)
    timing["murmur3_pmod"] = time_partition_kernel(args.seed)

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

    kernels = []
    for name, source, replaces, launches in (
        ("bitonic_sort", "auron_tpu_torch/csrc/bitonic.cu", "auron_tpu/ops/bitonic.py:145",
         q42["launches"]["bitonic_sort"]),
        ("bitonic_merge", "auron_tpu_torch/csrc/bitonic.cu", "auron_tpu/ops/bitonic.py:176",
         q42["launches"]["bitonic_merge"]),
        ("murmur3_pmod", "auron_tpu_torch/csrc/partition.cu",
         "auron_tpu/ops/pallas_kernels.py:26", q93["launches"]["murmur3_pmod"]),
    ):
        t = timing[name]
        err = (checks["murmur3_pmod"]["max_abs_err"] if name == "murmur3_pmod"
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
                   "timing": timing, "q42": q42, "q93": q93, "q3": q3, "kernels": kernels},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
