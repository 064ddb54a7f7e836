#!/usr/bin/env python3
"""Where the time of one bitonic_cluster launch goes, on one GPU.

    python3 bitonic_ablation.py

Builds ``auron_tpu_torch/csrc/bitonic.cu`` as it is and in variants that
each leave one kind of substage out of ``bitonic_cluster`` (the result is
then not sorted: only the time counts), and prints the device time of one
sort and one merge launch (torch.profiler) of each build at the main
path's sort shapes: 16,384 x 8 (q42), 16,384 x 11 and 8,192 x 11 (q3-mesh,
mesh and file transports). A variant's time below the full kernel's is
what that kind of substage costs:

- ``no_shuffle``: the warp-shuffle substages (strides E .. 16E);
- ``no_register``: the substages inside a thread's registers (below E);
- ``no_tile_pass``: the shared-memory passes of a tile;
- ``no_cluster_pass``: the passes over other CTAs' shared memory, with
  their cluster barriers kept;
- ``no_cluster_barrier``: the cluster barrier after each of those passes.

The builds go to ``build/bitonic_ablation/`` (one nvcc each, started
together). Exits with code 2 when no CUDA device is visible.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO_DIR = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((16384, 8), (16384, 11), (8192, 11))

# (text in bitonic.cu, its replacement) per variant
VARIANTS = {
    "full": [],
    "no_shuffle": [("for (; j >= (unsigned)E; j >>= 1) {",
                    "for (j = (j >= (unsigned)E ? (unsigned)E / 2 : j); false;) {")],
    "no_register": [("if ((unsigned)jr > j) continue;", "continue;")],
    "no_tile_pass": [("for (; j >= 32u * E; j >>= (j >= 64u * E ? 2 : 1)) {",
                      "for (j = (j >= 32u * E ? 16u * E : j); false;) {")],
    "no_cluster_pass": [
        ("            cluster_pass<NP, 2>(cluster, s, T, tile0, j >> 1, k);", "            ;"),
        ("            cluster_pass<NP, 1>(cluster, s, T, tile0, j, k);", "            ;")],
    "no_cluster_barrier": [("""            cluster_pass<NP, 1>(cluster, s, T, tile0, j, k);
          cluster.sync();""", """            cluster_pass<NP, 1>(cluster, s, T, tile0, j, k);""")],
}


def build(out_dir: str) -> dict:
    from auron_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.SRC_DIR, "bitonic.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in bitonic.cu")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = lib
    return libs


def time_variant(lib_path: str, P: int, NP: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke
    from auron_tpu_torch.ops import bitonic
    from auron_tpu_torch.ops.uwords import i32_of_u32

    lib = ctypes.CDLL(lib_path)
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.auron_bitonic_prepare.argtypes = [ci, ci, ci, ci]
    lib.auron_bitonic_run.argtypes = [vp, ci, cll, ci, ci, ci, ctypes.POINTER(cll), ci, vp]
    plan = bitonic.sort_plan(NP, P)
    assert lib.auron_bitonic_prepare(NP, plan.tile, plan.cluster, plan.per_thread) > 0
    rng = np.random.default_rng(P + NP)
    host = chip_smoke._sweep_planes(rng, NP, P, "ties")
    x32 = i32_of_u32(torch.from_numpy(host).cuda()).contiguous()
    out = {}
    for mode, k_lo in (("sort", 2), ("merge", P)):
        desc = (ctypes.c_longlong * 4)(0, k_lo, P, 0)

        def run(desc=desc):
            rc = lib.auron_bitonic_run(
                ctypes.c_void_p(x32.data_ptr()), NP, P, plan.tile, plan.cluster,
                plan.per_thread, desc, 1, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            assert rc == 0, rc

        seq = chip_smoke._profiled_launches(run, 20)
        out[mode] = sum(ms for _, ms in seq) if seq else None
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bitonic_ablation: torch.cuda.is_available() is False; no result", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO_DIR)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build(os.path.join(REPO_DIR, "build", "bitonic_ablation"))
    for P, NP in SHAPES:
        full = None
        for name, lib in libs.items():
            r = time_variant(lib, P, NP)
            full = full or r
            print(f"P={P} NP={NP} {name:18s}: sort {r['sort']:.5f} ms (full minus this "
                  f"{full['sort'] - r['sort']:+.5f}), merge {r['merge']:.5f} ms (full minus this "
                  f"{full['merge'] - r['merge']:+.5f}) of device time", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
