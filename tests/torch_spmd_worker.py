"""One process of the port's two-process SPMD tests
(``tests/test_torch_multihost.py``).

    AURON_COORDINATOR=127.0.0.1:<port> AURON_NUM_PROCS=2 AURON_PROC_ID=<r> \\
        python tests/torch_spmd_worker.py <out dir>

Joins the gloo group, builds the global mesh (4 logical partitions a
process, P = 8, on the CPU) and runs every case in turn: the exchange
collectives, the reference's planned query, its file exchange, its STRING
group-by, and ``exchange.mode=file`` over work_dirs the peers do not share.
Writes ``rank<r>.pkl`` with this process's answer pieces and stats. It
imports only ``auron_tpu_torch``; the data and plans below are shared with
the parent test, which runs them through the one-process drivers.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from auron_tpu_torch import types as T  # noqa: E402
from auron_tpu_torch.columnar.batch import Batch  # noqa: E402
from auron_tpu_torch.exprs.ir import col  # noqa: E402
from auron_tpu_torch.plan import builders as B  # noqa: E402

P = 8
L = 4
INT_SCHEMA = T.Schema((T.Field("k", T.INT64, False), T.Field("v", T.INT64, False)))
STR_SCHEMA = T.Schema((T.Field("cat", T.STRING, False), T.Field("v", T.INT64, False)))
CATS = np.array(["Books", "Home", "Electronics", "Music", "Sports", "Garden", "Toys"])
#: the exchange collectives' inputs: [P, CAP] rows, slots too small for the
#: hottest (source, destination) pairs, so rows drop
CAP = 96
SLOT_CAP = 12


def int_data(seed: int, n: int, kmax: int, vmax: int) -> dict:
    """The reference's integer group-by data (``tests/test_multihost.py``)."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, kmax, n).astype(np.int64),
            "v": rng.integers(-vmax, vmax, n).astype(np.int64)}


def dict_data() -> dict:
    """The reference's STRING group-by data (``tests/test_multihost.py``):
    every shard's dictionary lists the categories in its own order."""
    rng = np.random.default_rng(11)
    return {"cat": rng.choice(CATS, 4000), "v": rng.integers(-300, 300, 4000).astype(np.int64)}


def dict_subset_data(n: int = 4000) -> dict:
    """STRING keys where shard p sees only categories p, p + 1 and p + 2
    (mod 7): the processes' vocabularies differ, not just their order."""
    rng = np.random.default_rng(13)
    shard = np.arange(n) // ((n + P - 1) // P)
    return {"cat": CATS[(shard + rng.integers(0, 3, n)) % len(CATS)],
            "v": rng.integers(-300, 300, n).astype(np.int64)}


CASES = {
    "planned": (INT_SCHEMA, lambda: int_data(5, 6000, 61, 500), {"exchange.mode": "mesh"}),
    "file": (INT_SCHEMA, lambda: int_data(7, 5000, 37, 100),
             {"exchange.mode": "file", "exchange.coalesce.enable": "false"}),
    "dict": (STR_SCHEMA, dict_data, {"exchange.mode": "mesh"}),
    "dict_subsets": (STR_SCHEMA, dict_subset_data, {"exchange.mode": "mesh"}),
}


def parts_of(data: dict, schema: T.Schema, only=None) -> list[list[Batch]]:
    """The data in P contiguous partitions of one CPU batch each (empty
    outside ``only``)."""
    n = len(data[schema.names[0]])
    per = (n + P - 1) // P
    return [[Batch.from_numpy([data[f.name][p * per:(p + 1) * per] for f in schema], schema,
                              device="cpu")]
            if only is None or p in only else [] for p in range(P)]


def group_plan(schema: T.Schema, ex_id: str = "ex0"):
    """partial hash_agg -> mesh_exchange on the key -> final hash_agg."""
    scan = B.memory_scan(schema, "fact")
    partial = B.hash_agg(scan, [(col(0), schema.names[0])],
                         [("sum", col(1), "s"), ("count_star", None, "c")], "partial")
    ex = B.mesh_exchange(partial, B.hash_partitioning([col(0)], P), ex_id)
    return B.hash_agg(ex, [(col(0), schema.names[0])],
                      [("sum", col(1), "s"), ("count", col(2), "c")], "final")


def pieces_of(outs) -> dict:
    """{partition: live rows as tuples} of a driver run's filled partitions."""
    return {p: [r for b in bs for r in zip(*b.to_pydict().values())]
            for p, bs in enumerate(outs) if bs}


def stats_of(driver) -> list:
    return [{"mode": s.mode, "rows": s.rows, "slot_cap": s.slot_cap} for s in driver.stats]


def collective_inputs(seed: int = 3) -> dict:
    """Stacked [P, CAP] inputs of the exchange steps: mixed dtypes, dead
    rows, ids bunched on two partitions."""
    rng = np.random.default_rng(seed)
    return {
        "i64": rng.integers(-2**62, 2**62, (P, CAP)).astype(np.int64),
        "f64": rng.normal(size=(P, CAP)),
        "i32": rng.integers(-1000, 1000, (P, CAP)).astype(np.int32),
        "b": rng.random((P, CAP)) < 0.5,
        "sel": rng.random((P, CAP)) < 0.8,
        "pid": np.where(rng.random((P, CAP)) < 0.5, rng.integers(0, 2, (P, CAP)),
                        rng.integers(0, P, (P, CAP))).astype(np.int32),
        "keys": rng.integers(-50, 50, (P, CAP)).astype(np.int64),
        "vals": rng.normal(size=(P, CAP)),
    }


def _local(a: np.ndarray, rank: int) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a[rank * L:(rank + 1) * L]))


def run_collectives(mesh, rank: int) -> dict:
    """The row mover, both step functions and the broadcast on this rank's
    slice of the shared inputs."""
    from auron_tpu_torch.parallel import multihost
    from auron_tpu_torch.parallel.broadcast import replicate_to_mesh
    from auron_tpu_torch.parallel.exchange import (
        all_to_all_rows, batch_exchange_step, sharded_agg_exchange_step,
    )

    x = collective_inputs()
    arrays = [_local(x[k], rank) for k in ("i64", "f64", "i32", "b")]
    recv, rsel, overflow = all_to_all_rows(arrays, _local(x["sel"], rank),
                                           _local(x["pid"], rank), P, SLOT_CAP,
                                           multihost.data_group())
    out = {"a2a": ([r.numpy() for r in recv], rsel.numpy(), int(overflow))}
    fk, fs, fc, fv, ov = sharded_agg_exchange_step(mesh, 2 * CAP)(
        _local(x["keys"], rank), _local(x["vals"], rank), _local(x["sel"], rank))
    out["agg"] = tuple(t.numpy() for t in (fk, fs, fc, fv)) + (int(ov),)
    (rk,), pay, bsel, bov = batch_exchange_step(mesh, CAP)(
        (_local(x["keys"], rank),), {"f": _local(x["f64"], rank), "i": _local(x["i32"], rank)},
        _local(x["sel"], rank))
    out["batch"] = (rk.numpy(), pay["f"].numpy(), pay["i"].numpy(), bsel.numpy(), int(bov))
    build = parts_of(dict_data(), STR_SCHEMA)[2][0] if rank == 0 else None
    got = replicate_to_mesh(build, mesh)
    out["replicated"] = [r for r in zip(*got.to_pydict().values())]
    return out


def main(out_dir: str) -> None:
    from auron_tpu_torch.parallel import multihost
    from auron_tpu_torch.parallel.mesh_driver import MeshQueryDriver
    from auron_tpu_torch.utils.config import Configuration

    torch.set_num_threads(1)
    assert multihost.initialize_from_env(device="cpu", timeout_s=120.0), "no AURON_* env"
    rank, world = multihost.process_info()
    assert world == 2
    mesh = multihost.global_mesh(L, device="cpu")
    res: dict = {"local_parts": mesh.local_parts, "collectives": run_collectives(mesh, rank)}
    for name, (schema, data, conf) in CASES.items():
        work = os.path.join(out_dir, "shared_work") if name == "file" else None
        driver = MeshQueryDriver(mesh, Configuration(dict(conf)), work_dir=work, spmd=True)
        outs = driver.run(group_plan(schema),
                          {"fact": parts_of(data(), schema, only=mesh.local_parts)})
        res[name] = {"pieces": pieces_of(outs), "stats": stats_of(driver)}
    # exchange.mode=file over work_dirs the peers do not share: every rank
    # fails the probe alike and raises the reference's message
    driver = MeshQueryDriver(mesh, Configuration({"exchange.mode": "file"}),
                             work_dir=os.path.join(out_dir, f"own_work{rank}"), spmd=True)
    try:
        driver.run(group_plan(INT_SCHEMA), {"fact": parts_of(int_data(7, 5000, 37, 100),
                                                            INT_SCHEMA)})
        res["unshared"] = None
    except RuntimeError as e:
        res["unshared"] = str(e)
    multihost.barrier()
    multihost.shutdown()
    res["foreign_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                                    ("jax", "jaxlib", "auron_tpu"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    assert not res["foreign_modules"], res["foreign_modules"]
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
