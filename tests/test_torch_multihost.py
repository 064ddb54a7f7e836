"""Slice 22: multi-process SPMD on ``torch.distributed``. Two port-only
worker processes (``tests/torch_spmd_worker.py``: gloo, 4 logical
partitions each, P = 8, on the CPU) run the reference's four multihost
cases (``tests/test_multihost.py``: the collective, the planned query, the
file exchange, the STRING group-by) plus a group-by whose shards see
different vocabularies. Each combined answer must equal the port's
one-process driver at P = 8 bit for bit (rows of every partition in
order, the routing matrix, the slot capacity), the JAX one-process
``MeshQueryDriver`` on the 8-device CPU mesh (run here, never in a worker)
and a pandas oracle. The two-process exchange collectives must equal their
one-process forms on the stacked input bit for bit, zero slots and dropped
rows included. ``exchange.mode=file`` without a shared work_dir raises the
reference's message, and no worker loads ``jax`` or ``auron_tpu``."""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import torch_spmd_worker as W
from auron_tpu import types as JT
from auron_tpu.columnar import Batch as JBatch
from auron_tpu.exprs.ir import col as jcol
from auron_tpu.parallel.mesh import make_mesh as jmake_mesh
from auron_tpu.parallel.mesh_driver import MeshQueryDriver as JDriver
from auron_tpu.plan import builders as JB
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.parallel import multihost
from auron_tpu_torch.parallel.broadcast import replicate_to_mesh
from auron_tpu_torch.parallel.exchange import (
    all_to_all_rows, batch_exchange_step, sharded_agg_exchange_step,
)
from auron_tpu_torch.parallel.mesh import Mesh, make_mesh
from auron_tpu_torch.parallel.mesh_driver import MeshQueryDriver
from auron_tpu_torch.utils.config import Configuration
from torch_carry import canon, rows

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_spmd_worker.py")
WORKER_TIMEOUT_S = 150


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both workers' results (every case in one launch), in rank order."""
    out = tmp_path_factory.mktemp("spmd")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, AURON_COORDINATOR=f"127.0.0.1:{port}", AURON_NUM_PROCS="2",
                   AURON_PROC_ID=str(r), OMP_NUM_THREADS="1")
        env.pop("AURON_DIST_BACKEND", None)
        procs.append(subprocess.Popen([sys.executable, WORKER, str(out)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"spmd workers hung; output so far: {logs}")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
        assert f"rank {r} ok" in log
    res = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


# ---- the exchange collectives -------------------------------------------------


def _stacked(x: dict, *names) -> list:
    return [torch.from_numpy(x[n]) for n in names]


def test_two_process_all_to_all_rows_is_the_one_process_relayout(ranks):
    x = W.collective_inputs()
    recv, rsel, overflow = all_to_all_rows(_stacked(x, "i64", "f64", "i32", "b"),
                                           torch.from_numpy(x["sel"]),
                                           torch.from_numpy(x["pid"]), W.P, W.SLOT_CAP)
    assert int(overflow) > 0  # the slots drop rows
    assert not rsel.all()  # and leave empty slots
    for r, res in enumerate(ranks):
        got, gsel, gov = res["collectives"]["a2a"]
        rows_r = slice(r * W.L, (r + 1) * W.L)
        assert gov == int(overflow)
        np.testing.assert_array_equal(gsel, rsel[rows_r].numpy())
        for g, w in zip(got, recv):
            assert g.dtype == w.numpy().dtype
            # bit for bit, the zero fill of empty slots included
            np.testing.assert_array_equal(g.view(np.uint8), w[rows_r].numpy().view(np.uint8))


def test_two_process_steps_equal_their_stacked_form(ranks):
    x = W.collective_inputs()
    mesh = make_mesh(W.P, device="cpu")
    agg = sharded_agg_exchange_step(mesh, 2 * W.CAP)(*_stacked(x, "keys", "vals", "sel"))
    (rk,), pay, bsel, bov = batch_exchange_step(mesh, W.CAP)(
        (torch.from_numpy(x["keys"]),),
        {"f": torch.from_numpy(x["f64"]), "i": torch.from_numpy(x["i32"])},
        torch.from_numpy(x["sel"]))
    batch = (rk, pay["f"], pay["i"], bsel, bov)
    for r, res in enumerate(ranks):
        rows_r = slice(r * W.L, (r + 1) * W.L)
        for name, want in (("agg", agg), ("batch", batch)):
            got = res["collectives"][name]
            assert got[-1] == int(want[-1]) == 0
            for g, w in zip(got[:-1], want[:-1]):
                np.testing.assert_array_equal(g.view(np.uint8),
                                              w[rows_r].numpy().view(np.uint8))


def test_replicate_to_mesh_broadcasts_rank_zeros_batch(ranks):
    build = W.parts_of(W.dict_data(), W.STR_SCHEMA)[2][0]
    want = list(zip(*build.to_pydict().values()))
    for res in ranks:
        assert res["collectives"]["replicated"] == want
    # one process: the batch on the mesh's device
    got = replicate_to_mesh(build, make_mesh(W.P, device="cpu"))
    assert list(zip(*got.to_pydict().values())) == want


# ---- the planned queries --------------------------------------------------------


def _one_process(name: str):
    schema, data, conf = W.CASES[name]
    driver = MeshQueryDriver(make_mesh(W.P, device="cpu"), Configuration(dict(conf)))
    outs = driver.run(W.group_plan(schema), {"fact": W.parts_of(data(), schema)})
    return W.pieces_of(outs), W.stats_of(driver)


def _jax_rows(name: str) -> list:
    """The JAX package's one-process driver over the same data, P = 8."""
    schema, data, conf = W.CASES[name]
    df = pd.DataFrame(data())
    per = (len(df) + W.P - 1) // W.P
    parts = [[JBatch.from_arrow(pa.RecordBatch.from_pandas(df.iloc[p * per:(p + 1) * per],
                                                           preserve_index=False))]
             for p in range(W.P)]
    jt = JT.STRING if schema[0].dtype.kind.name == "STRING" else JT.INT64
    jschema = JT.Schema((JT.Field(schema.names[0], jt, False), JT.Field("v", JT.INT64, False)))
    scan = JB.memory_scan(jschema, "fact")
    partial = JB.hash_agg(scan, [(jcol(0), schema.names[0])],
                          [("sum", jcol(1), "s"), ("count_star", None, "c")], "partial")
    ex = JB.mesh_exchange(partial, JB.hash_partitioning([jcol(0)], W.P), "ex0")
    final = JB.hash_agg(ex, [(jcol(0), schema.names[0])],
                        [("sum", jcol(1), "s"), ("count", jcol(2), "c")], "final")
    jconf = {k: v for k, v in conf.items() if k == "exchange.mode"}
    out = JDriver(jmake_mesh(W.P), conf=JConf(jconf)).run(final, {"fact": parts})
    return rows([b for part in out for b in part])


def _oracle(name: str) -> list:
    df = pd.DataFrame(W.CASES[name][1]())
    key = df.columns[0]
    want = df.groupby(key).agg(s=("v", "sum"), c=("v", "size")).reset_index()
    return [(k, int(s), int(c)) for k, s, c in want.itertuples(index=False)]


@pytest.mark.parametrize("name", list(W.CASES))
def test_two_process_plan_equals_one_process_and_jax(ranks, name):
    want_pieces, want_stats = _one_process(name)
    got_pieces = {}
    for r, res in enumerate(ranks):
        assert res["local_parts"] == list(range(r * W.L, (r + 1) * W.L))
        assert set(res[name]["pieces"]) <= set(res["local_parts"])
        got_pieces.update(res[name]["pieces"])
        (st,), (ws,) = res[name]["stats"], want_stats
        assert st["mode"] == ws["mode"] == W.CASES[name][2]["exchange.mode"]
        np.testing.assert_array_equal(st["rows"], ws["rows"])
        assert st["slot_cap"] == ws["slot_cap"]
    # bit for bit: every partition's rows, in order
    assert got_pieces == want_pieces
    combined = canon([r for p in sorted(got_pieces) for r in got_pieces[p]])
    keys = [r[0] for r in combined]
    assert len(keys) == len(set(keys)), "a group split across processes"
    assert combined == canon(_jax_rows(name)) == canon(_oracle(name))


def test_file_mode_without_shared_work_dir_raises_reference_message(ranks):
    for res in ranks:
        assert res["unshared"] is not None and res["unshared"].startswith(
            "exchange.mode=file in SPMD mode requires a SHARED auron.work_dir "
            "(capability probe failed: peers cannot see this process's files)")


def test_workers_load_no_jax_and_no_reference_package(ranks):
    for res in ranks:
        assert res["foreign_modules"] == []


# ---- one process -----------------------------------------------------------------


def test_multihost_is_a_no_op_without_the_env(monkeypatch):
    monkeypatch.delenv("AURON_COORDINATOR", raising=False)
    assert multihost.initialize_from_env(device="cpu") is False
    assert multihost.process_info() == (0, 1) and multihost.backend() is None
    with pytest.raises(RuntimeError, match="not initialized"):
        multihost.global_mesh(4, device="cpu")
    mesh = make_mesh(8, device="cpu")
    assert (mesh.process_count, mesh.local_parts) == (1, list(range(8)))
    two = Mesh(8, torch.device("cpu"), process_index=1, process_count=2)
    assert two.local_parts == [4, 5, 6, 7] and two.parts_per_process == 4
    with pytest.raises(ValueError, match="split evenly"):
        Mesh(6, torch.device("cpu"), process_count=4)


def test_multi_process_mesh_needs_spmd():
    two = Mesh(8, torch.device("cpu"), process_index=0, process_count=2)
    with pytest.raises(ValueError, match="2 processes needs spmd=True"):
        MeshQueryDriver(two)
    assert MeshQueryDriver(two, spmd=True).local_parts == [0, 1, 2, 3]
