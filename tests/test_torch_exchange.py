"""The port's one-card row mover against auron_tpu's ``pid_exchange_step``
on a 4-device CPU mesh, shard by shard and bit for bit: received value,
validity and sel arrays and the overflow count, for random, fully skewed,
all-dead and overflowing inputs."""

import numpy as np
import pytest
import torch

from auron_tpu.parallel import exchange as jex
from auron_tpu.parallel.mesh import make_mesh as jmake_mesh
from auron_tpu.parallel.mesh import shard_rows

from auron_tpu_torch.parallel import exchange as pex
from auron_tpu_torch.parallel.mesh import PARTITION_AXIS, make_mesh

P = 4


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(P)


def _inputs(case: str, cap: int, seed: int):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-(2**62), 2**62, (P, cap))
    price = rng.normal(0, 100, (P, cap))
    valid = rng.random((P, cap)) < 0.8
    if case == "random":
        pids, sel = rng.integers(0, P, (P, cap)), rng.random((P, cap)) < 0.7
    elif case == "skewed":
        pids, sel = np.full((P, cap), 2), np.ones((P, cap), bool)
    else:  # all dead
        pids, sel = rng.integers(0, P, (P, cap)), np.zeros((P, cap), bool)
    return (vals.astype(np.int64), price, valid), sel, pids.astype(np.int32)


def _jax_step(jmesh, arrays, sel, pids, slot_cap):
    step = jex.pid_exchange_step(jmesh, slot_cap)
    recv, rsel, overflow = step(tuple(shard_rows(jmesh, a) for a in arrays),
                                shard_rows(jmesh, sel), shard_rows(jmesh, pids))
    return [np.asarray(r) for r in recv], np.asarray(rsel), int(overflow)


def _port_step(arrays, sel, pids, slot_cap):
    step = pex.pid_exchange_step(make_mesh(P, device="cpu"), slot_cap)
    recv, rsel, overflow = step([torch.from_numpy(a) for a in arrays], torch.from_numpy(sel),
                                torch.from_numpy(pids))
    return [r.numpy() for r in recv], rsel.numpy(), int(overflow)


@pytest.mark.parametrize("case", ["random", "skewed", "dead"])
@pytest.mark.parametrize("cap,slot_cap", [(256, 128), (1000, 1024), (1000, 4096)])
def test_pid_exchange_step_bit_equal_to_jax(jmesh, case, cap, slot_cap):
    arrays, sel, pids = _inputs(case, cap, cap + slot_cap)
    want_recv, want_sel, want_over = _jax_step(jmesh, arrays, sel, pids, slot_cap)
    got_recv, got_sel, got_over = _port_step(arrays, sel, pids, slot_cap)
    assert got_over == want_over
    assert got_sel.shape == want_sel.shape == (P, P * slot_cap)
    for p in range(P):  # shard by shard
        np.testing.assert_array_equal(got_sel[p], want_sel[p])
        for g, w in zip(got_recv, want_recv):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g[p], w[p])
    live = int(sel.sum())
    assert int(got_sel.sum()) + got_over == live


def test_slot_ranks_keep_row_order_within_destination():
    rng = np.random.default_rng(5)
    pids = rng.integers(0, P, (P, 300)).astype(np.int32)
    sel = rng.random((P, 300)) < 0.6
    ranks = pex._slot_ranks(torch.from_numpy(pids), torch.from_numpy(sel), P).numpy()
    for s in range(P):
        for d in range(P):
            rows = np.flatnonzero(sel[s] & (pids[s] == d))
            np.testing.assert_array_equal(ranks[s, rows], np.arange(len(rows)))


def test_mesh_shape_and_input_checks():
    mesh = make_mesh(P, device="cpu")
    assert mesh.shape == {PARTITION_AXIS: P}
    step = pex.pid_exchange_step(mesh, 128)
    x = torch.zeros((P + 1, 10), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\[4, cap\]"):
        step([x], torch.zeros((P + 1, 10), dtype=torch.bool), torch.zeros((P + 1, 10),
                                                                         dtype=torch.int32))
    with pytest.raises(ValueError, match="at least one partition"):
        make_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(P)  # the default device is cuda
