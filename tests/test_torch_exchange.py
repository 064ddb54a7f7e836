"""The port's one-card row mover against auron_tpu's ``pid_exchange_step``
on a 4-device CPU mesh, shard by shard and bit for bit: received value,
validity and sel arrays and the overflow count, for random, fully skewed,
all-dead and overflowing inputs.

Slice 22: the step functions against the JAX steps on the tests' 8-device
CPU mesh, the four cases of ``tests/test_exchange.py`` with the same numpy
inputs: keys, counts, validity and overflow exact; sums exact on
integer-valued float64 draws and within rel 1e-12 on normal draws (the JAX
package sums a group in its own order); mixed payload dtypes bit for bit; a
forced overflow. Also the broadcast halves and the AQE statistics of
``parallel/broadcast.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from auron_tpu.ops import hashing as JH
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


# ---- slice 22: the step functions on the 8-device mesh --------------------------

P8 = 8


@pytest.fixture(scope="module")
def jmesh8():
    return jmake_mesh(P8)


def _jax_run(step, mesh, *arrays):
    return jax.device_get(step(*(shard_rows(mesh, jnp.asarray(a)) for a in arrays)))


def _port_run(step, *arrays):
    return step(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))


def _assert_agg_equal(got, want, exact_sums: bool):
    fk, fs, fc, fv, overflow = (np.asarray(w) for w in want)
    gk, gs, gc, gv, gov = got
    assert int(gov) == int(overflow)
    np.testing.assert_array_equal(gv.numpy(), fv)
    np.testing.assert_array_equal(gk.numpy(), fk)
    np.testing.assert_array_equal(gc.numpy(), fc.astype(np.int64))
    if exact_sums:
        np.testing.assert_array_equal(gs.numpy(), fs)
    else:
        np.testing.assert_allclose(gs.numpy(), fs, rtol=1e-12, atol=0)


@pytest.mark.parametrize("draw", ("normal", "integer"))
def test_sharded_agg_exchange_matches_jax_and_pandas(jmesh8, draw):
    cap = 256
    rng = np.random.default_rng(7)
    keys = rng.integers(-20, 40, (P8, cap)).astype(np.int64)
    vals = (rng.normal(size=(P8, cap)) if draw == "normal"
            else rng.integers(-10**6, 10**6, (P8, cap)).astype(np.float64))
    sel = rng.random((P8, cap)) < 0.9
    want = _jax_run(jex.sharded_agg_exchange_step(jmesh8, slot_cap=cap), jmesh8, keys, vals, sel)
    got = _port_run(pex.sharded_agg_exchange_step(make_mesh(P8, device="cpu"), slot_cap=cap),
                     keys, vals, sel)
    _assert_agg_equal(got, want, exact_sums=draw == "integer")
    fk, fs, fc, fv, _ = (t.numpy() if isinstance(t, torch.Tensor) else t for t in got)
    found = {}
    for p in range(P8):
        for key, sm, cnt in zip(fk[p][fv[p]], fs[p][fv[p]], fc[p][fv[p]]):
            assert key not in found, "group split across shards"
            found[int(key)] = (float(sm), int(cnt))
    df = pd.DataFrame({"k": keys.reshape(-1), "v": vals.reshape(-1), "sel": sel.reshape(-1)})
    oracle = df[df.sel].groupby("k").agg(s=("v", "sum"), c=("v", "size"))
    assert set(found) == set(oracle.index.tolist())
    for key, (sm, cnt) in found.items():
        assert cnt == oracle.loc[key, "c"]
        assert sm == pytest.approx(oracle.loc[key, "s"], rel=1e-9)


def test_exchange_routing_is_spark_exact(jmesh8):
    """Each group's owner is pmod(murmur3(key), P), the file shuffle's."""
    cap = 128
    keys = np.arange(P8 * cap, dtype=np.int64).reshape(P8, cap) % 97
    vals = np.ones((P8, cap))
    sel = np.ones((P8, cap), bool)
    want = _jax_run(jex.sharded_agg_exchange_step(jmesh8, slot_cap=cap), jmesh8, keys, vals, sel)
    got = _port_run(pex.sharded_agg_exchange_step(make_mesh(P8, device="cpu"), slot_cap=cap),
                     keys, vals, sel)
    _assert_agg_equal(got, want, exact_sums=True)
    fk, _, _, fv, _ = got
    for p in range(P8):
        live = fk[p][fv[p]].numpy()
        owners = np.asarray(JH.pmod(JH.murmur3_i64(jnp.asarray(live), jnp.uint32(42))
                                    .view(jnp.int32), P8))
        assert len(live) and (owners == p).all()


def test_exchange_overflow_detection(jmesh8):
    """A slot_cap below the rows a destination gets raises the count, the
    JAX step's count."""
    cap = 128
    keys = np.arange(P8 * cap, dtype=np.int64).reshape(P8, cap)
    vals = np.ones((P8, cap))
    sel = np.ones((P8, cap), bool)
    want = _jax_run(jex.sharded_agg_exchange_step(jmesh8, slot_cap=4), jmesh8, keys, vals, sel)
    got = _port_run(pex.sharded_agg_exchange_step(make_mesh(P8, device="cpu"), slot_cap=4),
                     keys, vals, sel)
    assert int(got[-1]) == int(want[-1]) > 0
    _assert_agg_equal(got, want, exact_sums=True)


@pytest.mark.parametrize("n_keys", (1, 2))
def test_generic_batch_exchange_mixed_dtypes(jmesh8, n_keys):
    """Any column set rides the exchange: every output equals the JAX
    step's bit for bit (one key routes by K1's plain version, two by the
    chained murmur3)."""
    cap = 128
    rng = np.random.default_rng(51)
    keys = [rng.integers(0, 30, (P8, cap)).astype(np.int64) for _ in range(n_keys)]
    payload = {"f": rng.normal(size=(P8, cap)),
               "i": rng.integers(0, 100, (P8, cap)).astype(np.int32),
               "m": rng.random((P8, cap)) < 0.8}
    sel = rng.random((P8, cap)) < 0.9
    jstep = jex.batch_exchange_step(jmesh8, slot_cap=cap, n_hash_cols=n_keys)
    wk, wpay, wsel, wov = jax.device_get(jstep(
        tuple(shard_rows(jmesh8, jnp.asarray(k)) for k in keys),
        {k: shard_rows(jmesh8, jnp.asarray(v)) for k, v in payload.items()},
        shard_rows(jmesh8, jnp.asarray(sel))))
    pstep = pex.batch_exchange_step(make_mesh(P8, device="cpu"), slot_cap=cap,
                                    n_hash_cols=n_keys)
    gk, gpay, gsel, gov = pstep(tuple(torch.from_numpy(k) for k in keys),
                                {k: torch.from_numpy(v) for k, v in payload.items()},
                                torch.from_numpy(sel))
    assert int(gov) == int(wov) == 0
    np.testing.assert_array_equal(gsel.numpy(), np.asarray(wsel).reshape(P8, -1))
    for g, w in zip(gk, wk):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(P8, -1))
    assert sorted(gpay) == sorted(wpay)
    for k in payload:
        np.testing.assert_array_equal(gpay[k].numpy(), np.asarray(wpay[k]).reshape(P8, -1))
    assert int(gsel.sum()) == int(sel.sum())
    with pytest.raises(ValueError, match="key columns"):
        pstep(tuple(torch.from_numpy(k) for k in keys) * 2, {}, torch.from_numpy(sel))


def test_group_sum_matches_jax():
    """The per-shard group sum: keys in the unsigned order of their bits
    (negative keys last), the slots past the last group as the JAX
    function leaves them."""
    rng = np.random.default_rng(3)
    keys = rng.integers(-2**62, 2**62, 300).astype(np.int64)
    keys[rng.random(300) < 0.5] = 7
    vals = rng.integers(-1000, 1000, 300).astype(np.float64)
    sel = rng.random(300) < 0.7
    want = jax.device_get(jex._group_sum_i64(jnp.asarray(keys), jnp.asarray(vals),
                                             jnp.asarray(sel)))
    got = pex._group_sum_i64(torch.from_numpy(keys), torch.from_numpy(vals),
                             torch.from_numpy(sel))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    empty = pex._group_sum_i64(*(torch.from_numpy(a[:0]) for a in (keys, vals, sel)))
    assert all(t.numel() == 0 for t in empty)
    assert pex.ExchangeResult._fields == jex.ExchangeResult._fields


# ---- the broadcast halves and the AQE statistics --------------------------------


def test_collect_ipc_round_trip_and_map_output_stats(tmp_path):
    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exec.basic import ResourceScanExec
    from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.exprs.ir import col
    from auron_tpu_torch.parallel.broadcast import (
        batches_from_ipc, collect_ipc, map_output_sizes, map_output_stats,
    )
    from torch_carry import rows

    schema = T.Schema((T.Field("k", T.INT64, True), T.Field("s", T.STRING, True),
                       T.Field("f", T.FLOAT64, False)))
    rng = np.random.default_rng(9)
    parts = []
    for n in (300, 0, 41):
        valid = rng.random(n) < 0.8
        parts.append([Batch.from_numpy(
            [rng.integers(0, 50, n), rng.choice(np.array(["a", "bb", "ccc"]), n),
             rng.normal(size=n)], schema, [valid, ~valid, None], device="cpu")])
    scan = ResourceScanExec(schema, "src")
    blocks = collect_ipc(scan, partitions=[0, 1, 2], device="cpu", resources={"src": parts})
    assert len(blocks) == 2  # the empty partition yields no block
    got = batches_from_ipc(blocks, schema, device="cpu")
    assert rows(got) == rows([b for p in parts for b in p])

    index_files = []
    for p, batches in enumerate(parts):
        d, i = str(tmp_path / f"m{p}.data"), str(tmp_path / f"m{p}.index")
        w = ShuffleWriterExec(ResourceScanExec(schema, "src"), HashPartitioning([col(0)], 4),
                              d, i)
        from auron_tpu_torch.exec.base import ExecutionContext

        list(w.execute(p, ExecutionContext(partition_id=p, resources={"src": parts},
                                           device="cpu")))
        index_files.append(i)
    sizes = map_output_sizes(index_files, 4)
    np.testing.assert_array_equal(map_output_stats(index_files), sizes.sum(axis=0))
    assert sizes[1].sum() == 0 and sizes.sum() > 0
    assert map_output_stats([]).shape == (0,)

