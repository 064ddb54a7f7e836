"""On-card tests of the port (marked ``cuda``; each skips without a GPU).

This file imports only torch, numpy and auron_tpu_torch, so it also runs
on a machine without JAX. There, skip the JAX-importing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from auron_tpu_torch.ops import bitonic as pb
from auron_tpu_torch.ops import partition_kernels as pk


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _planes(rng, NP, P, tie_range):
    out = np.empty((NP, P), dtype=np.int64)
    for p in range(NP - 1):
        out[p] = rng.integers(0, tie_range if p == 0 else 2**32, P, dtype=np.int64)
    out[NP - 1] = rng.permutation(P)
    return out


@pytest.mark.cuda
def test_kernels_match_plain_network_on_card():
    _need_card()
    rng = np.random.default_rng(1)
    for P in (1024, 2048, 16384, 1 << 18):
        for NP in (2, 3, 8):
            planes = torch.from_numpy(_planes(rng, NP, P, 5)).cuda()
            got = pb._run(planes, P, "pallas", merge=False)
            assert torch.equal(got, pb._network(planes, P))
            srt = got.clone()
            assert torch.equal(pb.bitonic_merge(srt, impl="pallas"), got)


@pytest.mark.cuda
def test_operand_sort_on_card_matches_plain_and_lexsort():
    """bitonic_sort on CUDA operands (int32 planes split and joined on the
    card) equals the plain network and the library lexsort."""
    _need_card()
    rng = np.random.default_rng(2)
    cap = 5000
    ops = (torch.from_numpy((rng.random(cap) < 0.2).astype(np.int64)).cuda(),
           torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, cap, dtype=np.int64)).cuda(),
           torch.from_numpy(rng.integers(-8, 8, cap, dtype=np.int64)).cuda(),
           torch.from_numpy(rng.integers(-5, 5, cap).astype(np.int32)).cuda(),
           torch.arange(cap, dtype=torch.int32, device="cuda"))
    kinds = ("u64", "u64", "i64", "i32", "i32")
    narrow = (True, False, False, False, False)
    got = pb.bitonic_sort(ops, impl="pallas", narrow=narrow, kinds=kinds)
    ref = pb.bitonic_sort(ops, impl="jnp", narrow=narrow, kinds=kinds)
    want = pb.lex_sorted(ops, kinds)
    for g, r, w in zip(got, ref, want):
        assert g.dtype == r.dtype and torch.equal(g, r) and torch.equal(g, w)


@pytest.mark.cuda
def test_q42_on_card_goes_through_the_kernels():
    """A small q42-class run on cuda equals the numpy oracle exactly in
    brand and order, and its SortExec launched both bitonic kernels."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.05, 42)
    before = dict(pb.LAUNCHES)
    got = tpcds.run_q42_class(data, device="cuda")
    want = tpcds.q42_class_oracle(data)
    np.testing.assert_array_equal(got["brand"], want["brand"])
    np.testing.assert_allclose(got["rev"], want["rev"], rtol=1e-9, atol=0)
    assert all(pb.LAUNCHES[k] > before[k] for k in before), (before, pb.LAUNCHES)


@pytest.mark.cuda
def test_partition_kernel_matches_plain_on_card():
    """K1 bit-equal to its plain version: negative hashes, INT64_MIN/MAX,
    0 and -1, NULL keys, one and non-power-of-two partition counts, ragged
    lengths."""
    _need_card()
    rng = np.random.default_rng(3)
    for n in (1, 255, 257, 100_003):
        keys = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True)
        keys[: min(n, 4)] = np.array([-(2**63), 2**63 - 1, 0, -1])[: min(n, 4)]
        k = torch.from_numpy(keys).cuda()
        valid = torch.from_numpy(rng.random(n) > 0.5).cuda()
        for n_parts in (1, 3, 4, 200, 4096):
            got = pk.partition_ids(k, valid, n_parts)
            assert torch.equal(got, pk.plain_partition_ids(k, valid, n_parts)), (n, n_parts)
            assert bool((got[~valid] == 42 % n_parts).all())


@pytest.mark.cuda
def test_two_stage_queries_on_card_go_through_k1():
    """Small q93- and q3-class runs on cuda equal their numpy oracles, and
    q93's shuffle writer launched K1."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.05, 42)
    before = pk.LAUNCHES["murmur3_pmod"]
    got = tpcds.run_q93_class(data, device="cuda")
    want = tpcds.q93_class_oracle(data)
    assert pk.LAUNCHES["murmur3_pmod"] > before
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["matched"], want["matched"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)
    q3 = tpcds.run_q3_class(data, device="cuda")
    o3 = tpcds.q3_class_oracle(data)
    np.testing.assert_array_equal(q3["i_brand_id"], o3["i_brand_id"])
    np.testing.assert_allclose(q3["s"], o3["s"], rtol=1e-9, atol=0)


@pytest.mark.cuda
def test_histogram_kernel_matches_plain_on_card():
    """K2 bit-equal to its plain version and numpy: out-of-range ids (-1,
    n_parts, INT32_MIN/MAX), dead rows, no sel, n = 0, one partition, and
    a count past the shared-memory branch."""
    _need_card()
    rng = np.random.default_rng(4)
    shared = pk.histogram_shared_parts()
    for n in (0, 1, 257, 100_003):
        for n_parts in (1, 2, 7, 4096, shared + 1):
            pids = rng.integers(-3, n_parts + 3, n).astype(np.int32)
            edges = np.array([-1, -(2**31), 2**31 - 1, n_parts], np.int32)[: min(n, 4)]
            pids[: len(edges)] = edges
            live = rng.random(n) < 0.6
            p, s = torch.from_numpy(pids).cuda(), torch.from_numpy(live).cuda()
            got = pk.partition_histogram(p, n_parts, s)
            assert torch.equal(got, pk.plain_partition_histogram(p, n_parts, s)), (n, n_parts)
            keep = live & (pids >= 0) & (pids < n_parts)
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          np.bincount(pids[keep], minlength=n_parts))
            assert torch.equal(pk.partition_histogram(p, n_parts),
                               pk.plain_partition_histogram(p, n_parts))


@pytest.mark.cuda
def test_mesh_driver_queries_on_card_go_through_k2():
    """q93- and q3-class through the planned-exchange driver on 4 logical
    partitions, both transports: equal to the numpy oracles, and K2
    launched once per source shard."""
    _need_card()
    from auron_tpu_torch.models import tpcds

    data = tpcds.generate(0.05, 42)
    w93, w3 = tpcds.q93_class_oracle(data), tpcds.q3_class_oracle(data)
    for mode in ("mesh", "file"):
        before = pk.LAUNCHES["partition_histogram"]
        got = tpcds.run_q93_mesh(data, conf={"exchange.mode": mode})
        assert pk.LAUNCHES["partition_histogram"] - before == 4
        np.testing.assert_array_equal(got["rows"], w93["rows"])
        np.testing.assert_array_equal(got["matched"], w93["matched"])
        np.testing.assert_allclose(got["s"], w93["s"], rtol=1e-9, atol=0)
        q3 = tpcds.run_q3_mesh(data, conf={"exchange.mode": mode})
        np.testing.assert_array_equal(q3["d_year"], w3["d_year"])
        np.testing.assert_array_equal(q3["i_brand_id"], w3["i_brand_id"])
        np.testing.assert_allclose(q3["s"], w3["s"], rtol=1e-9, atol=0)
