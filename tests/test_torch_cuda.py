"""On-card tests of the port (marked ``cuda``; each skips without a GPU).

This file imports only torch, numpy and auron_tpu_torch, so it also runs
on a machine without JAX. There, skip the JAX-importing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from auron_tpu_torch.ops import bitonic as pb


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
