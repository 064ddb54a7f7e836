"""Rows per partition id (K2): the port's plain version against numpy and
auron_tpu's Pallas kernel, bit for bit. The Pallas kernel runs in interpret
mode where this jaxlib supports it, and its body (``_histogram_kernel``)
always runs on host refs, as the JAX caller feeds it: ids of dead rows
blended to -1 and the vector padded with -1 to (rows, 128). The on-card
kernel checks are in test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auron_tpu.ops import pallas_kernels as jpk

from auron_tpu_torch.ops import partition_kernels as ppk
from torch_carry import HostRef

N_PARTS = (1, 2, 7, 200, 4096)
I32_EDGES = np.array([-1, -(2**31), 2**31 - 1], dtype=np.int32)


def _inputs(rng, n: int, n_parts: int, live_share: float):
    """Ids mostly in range, some just outside it, the int32 edges and
    n_parts itself among them; a sel mask with ``live_share`` live rows."""
    pids = rng.integers(-3, n_parts + 3, n).astype(np.int32)
    edges = np.concatenate([I32_EDGES, np.array([n_parts], np.int32)])
    k = min(n, len(edges))
    pids[:k] = edges[:k]
    sel = rng.random(n) < live_share
    return pids, sel


def _bincount(pids: np.ndarray, sel: np.ndarray, n_parts: int) -> np.ndarray:
    keep = sel & (pids >= 0) & (pids < n_parts)
    return np.bincount(pids[keep], minlength=n_parts).astype(np.int32)


def _pallas_body(pids: np.ndarray, sel: np.ndarray, n_parts: int) -> np.ndarray:
    """auron_tpu's K2 body on the (rows, 128) tile its wrapper builds."""
    live = np.where(sel, pids, -1)
    rows = max((len(live) + 127) // 128, 8)
    tile = np.full(rows * 128, -1, np.int32)
    tile[: len(live)] = live
    out = HostRef()
    jpk._histogram_kernel(HostRef(jnp.asarray(tile.reshape(rows, 128))), out, n_parts=n_parts)
    return np.asarray(out.v)


@pytest.mark.parametrize("n_parts", N_PARTS)
@pytest.mark.parametrize("n,live_share", [(1, 1.0), (1000, 0.5), (3000, 1.0), (2500, 0.0)])
def test_plain_histogram_matches_bincount_and_pallas_body(n, live_share, n_parts):
    rng = np.random.default_rng(n * 31 + n_parts)
    pids, sel = _inputs(rng, n, n_parts, live_share)
    want = _bincount(pids, sel, n_parts)
    got = ppk.plain_partition_histogram(torch.from_numpy(pids), n_parts, torch.from_numpy(sel))
    assert got.dtype == torch.int32 and got.shape == (n_parts,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_pallas_body(pids, sel, n_parts), want)
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(
        ppk.partition_histogram(torch.from_numpy(pids), n_parts, torch.from_numpy(sel)).numpy(),
        want)


@pytest.mark.parametrize("n_parts", N_PARTS)
def test_plain_histogram_without_sel_counts_every_in_range_id(n_parts):
    rng = np.random.default_rng(n_parts)
    pids, _ = _inputs(rng, 1777, n_parts, 1.0)
    want = _bincount(pids, np.ones(len(pids), bool), n_parts)
    np.testing.assert_array_equal(
        ppk.plain_partition_histogram(torch.from_numpy(pids), n_parts).numpy(), want)
    np.testing.assert_array_equal(_pallas_body(pids, np.ones(len(pids), bool), n_parts), want)


@pytest.mark.parametrize("n_parts", (1, 7))
def test_plain_histogram_matches_pallas_interpret(n_parts):
    """The Pallas kernel itself in interpret mode, where jaxlib supports it
    (the body test above runs either way)."""
    rng = np.random.default_rng(9)
    pids, sel = _inputs(rng, 5000, n_parts, 0.5)
    live = np.where(sel, pids, -1)
    try:
        want = np.asarray(jpk.partition_histogram_pallas(jnp.asarray(live), n_parts,
                                                         interpret=True))
    except NotImplementedError as e:
        pytest.skip(f"pallas interpret mode unavailable: {e}")
    got = ppk.plain_partition_histogram(torch.from_numpy(pids), n_parts, torch.from_numpy(sel))
    np.testing.assert_array_equal(got.numpy(), want)


def test_empty_input_gives_zeros():
    for n_parts in (1, 4):
        got = ppk.partition_histogram(torch.zeros(0, dtype=torch.int32), n_parts,
                                      torch.zeros(0, dtype=torch.bool))
        np.testing.assert_array_equal(got.numpy(), np.zeros(n_parts, np.int32))


def test_k2_wrapper_device_contract():
    """A CPU tensor runs the plain version and counts no launch; bad input
    to the kernel entry raises instead of falling back."""
    before = dict(ppk.LAUNCHES)
    pids = torch.arange(10, dtype=torch.int32)
    ppk.partition_histogram(pids, 4, torch.ones(10, dtype=torch.bool))
    assert ppk.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA int32"):
        ppk.launch_partition_histogram(pids, 4)
    with pytest.raises(ValueError, match="CUDA int32"):
        ppk.launch_partition_histogram(pids.to(torch.int64), 4)
    assert ppk.LAUNCHES == before
