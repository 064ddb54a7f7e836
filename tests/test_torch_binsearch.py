"""The port's vectorised binary search (``auron_tpu_torch/ops/binsearch.py``)
against ``auron_tpu.ops.binsearch`` on the same inputs: one key word and
several, duplicates, a dynamic live count with unsorted garbage past it, and
words with the top bit set (uint64 words ride as int64 bit patterns, so a
signed search would put them first). Exact: the answers are indices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auron_tpu.ops import binsearch as jbs
from auron_tpu.ops import segments as jseg

from auron_tpu_torch.ops import binsearch as pbs
from auron_tpu_torch.ops import segments as pseg


def _words(rng, n: int, k: int, top_bit: bool, dup: bool) -> np.ndarray:
    """[n, k] uint64 rows sorted lexicographically (unsigned)."""
    hi = (1 << 64) - 1 if top_bit else (1 << 20)
    pool = rng.integers(0, hi, size=(max(n // 4, 1) if dup else n, k), dtype=np.uint64,
                        endpoint=True)
    rows = pool[rng.integers(0, len(pool), n)] if dup else pool
    order = np.lexsort(tuple(rows[:, j] for j in reversed(range(k))))
    return rows[order]


def _both(fn_j, fn_p, sorted_rows, queries, n, dyn: bool):
    sj = [jnp.asarray(sorted_rows[:, j]) for j in range(sorted_rows.shape[1])]
    qj = [jnp.asarray(queries[:, j]) for j in range(queries.shape[1])]
    sp = [torch.from_numpy(sorted_rows[:, j].view(np.int64).copy())
          for j in range(sorted_rows.shape[1])]
    qp = [torch.from_numpy(queries[:, j].view(np.int64).copy()) for j in range(queries.shape[1])]
    if dyn:
        want = np.asarray(fn_j(sj, qj, jnp.int32(n)))
        got = fn_p(sp, qp, torch.tensor(n)).numpy()
    else:
        want = np.asarray(fn_j(sj, qj, n))
        got = fn_p(sp, qp, n).numpy()
    return got, want


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("top_bit", [False, True])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("dyn", [False, True])
def test_bounds_equal_reference(k, top_bit, dup, dyn):
    rng = np.random.default_rng(7 + k)
    cap, n = 256, 200
    rows = _words(rng, cap, k, top_bit, dup)
    # the slots past n hold garbage (not sorted): the search must not read them
    rows[n:] = rng.integers(0, (1 << 64) - 1, size=(cap - n, k), dtype=np.uint64,
                            endpoint=True)
    queries = np.concatenate([
        rows[rng.integers(0, n, 100)],  # present keys (duplicates included)
        rng.integers(0, (1 << 64) - 1, size=(60, k), dtype=np.uint64, endpoint=True),
        np.full((4, k), (1 << 64) - 1, dtype=np.uint64),  # the dead-slot sentinel
        np.zeros((4, k), dtype=np.uint64),
    ])
    for fj, fp in ((jbs.lower_bound_dyn if dyn else jbs.lower_bound,
                    pbs.lower_bound_dyn if dyn else pbs.lower_bound),
                   (jbs.upper_bound_dyn if dyn else jbs.upper_bound,
                    pbs.upper_bound_dyn if dyn else pbs.upper_bound)):
        got, want = _both(fj, fp, rows, queries, n, dyn)
        assert got.tolist() == want.tolist(), (fj.__name__, k, top_bit, dup)


def test_empty_and_all_dead():
    q = np.array([[0], [5], [(1 << 64) - 1]], dtype=np.uint64)
    for n in (0,):
        rows = np.full((8, 1), (1 << 64) - 1, dtype=np.uint64)
        got, want = _both(jbs.lower_bound, pbs.lower_bound, rows, q, n, False)
        assert got.tolist() == want.tolist() == [0, 0, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_rank_order_equals_reference(seed):
    """Two back-to-back fingerprint-sorted runs, dead slots at UINT64_MAX,
    equal fingerprints across the runs: the merge permutation equals the
    reference's and is the stable sort of the concatenation."""
    rng = np.random.default_rng(seed)
    cap_a, cap_b = 128, 256
    runs = []
    for cap in (cap_a, cap_b):
        live = rng.integers(1, cap)
        fp = np.sort(rng.choice(np.concatenate([
            rng.integers(0, 1 << 64, 40, dtype=np.uint64, endpoint=False),
            np.array([3, 1 << 63, (1 << 64) - 2], dtype=np.uint64)]), live))
        runs.append(np.concatenate([fp, np.full(cap - live, (1 << 64) - 1, np.uint64)]))
    fp = np.concatenate(runs)
    sel = fp != np.uint64((1 << 64) - 1)
    want = np.asarray(jseg.merge_rank_order(jnp.asarray(fp), jnp.asarray(sel), cap_a))
    got = pseg.merge_rank_order(torch.from_numpy(fp.view(np.int64).copy()), cap_a).numpy()
    assert got.tolist() == want.tolist()
    assert got.tolist() == np.argsort(fp, kind="stable").tolist()
