"""Device group-by primitives: key words, sort-segmentation, reducers.

Port of ``auron_tpu/ops/segments.py``:

1. every group-key column becomes a canonical uint64 word (int64 carrier;
   0 for NULL) plus one packed null-bits word, so NULLs group together;
2. a stable sort clusters equal keys, dead rows (sel=0) last: either the
   full-word sort over ``(dead, *words, iota)`` (the bitonic kernels for
   ``device_impl`` jnp/pallas, else the library lexsort), or the
   fingerprint form over ``(dead, fingerprint64(words), iota)``;
3. boundaries come from adjacent FULL-word compares (exact under
   fingerprint collisions, which are flagged), segment ids are a cumsum,
   and every aggregate is a scatter reduction into ``cap`` segments.

Two fingerprint-sorted runs merge without a sort (``segment_merged``, the
merge-path half of the incremental aggregate): two binary searches
(``ops/binsearch.py``) give the stable merge permutation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.exprs.eval import ColumnVal
from auron_tpu_torch.ops import binsearch, bitonic, hashing
from auron_tpu_torch.ops.uwords import MASK32, i64

#: the dead-slot fingerprint of sorted runs: UINT64_MAX, -1 as an int64
DEAD_FP = -1

_I32_MAX = 2**31 - 1


def _canonical_word(cv: ColumnVal) -> torch.Tensor:
    dt = cv.dtype
    v = cv.values
    if dt.kind == T.TypeKind.BOOL or dt.is_dict_encoded or dt.is_integer or dt.kind in (
        T.TypeKind.DATE32, T.TypeKind.TIMESTAMP, T.TypeKind.DECIMAL
    ):
        return v.to(torch.int64)
    if dt.kind == T.TypeKind.FLOAT32:
        f = v.to(torch.float32)
        f = torch.where(f == 0, torch.zeros_like(f), f)
        f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
        return f.view(torch.int32).to(torch.int64) & MASK32
    if dt.kind == T.TypeKind.FLOAT64:
        f = v.to(torch.float64)
        f = torch.where(f == 0, torch.zeros_like(f), f)
        f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
        return f.view(torch.int64)
    raise TypeError(f"ungroupable type {dt}")


def key_words(vals: list[ColumnVal]) -> list[torch.Tensor]:
    """Canonical equality words: one per column plus one null-bits word."""
    words: list[torch.Tensor] = []
    null_bits = None
    for i, cv in enumerate(vals):
        w = _canonical_word(cv)
        words.append(torch.where(cv.validity, w, torch.zeros_like(w)))
        bit = torch.where(cv.validity, torch.zeros_like(w), torch.full_like(w, i64(1 << (i % 64))))
        null_bits = bit if null_bits is None else (null_bits | bit)
    if null_bits is not None:
        words.append(null_bits)
    return words


class Segmentation(NamedTuple):
    order: torch.Tensor  # permutation clustering equal keys, dead rows last
    seg_ids: torch.Tensor  # per sorted position (int64); dead rows -> cap
    boundary: torch.Tensor  # first row of its segment
    group_of_slot: torch.Tensor  # sorted position of each group's first row
    num_groups: torch.Tensor  # device scalar
    sel_sorted: torch.Tensor
    fp_sorted: torch.Tensor | None = None
    collision: torch.Tensor | None = None  # some fp run holds > 1 key


def _finish_segmentation(order, sorted_words, sel_sorted, cap, fp_sorted=None) -> Segmentation:
    dev = sel_sorted.device
    word_change = torch.zeros(cap, dtype=torch.bool, device=dev)
    for w in sorted_words:
        word_change[1:] |= w[1:] != w[:-1]
    diff = word_change.clone()
    diff[0] = True
    boundary = diff & sel_sorted
    seg_live = torch.cumsum(boundary.to(torch.int64), 0) - 1
    seg_ids = torch.where(sel_sorted, seg_live, torch.full_like(seg_live, cap))
    num_groups = boundary.sum()
    group_of_slot = torch.full((cap + 1,), _I32_MAX, dtype=torch.int64, device=dev).scatter_reduce_(
        0, seg_ids, torch.arange(cap, device=dev), "amin")[:cap]
    collision = None
    if fp_sorted is not None:
        fp_same = torch.zeros(cap, dtype=torch.bool, device=dev)
        fp_same[1:] = fp_sorted[1:] == fp_sorted[:-1]
        live_adj = sel_sorted.clone()
        live_adj[1:] &= sel_sorted[:-1]
        live_adj[0] = False
        collision = (live_adj & fp_same & word_change).any()
    return Segmentation(order, seg_ids, boundary, group_of_slot, num_groups, sel_sorted,
                        fp_sorted, collision)


def segment_by_keys(words: list[torch.Tensor], sel: torch.Tensor, fp=None, *,
                    device_impl: str = "lax", n_key_cols: int = 0,
                    fingerprint: bool = False, fp_bits: int = 64) -> Segmentation:
    """Sort-segmentation of one batch, sorted where its tensors live.
    ``device_impl`` picks the full-word sort: 'lax' (library lexsort) |
    'jnp' | 'pallas' (the bitonic network, ops/bitonic.py)."""
    cap = sel.shape[0]
    dead = torch.where(sel, 0, 1).to(torch.int64)
    iota = torch.arange(cap, dtype=torch.int32, device=sel.device)
    if fingerprint:
        if fp is None:
            fp = hashing.fingerprint64(words, fp_bits)
        s_dead, fp_sorted, order = bitonic.lex_sorted((dead, fp, iota))
        order = order.long()
        sorted_words = tuple(w[order] for w in words)
        return _finish_segmentation(order, sorted_words, s_dead == 0, cap, fp_sorted=fp_sorted)
    operands = (dead, *words, iota)
    if device_impl in ("jnp", "pallas"):
        narrow = [True] + [False] * len(words) + [False]
        if 0 < n_key_cols <= 32 and len(words) == n_key_cols + 1:
            narrow[len(words)] = True
        sorted_ops = bitonic.bitonic_sort(operands, impl=device_impl, narrow=tuple(narrow))
    else:
        sorted_ops = bitonic.lex_sorted(operands)
    order = sorted_ops[-1].long()
    return _finish_segmentation(order, sorted_ops[1:-1], sorted_ops[0] == 0, cap)


def merge_rank_order(fp: torch.Tensor, cap_a: int) -> torch.Tensor:
    """Merge-path permutation of TWO fingerprint-sorted runs laid out back to
    back (A = [0, cap_a), B = [cap_a, cap)), each sorted ascending in the
    unsigned order with its dead slots at ``DEAD_FP`` (reference
    ``segments.py:286``): the stable merge (A before B on ties, so equal
    fingerprints of the two runs come out adjacent) from two binary
    searches, dead slots after every live row. No sort."""
    cap = fp.shape[0]
    cap_b = cap - cap_a
    fp_a, fp_b = fp[:cap_a], fp[cap_a:]
    dev = fp.device
    ia = torch.arange(cap_a, dtype=torch.int64, device=dev)
    ib = torch.arange(cap_b, dtype=torch.int64, device=dev)
    pos_a = ia + binsearch.lower_bound_dyn([fp_b], [fp_a], cap_b)
    pos_b = ib + binsearch.upper_bound_dyn([fp_a], [fp_b], cap_a)
    order = torch.zeros(cap, dtype=torch.int64, device=dev)
    order[pos_a] = ia
    order[pos_b] = cap_a + ib
    return order


def segment_merged(words: list[torch.Tensor], sel: torch.Tensor, cap_a: int,
                   fp_bits: int = 64, fp: torch.Tensor | None = None) -> Segmentation:
    """Segmentation of two back-to-back fingerprint-sorted runs without a
    sort (reference ``segments.py:316``): merge-rank the fingerprints, then
    the word-exact segmentation tail, whose collision flag reports any
    fingerprint run holding more than one key (across the two runs too).
    ``fp``: the runs' cached dead-masked fingerprints laid out like the
    columns, so a pair merge does not re-hash its keys."""
    if fp is None:
        fp = hashing.fingerprint64(words, fp_bits)
        fp = torch.where(sel, fp, torch.full_like(fp, DEAD_FP))
    order = merge_rank_order(fp, cap_a)
    return _finish_segmentation(order, tuple(w[order] for w in words), sel[order],
                                sel.shape[0], fp_sorted=fp[order])


# ---------------------------------------------------------------------------
# segment reducers (over sorted value tensors; segment ``cap`` is dropped)
# ---------------------------------------------------------------------------


def max_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def min_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def seg_any(flags: torch.Tensor, seg_ids: torch.Tensor, cap: int) -> torch.Tensor:
    out = torch.zeros(cap + 1, dtype=torch.int32, device=flags.device)
    return out.scatter_reduce_(0, seg_ids, flags.to(torch.int32), "amax")[:cap] > 0


def fixed_order_sums(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """Sums of ``vals`` by index over ``[0, n)``, each index's values added
    in their order in ``vals``: a stable sort groups equal indices and a
    segmented reduction adds each group (no atomics, no host read)."""
    order = torch.argsort(idx, stable=True)
    lengths = torch.zeros(n, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))
    return torch.segment_reduce(vals[order], "sum", lengths=lengths, unsafe=True, initial=0)


def add_at_(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[idx] += vals`` in a fixed order, so a query's answer repeats bit
    for bit (a served query replays against its first answer,
    ``models/servegate.py``). A float ``index_add_`` on CUDA adds with
    atomics in no fixed order, so two runs differ in the last bits of a
    double; floats on the card add ``fixed_order_sums`` instead (the CPU's
    ``index_add_`` is sequential, and integers add exactly in any order).
    ``index_put_(..., accumulate=True)`` is deterministic too, but adds
    each index's run of values in one warp, which serializes a few groups
    of many rows (a global sum)."""
    if out.is_cuda and out.dtype.is_floating_point:
        return out.add_(fixed_order_sums(idx, vals, out.shape[0]))
    return out.index_add_(0, idx, vals)


def seg_sum(vals, valid, seg_ids, cap):
    s = torch.zeros(cap + 1, dtype=vals.dtype, device=vals.device)
    add_at_(s, seg_ids, torch.where(valid, vals, torch.zeros_like(vals)))
    return s[:cap], seg_any(valid, seg_ids, cap)


def seg_count(valid, seg_ids, cap):
    c = torch.zeros(cap + 1, dtype=torch.int64, device=valid.device)
    return c.index_add_(0, seg_ids, valid.to(torch.int64))[:cap]


def _seg_extreme(vals, valid, seg_ids, cap, reduce: str, ident):
    work = vals.to(torch.int8) if vals.dtype == torch.bool else vals
    fill = torch.full((cap + 1,), ident, dtype=work.dtype, device=vals.device)
    masked = torch.where(valid, work, torch.full_like(work, ident))
    out = fill.scatter_reduce_(0, seg_ids, masked, reduce)[:cap]
    if vals.dtype == torch.bool:
        out = out > 0
    return out, seg_any(valid, seg_ids, cap)


def seg_min(vals, valid, seg_ids, cap):
    return _seg_extreme(vals, valid, seg_ids, cap, "amin", max_identity(vals.dtype))


def seg_max(vals, valid, seg_ids, cap):
    return _seg_extreme(vals, valid, seg_ids, cap, "amax", min_identity(vals.dtype))


# ---------------------------------------------------------------------------
# running extremes (windows): an int64 order key and a segmented scan
# ---------------------------------------------------------------------------

_LOW63 = 0x7FFFFFFFFFFFFFFF
_LOW31 = 0x7FFFFFFF


def extreme_key(values: torch.Tensor) -> torch.Tensor:
    """int64 key whose signed order is the values' order, invertible by
    ``from_extreme_key``. Floats take their IEEE total order (a negative
    pattern's low bits flipped): -0.0 sorts below 0.0, so min and max pick
    the zero ``jnp.minimum``/``jnp.maximum`` pick; NaN is left to the
    caller."""
    if values.dtype == torch.float64:
        b = values.view(torch.int64)
        return torch.where(b < 0, b ^ _LOW63, b)
    if values.dtype == torch.float32:
        b = values.view(torch.int32)
        return torch.where(b < 0, b ^ _LOW31, b).to(torch.int64)
    return values.to(torch.int64)


def from_extreme_key(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float64:
        return torch.where(key < 0, key ^ _LOW63, key).view(torch.float64)
    if dtype == torch.float32:
        k = key.to(torch.int32)
        return torch.where(k < 0, k ^ _LOW31, k).view(torch.float32)
    if dtype == torch.bool:
        return key != 0
    return key.to(dtype)


def seg_running_extreme(keys: torch.Tensor, seg_start: torch.Tensor, reduce: str) -> torch.Tensor:
    """Inclusive running min ('amin') or max ('amax') of ``keys`` from each
    row's segment start (``seg_start``, sorted row index; rows past every
    segment carry a start beyond the tensor): log2(n) doubling steps, each
    combining a row with the row d before it when that row lies in its
    segment. Plain torch on any device."""
    op = torch.minimum if reduce == "amin" else torch.maximum
    n = keys.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=keys.device)
    x = keys
    d = 1
    while d < n:
        prev = torch.cat([x[:d], x[:-d]])
        x = torch.where(iota - d >= seg_start, op(x, prev), x)
        d <<= 1
    return x
