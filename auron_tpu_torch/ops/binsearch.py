"""Vectorised lexicographic binary search over multi-word sorted keys.

Port of ``auron_tpu/ops/binsearch.py``. Key words are uint64 values carried
as int64 bit patterns (``ops/uwords.py``), so every compare is UNSIGNED:
the order ``bitonic.lex_sorted`` sorts int64 operands in, and the order the
fingerprint-sorted aggregate runs (``ops/segments.py``) are in. Dead and
pad slots carry ``0xFFFF_FFFF_FFFF_FFFF`` (-1 as an int64), the largest
word, so they sort after every live row; a signed search would put them
first. int32 words compare signed, as the reference's int32 arrays do.

- one word: ``torch.searchsorted`` over the sign-flipped words (signed
  order of the flip == unsigned order of the word), with the slots at or
  past ``n`` raised to the largest key so the search over the whole
  tensor equals the search over ``[0, n)``;
- several words: the reference's branchless fixed-trip loop
  (ceil(log2(capacity)) + 1 steps), every query row in parallel.

The live count ``n`` may be a Python int or a device scalar (the ``_dyn``
forms): nothing here reads a tensor to the host.
"""

from __future__ import annotations

import math

import torch

from auron_tpu_torch.ops.uwords import flip


def _ordered(w: torch.Tensor) -> torch.Tensor:
    """Signed-comparable view: int64 words flip their sign bit, others stay."""
    return flip(w) if w.dtype == torch.int64 else w


def _top(dtype: torch.dtype) -> int:
    return torch.iinfo(dtype).max


def _lex_cmp(sorted_words, idx, query_words):
    """(sorted[idx] < query, sorted[idx] == query), lexicographically."""
    lt = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    eq = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    for sw, qw in zip(sorted_words, query_words):
        s = sw[idx]
        lt = lt | (eq & (s < qw))
        eq = eq & (s == qw)
    return lt, eq


def _search(sorted_words: list, query_words: list, n, or_equal: bool) -> torch.Tensor:
    cap = sorted_words[0].shape[0]
    m = query_words[0].shape[0]
    dev = query_words[0].device
    if cap == 0:
        return torch.zeros(m, dtype=torch.int64, device=dev)
    sw = [_ordered(w) for w in sorted_words]
    qw = [_ordered(w) for w in query_words]
    if len(sw) == 1:
        live = torch.arange(cap, device=dev) < n
        s = torch.where(live, sw[0], torch.full_like(sw[0], _top(sw[0].dtype)))
        pos = torch.searchsorted(s, qw[0].contiguous(), right=or_equal)
        if isinstance(n, torch.Tensor):
            return torch.minimum(pos, n.to(device=dev, dtype=torch.int64))
        return pos.clamp(max=int(n))
    lo = torch.zeros(m, dtype=torch.int64, device=dev)
    hi = (n.to(torch.int64).expand(m).clone() if isinstance(n, torch.Tensor)
          else torch.full((m,), int(n), dtype=torch.int64, device=dev))
    for _ in range(max(1, math.ceil(math.log2(max(cap, 2))) + 1)):
        active = lo < hi
        mid = (lo + hi) // 2
        lt, eq = _lex_cmp(sw, mid.clamp(0, cap - 1), qw)
        less = (lt | eq) if or_equal else lt
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def lower_bound_dyn(sorted_words: list, query_words: list, n) -> torch.Tensor:
    """First index i in [0, n] with sorted[i] >= query (per query row)."""
    return _search(sorted_words, query_words, n, or_equal=False)


def upper_bound_dyn(sorted_words: list, query_words: list, n) -> torch.Tensor:
    """First index i in [0, n] with sorted[i] > query (per query row)."""
    return _search(sorted_words, query_words, n, or_equal=True)


def lower_bound(sorted_words: list, query_words: list, n: int) -> torch.Tensor:
    return lower_bound_dyn(sorted_words, query_words, int(n))


def upper_bound(sorted_words: list, query_words: list, n: int) -> torch.Tensor:
    return upper_bound_dyn(sorted_words, query_words, int(n))
