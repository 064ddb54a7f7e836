"""Equi-join core: build preparation, probes and pair expansion.

Port of the inner- and left-outer-join parts of
``auron_tpu/exec/joins/core.py``:

- a single integer-like key with a small value range and unique live keys
  builds a dense direct-address table (``lut[key - base] = build row``):
  the probe is one gather (core.py:332, :349, :605-693);
- otherwise the build is clustered by its canonical key words (live rows
  first; a stable library sort, the counterpart of the ``lax.sort`` the JAX
  package uses here) and probed by branchless lexicographic binary search:
  a unique build takes one lower bound per probe row, a duplicate-keyed
  build a [lower, upper) range per row that expands into pair chunks with
  one count read per probe batch (core.py:695-860).

SQL null semantics: a NULL in any key never matches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import (
    Batch, DeviceBatch, bucket_capacity, device_concat, device_take,
)
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import ColumnVal, Evaluator
from auron_tpu_torch.ops import bitonic
from auron_tpu_torch.ops.segments import _canonical_word
from auron_tpu_torch.ops.uwords import flip

INNER = "inner"
LEFT = "left"

#: pair slots per emitted chunk (same as auron_tpu)
_EXPAND_CHUNK = 1 << 20

_LUT_KINDS = (T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32, T.TypeKind.INT64,
              T.TypeKind.DATE32, T.TypeKind.TIMESTAMP)


def join_output_schema(left: T.Schema, right: T.Schema, join_type: str) -> T.Schema:
    if join_type not in (INNER, LEFT):
        raise NotImplementedError(f"{join_type} joins are not in this slice of the port")
    lf = [T.Field(f.name, f.dtype, True) for f in left.fields]
    rf = [T.Field(f.name, f.dtype, True) for f in right.fields]
    return T.Schema(tuple(lf + rf))


@dataclass
class PreparedBuild:
    batch: Batch  # build rows (clustered by key, live first, unless lut)
    words: list  # canonical key words in the batch's row order
    n_live: int  # rows with all keys valid
    unique: bool = False
    lut: torch.Tensor | None = None  # lut[key - lut_base] = row or -1
    lut_base: int = 0


def key_columns(batch: Batch, key_exprs: list[ir.Expr]) -> list[ColumnVal]:
    return Evaluator(batch.schema).evaluate(batch, key_exprs)


def canon_words(vals: list[ColumnVal]) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Equality words per key (0 at NULL) + the all-keys-valid mask."""
    words, valid = [], None
    for cv in vals:
        w = _canonical_word(cv)
        words.append(torch.where(cv.validity, w, torch.zeros_like(w)))
        valid = cv.validity if valid is None else (valid & cv.validity)
    return words, valid


def prepare_build(batches: list[Batch], key_exprs: list[ir.Expr], schema: T.Schema,
                  device) -> PreparedBuild:
    if any(e.dtype_of(schema).is_dict_encoded for e in key_exprs):
        raise NotImplementedError("dictionary-encoded join keys are not in this slice")
    big = device_concat(batches) if batches else Batch.empty(schema, device=device)
    vals = key_columns(big, key_exprs)
    words, valid = canon_words(vals)
    sel = big.device.sel & valid
    cap = big.capacity
    dev = sel.device

    if len(words) == 1 and vals[0].dtype.kind in _LUT_KINDS:
        s = words[0]
        big_i = torch.iinfo(torch.int64)
        n_live, kmin, kmax = torch.stack([
            sel.sum(),
            torch.where(sel, s, torch.full_like(s, big_i.max)).min(),
            torch.where(sel, s, torch.full_like(s, big_i.min)).max(),
        ]).tolist()
        if (n_live > 0 and 0 <= kmax - kmin < min(max(4 * cap, 1 << 16), 1 << 22)
                and n_live <= kmax - kmin + 1):
            size = bucket_capacity(kmax - kmin + 1)
            slot = torch.where(sel, s - kmin, torch.full_like(s, size))
            counts = torch.zeros(size + 1, dtype=torch.int32, device=dev)
            counts.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
            if not bool((counts[:size] > 1).any()):
                lut = torch.full((size + 1,), -1, dtype=torch.int64, device=dev)
                lut.scatter_(0, slot, torch.arange(cap, device=dev))
                return PreparedBuild(big, [s], n_live, unique=True, lut=lut[:size],
                                     lut_base=kmin)
    # sorted map: cluster by (dead, *words) with a stable sort
    dead = torch.where(sel, 0, 1).to(torch.int64)
    order = bitonic.lexsort((dead, *words))
    clustered = Batch(big.schema, device_take(big.device, order), big.dicts)
    sorted_words = [w[order] for w in words]
    n_live = int(sel.sum().item())
    live = torch.arange(cap, device=dev) < n_live
    dup = torch.ones(cap - 1, dtype=torch.bool, device=dev) if cap > 1 else None
    unique = n_live > 0
    if dup is not None and n_live > 1:
        for w in sorted_words:
            dup &= w[1:] == w[:-1]
        unique = not bool((dup & live[1:]).any())
    return PreparedBuild(clustered, sorted_words, n_live, unique=unique)


def _lex_search(build_words, probe_words, n: int, or_equal: bool) -> torch.Tensor:
    """Branchless binary search over the first n (sorted) build rows:
    count of rows < probe (lower bound) or <= probe (upper bound), with
    unsigned lexicographic order over the words."""
    bw = [flip(w) for w in build_words]
    pw = [flip(w) for w in probe_words]
    pos = torch.zeros_like(pw[0])
    step = 1
    while step < max(n, 1):
        step <<= 1
    while step >= 1:
        nxt = pos + step
        at = (nxt - 1).clamp(0, max(bw[0].shape[0] - 1, 0))
        lt = torch.zeros_like(pos, dtype=torch.bool)
        eq = torch.ones_like(pos, dtype=torch.bool)
        for b, p in zip(bw, pw):
            bv = b[at]
            lt = lt | (eq & (bv < p))
            eq = eq & (bv == p)
        take = (nxt <= n) & ((lt | eq) if or_equal else lt)
        pos = torch.where(take, nxt, pos)
        step >>= 1
    return pos


def probe_unique(build: PreparedBuild, probe_words, ok_base) -> tuple[torch.Tensor, torch.Tensor]:
    """(build row per probe row, matched) for a unique build."""
    bcap = build.batch.capacity
    if build.lut is not None:
        size = build.lut.shape[0]
        idx = probe_words[0] - build.lut_base
        in_range = (idx >= 0) & (idx < size)
        bi = build.lut[idx.clamp(0, size - 1)]
        return bi.clamp(0, bcap - 1), ok_base & in_range & (bi >= 0)
    lo = _lex_search(build.words, probe_words, build.n_live, or_equal=False)
    bi = lo.clamp(0, bcap - 1)
    eq = lo < build.n_live
    for bw, pw in zip(build.words, probe_words):
        eq = eq & (bw[bi] == pw)
    return bi, ok_base & eq


def probe_ranges(build: PreparedBuild, probe_words, ok) -> tuple[torch.Tensor, torch.Tensor]:
    lo = _lex_search(build.words, probe_words, build.n_live, or_equal=False)
    hi = _lex_search(build.words, probe_words, build.n_live, or_equal=True)
    return lo, torch.where(ok, hi - lo, torch.zeros_like(lo))


def expand_pairs(pcap: int, bcap: int, lo: torch.Tensor, counts: torch.Tensor):
    """Per-chunk (probe_idx, build_idx, ok) triples of the ragged pair
    expansion; one count read per probe batch."""
    offsets = torch.cumsum(counts, 0)
    total = int(offsets[-1].item()) if counts.shape[0] else 0
    chunks = []
    starts = offsets - counts
    for cstart in range(0, total, _EXPAND_CHUNK):
        ccap = bucket_capacity(min(_EXPAND_CHUNK, total - cstart))
        t = torch.arange(ccap, device=counts.device) + cstart
        ok = t < total
        li = torch.searchsorted(offsets, t, right=True).clamp(0, pcap - 1)
        ri = (lo[li] + (t - starts[li])).clamp(0, bcap - 1)
        chunks.append((li, ri, ok))
    return chunks
