"""Equi-join core: build preparation, probes, pair expansion and the
build-side marks.

Port of ``auron_tpu/exec/joins/core.py`` (all seven join types):

- several integer-like keys whose live ranges fit 63 bits together pack
  into one word (``core.py:266-320``): every later pass is single-word,
  bit-exact, since a packed word equals its int64 view;
- a single integer-like key (or a packed word) with a small value range
  and unique live keys builds a dense direct-address table
  (``lut[key - base] = build row``): the probe is one gather (core.py:332,
  :349-413, :605-693); when the join needs no pairs (semi/anti probes),
  duplicate keys keep the dense table as an existence table
  (``exists_lut``) and the build is never sorted (core.py:395-412, :708-717);
- otherwise the build is clustered by its canonical key words (live rows
  first; a stable library sort, the counterpart of the ``lax.sort`` the JAX
  package uses here) and probed by branchless lexicographic binary search:
  a unique build takes one lower bound per probe row, a duplicate-keyed
  build a [lower, upper) range per row that expands into pair chunks with
  one count read per probe batch (core.py:695-860), or, for semi/anti,
  marks the probe rows whose range is not empty (core.py:720-775);
- a residual join condition narrows each chunk of expanded pairs and
  recomputes which probe rows matched (``condition_pairs``, core.py:809-823);
- ``PreparedBuild.matched`` (one bool per build row, kept across probe
  batches) feeds the build-outer and build-marking joins: a unique probe
  folds its matched rows, a pair expansion its surviving pairs, and a
  range probe ``[lo, lo + count)`` per matched row through a +1/-1
  difference array and a cumsum (core.py:520-531, :720-831). Every fold
  sends dead rows to a spare slot;
- dictionary-encoded keys (strings, and wide decimals: Decimal entries
  merge by value, reference core.py:144) compare as codes of one joint
  vocabulary (``unify_key_dicts``, core.py:123-156): the build's
  vocabulary comes first, so its codes keep their sorted order; a
  decimal64 key is its int64 word.

SQL null semantics: a NULL in any key never matches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import (
    Batch, DeviceBatch, bucket_capacity, compaction_index, device_concat, device_take,
    empty_dict, merge_vocab,
)
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import ColumnVal, Evaluator
from auron_tpu_torch.ops import bitonic
from auron_tpu_torch.ops.segments import _canonical_word
from auron_tpu_torch.ops.uwords import flip

INNER = "inner"
LEFT = "left"
RIGHT = "right"
FULL = "full"
LEFT_SEMI = "left_semi"
LEFT_ANTI = "left_anti"
EXISTENCE = "existence"

JOIN_TYPES = (INNER, LEFT, RIGHT, FULL, LEFT_SEMI, LEFT_ANTI, EXISTENCE)

#: pair slots per emitted chunk (same as auron_tpu)
_EXPAND_CHUNK = 1 << 20

_LUT_KINDS = (T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32, T.TypeKind.INT64,
              T.TypeKind.DATE32, T.TypeKind.TIMESTAMP)
_PACKABLE_KINDS = _LUT_KINDS + (T.TypeKind.BOOL,)


def join_output_schema(left: T.Schema, right: T.Schema, join_type: str,
                       exists_col: str = "exists") -> T.Schema:
    if join_type in (LEFT_SEMI, LEFT_ANTI):
        return left
    if join_type == EXISTENCE:
        return T.Schema(tuple(left.fields) + (T.Field(exists_col, T.BOOL, False),))
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
    # duplicate-keyed build probed only for existence: exists_lut[key - lut_base]
    exists_lut: torch.Tensor | None = None
    # multi-key packing: ``words`` is one packed word; probes pack with it
    pack: "PackSpec | None" = None
    # one bool per build row, updated across probe batches (build-outer
    # and build-marking joins read it in ``finish``)
    matched: torch.Tensor | None = None


@dataclass(frozen=True)
class PackSpec:
    """Multi-key -> one-word packing from the build side's live ranges."""

    mins: tuple  # signed per-key minimum
    maxs: tuple  # signed per-key maximum
    shifts: tuple  # left shift per key (leading key highest)


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


def _live_minmax(words: list[torch.Tensor], sel: torch.Tensor) -> tuple[int, list, list]:
    """(live rows, per-word signed minima, maxima) over the live rows, one
    host read."""
    big_i = torch.iinfo(torch.int64)
    stats = [sel.sum()]
    for w in words:
        stats += [torch.where(sel, w, torch.full_like(w, big_i.max)).min(),
                  torch.where(sel, w, torch.full_like(w, big_i.min)).max()]
    flat = torch.stack(stats).tolist()
    return flat[0], flat[1::2], flat[2::2]


def maybe_pack(vals: list[ColumnVal], words: list[torch.Tensor], sel) -> PackSpec | None:
    """Multi-integer-key packing from the build side's live ranges
    (``_maybe_pack``, core.py:266-288): None for one key, a key of another
    type, no live rows, or ranges wider than 63 bits together."""
    if len(words) < 2:
        return None
    for cv in vals:
        if cv.dtype.kind not in _PACKABLE_KINDS or cv.dtype.is_dict_encoded:
            return None
    _, mins, maxs = _live_minmax(words, sel)
    if any(mn > mx for mn, mx in zip(mins, maxs)):
        return None
    bits = [max(int(mx - mn).bit_length(), 1) for mn, mx in zip(mins, maxs)]
    if sum(bits) > 63:
        return None
    shifts, acc = [], 0
    for b in reversed(bits):  # the last key sits in the low bits
        shifts.append(acc)
        acc += b
    return PackSpec(tuple(mins), tuple(maxs), tuple(reversed(shifts)))


def pack_words(words: list[torch.Tensor], valid, spec: PackSpec):
    """(packed word, valid) of key words under a build's PackSpec
    (``_pack_probe_words_jit``, core.py:291-307): a row with a key outside
    the build's range can never match and turns invalid (its clamped word
    may alias a real build key)."""
    in_range = None
    acc = torch.zeros_like(words[0])
    for w, mn, mx, sh in zip(words, spec.mins, spec.maxs, spec.shifts):
        ok = (w >= mn) & (w <= mx)
        in_range = ok if in_range is None else (in_range & ok)
        acc = acc | ((w - mn).clamp(min=0) << sh)
    return acc, (in_range if valid is None else (valid & in_range))


def probe_words(build: PreparedBuild, vals: list[ColumnVal]):
    """Canonical probe words (packed with the build's spec when it packed)
    and the all-keys-valid mask."""
    words, valid = canon_words(vals)
    if build.pack is not None:
        packed, valid = pack_words(words, valid, build.pack)
        words = [torch.where(valid, packed, torch.zeros_like(packed))]
    return words, valid


def prepare_build(batches: list[Batch], key_exprs: list[ir.Expr], schema: T.Schema,
                  device, need_pairs: bool = True) -> PreparedBuild:
    """``need_pairs=False`` (semi/anti probes that only test existence)
    lets a duplicate-keyed build stay unsorted behind an existence table.
    Dictionary-encoded keys build the sorted map over their codes."""
    big = device_concat(batches) if batches else Batch.empty(schema, device=device)
    matched = torch.zeros(big.capacity, dtype=torch.bool, device=big.torch_device)
    vals = key_columns(big, key_exprs)
    words, valid = canon_words(vals)
    sel = big.device.sel & valid
    cap = big.capacity
    dev = sel.device

    pack = maybe_pack(vals, words, sel) if cap > 0 else None
    if pack is not None:
        words = [pack_words(words, None, pack)[0]]

    if cap > 0 and len(words) == 1 and vals[0].dtype.kind in _LUT_KINDS:
        s = words[0]
        n_live, (kmin,), (kmax,) = _live_minmax([s], sel)
        # more live rows than slots means duplicates: a pairs build cannot be unique
        cannot_be_unique = n_live > kmax - kmin + 1
        if (n_live > 0 and 0 <= kmax - kmin < min(max(4 * cap, 1 << 16), 1 << 22)
                and not (need_pairs and cannot_be_unique)):
            size = bucket_capacity(kmax - kmin + 1)
            slot = torch.where(sel, s - kmin, torch.full_like(s, size))
            counts = torch.zeros(size + 1, dtype=torch.int32, device=dev)
            counts.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
            if not bool((counts[:size] > 1).any()):
                lut = torch.full((size + 1,), -1, dtype=torch.int64, device=dev)
                lut.scatter_(0, slot, torch.arange(cap, device=dev))
                return PreparedBuild(big, [s], n_live, unique=True, lut=lut[:size],
                                     lut_base=kmin, pack=pack, matched=matched)
            if not need_pairs:
                return PreparedBuild(big, [s], n_live, exists_lut=counts[:size] > 0,
                                     lut_base=kmin, pack=pack, matched=matched)
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
    return PreparedBuild(clustered, sorted_words, n_live, unique=unique, pack=pack,
                         matched=matched)


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


def probe_mark(build: PreparedBuild, probe_words, ok, fold: bool = False) -> torch.Tensor:
    """Probe rows with at least one build match (semi/anti/existence, no
    pairs): one gather from the existence table, or a non-empty [lower,
    upper) range in the sorted map (``_probe_exists_jit`` /
    ``_probe_mark_jit``); with ``fold`` the ranges of the matched rows
    also mark their build rows."""
    if build.exists_lut is not None:
        size = build.exists_lut.shape[0]
        idx = probe_words[0] - build.lut_base
        in_range = (idx >= 0) & (idx < size)
        return ok & in_range & build.exists_lut[idx.clamp(0, size - 1)]
    lo, counts = probe_ranges(build, probe_words, ok)
    if fold:
        fold_ranges(build.matched, lo, counts)
    return counts > 0


def fold_rows(matched: torch.Tensor, rows: torch.Tensor, ok: torch.Tensor) -> None:
    """Mark build rows ``rows`` where ``ok`` (in place): counts by
    ``index_add_``, dead rows sent to a spare slot past the end
    (``matched.at[bi].max(ok, mode="drop")`` in the reference)."""
    bcap = matched.shape[0]
    slot = torch.where(ok, rows, torch.full_like(rows, bcap))
    hits = torch.zeros(bcap + 1, dtype=torch.int32, device=matched.device)
    hits.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    matched |= hits[:bcap] > 0


def fold_ranges(matched: torch.Tensor, lo: torch.Tensor, counts: torch.Tensor) -> None:
    """Mark build rows ``[lo, lo + count)`` of every probe row with a
    non-empty range (in place): +1 at the start, -1 at the stop, a cumsum,
    then ``> 0`` (``_covered_fold``, core.py:529)."""
    bcap = matched.shape[0]
    hit = counts > 0
    starts = torch.where(hit, lo, torch.full_like(lo, bcap))
    stops = torch.where(hit, lo + counts, torch.full_like(lo, bcap))
    diff = torch.zeros(bcap + 1, dtype=torch.int32, device=matched.device)
    one = torch.ones_like(starts, dtype=torch.int32)
    diff.index_add_(0, starts, one)
    diff.index_add_(0, stops, -one)
    matched |= torch.cumsum(diff[:bcap], 0) > 0


def unify_key_dicts(build_vals: list[ColumnVal], probe_vals: list[ColumnVal]
                    ) -> tuple[list[ColumnVal], list[ColumnVal]]:
    """Remap dictionary-encoded key pairs onto one joint vocabulary (the
    build's entries first, then the probe's new ones) so that equal
    strings get equal codes; other keys pass through."""
    out_b, out_p = [], []
    for bv, pv in zip(build_vals, probe_vals):
        if not bv.dtype.is_dict_encoded:
            out_b.append(bv)
            out_p.append(pv)
            continue
        joint, (rb, rp) = merge_vocab([bv.dict, pv.dict])
        codes = []
        for cv, r in ((bv, rb), (pv, rp)):
            remap = torch.from_numpy(r).to(cv.values.device)
            codes.append(remap[cv.values.long().clamp(0, len(r) - 1)])
        out_b.append(ColumnVal(codes[0], bv.validity, bv.dtype, joint))
        out_p.append(ColumnVal(codes[1], pv.validity, pv.dtype, joint))
    return out_b, out_p


def null_columns(schema: T.Schema, cap: int, device) -> list[ColumnVal]:
    """All-NULL columns of ``schema`` (the outer side of an unmatched row)."""
    return [ColumnVal(torch.zeros(cap, dtype=f.dtype.physical_dtype(), device=device),
                      torch.zeros(cap, dtype=torch.bool, device=device), f.dtype,
                      empty_dict(f.dtype) if f.dtype.is_dict_encoded else None)
            for f in schema]


def predicted_take(probe_cols, bi, ok, build_cols, sel, out_cap: int):
    """The unique join's compacted gather into a static bucket
    (``_unique_compact_take_pred_jit``, core.py:646-672): the index comes
    from ``sel`` on the device (no host read; live rows past ``out_cap``
    are dropped, and the caller repairs a bucket that proves too small);
    probe columns at ``idx``, build columns at ``bi[idx]``, each (values,
    validity) narrowed to the live rows (and build columns to matched ones)."""
    idx, new_sel = compaction_index(sel, out_cap)
    c_bi = bi[idx]
    c_ok = ok[idx] & new_sel
    return ([(v[idx], m[idx] & new_sel) for v, m in probe_cols],
            [(v[c_bi], m[c_bi] & c_ok) for v, m in build_cols], new_sel)


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


def condition_pairs(chunks, holds, counts: torch.Tensor):
    """Residual condition over the pair chunks of ``expand_pairs(...,
    counts)`` (its condition branch, core.py:809-823): each chunk's ``ok``
    narrows to ``holds(li, ri, ok)``, and a probe row matches when any of
    its pairs still does. Returns (chunks, probe_matched)."""
    hits = torch.zeros_like(counts, dtype=torch.int32)
    out = []
    for li, ri, ok in chunks:
        ok = holds(li, ri, ok)
        hits.index_add_(0, li, ok.to(torch.int32))
        out.append((li, ri, ok))
    return out, hits > 0
