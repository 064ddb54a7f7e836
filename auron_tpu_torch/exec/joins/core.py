"""Equi-join core: build preparation, probes and pair expansion.

Port of the inner, left-outer, left-semi and left-anti parts of
``auron_tpu/exec/joins/core.py``:

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
  recomputes which probe rows matched (``condition_pairs``, core.py:809-823).

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
LEFT_SEMI = "left_semi"
LEFT_ANTI = "left_anti"

#: pair slots per emitted chunk (same as auron_tpu)
_EXPAND_CHUNK = 1 << 20

_LUT_KINDS = (T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32, T.TypeKind.INT64,
              T.TypeKind.DATE32, T.TypeKind.TIMESTAMP)
_PACKABLE_KINDS = _LUT_KINDS + (T.TypeKind.BOOL,)


def join_output_schema(left: T.Schema, right: T.Schema, join_type: str) -> T.Schema:
    if join_type in (LEFT_SEMI, LEFT_ANTI):
        return left
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
    # duplicate-keyed build probed only for existence: exists_lut[key - lut_base]
    exists_lut: torch.Tensor | None = None
    # multi-key packing: ``words`` is one packed word; probes pack with it
    pack: "PackSpec | None" = None


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
    lets a duplicate-keyed build stay unsorted behind an existence table."""
    if any(e.dtype_of(schema).is_dict_encoded for e in key_exprs):
        raise NotImplementedError("dictionary-encoded join keys are not in this slice")
    big = device_concat(batches) if batches else Batch.empty(schema, device=device)
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
                                     lut_base=kmin, pack=pack)
            if not need_pairs:
                return PreparedBuild(big, [s], n_live, exists_lut=counts[:size] > 0,
                                     lut_base=kmin, pack=pack)
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
    return PreparedBuild(clustered, sorted_words, n_live, unique=unique, pack=pack)


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


def probe_mark(build: PreparedBuild, probe_words, ok) -> torch.Tensor:
    """Probe rows with at least one build match (semi/anti, no pairs):
    one gather from the existence table, or a non-empty [lower, upper)
    range in the sorted map (``_probe_exists_jit`` / ``_probe_mark_jit``)."""
    if build.exists_lut is not None:
        size = build.exists_lut.shape[0]
        idx = probe_words[0] - build.lut_base
        in_range = (idx >= 0) & (idx < size)
        return ok & in_range & build.exists_lut[idx.clamp(0, size - 1)]
    _, counts = probe_ranges(build, probe_words, ok)
    return counts > 0


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
