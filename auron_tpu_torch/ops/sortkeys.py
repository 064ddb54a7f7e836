"""Order-preserving sort-key encoding.

Port of ``auron_tpu/ops/sortkeys.py``: every sort key becomes uint64 words
(carried as int64 bit patterns, ``ops/uwords.py``) whose UNSIGNED order is
the SQL order, so one multi-operand stable sort implements any (asc/desc,
nulls first/last) ORDER BY:

- signed ints/date/timestamp: XOR the sign bit;
- floats: IEEE total-order trick (negative -> ~bits, positive -> bits|sign),
  placing NaN above +inf (Spark's NaN-greatest);
- strings: rank through the host-sorted vocabulary (UTF-8 byte order);
  wide decimals rank through their vocabulary's numeric order
  (reference ``ops/sortkeys.py:76-80``); decimal64 sorts as its int64;
- descending inverts the word; null placement is a leading 0/1 word per key.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.exprs.eval import ColumnVal
from auron_tpu_torch.ops.uwords import SIGN64


@dataclass(frozen=True)
class SortSpec:
    asc: bool = True
    nulls_first: bool = True


def _dict_rank(d: np.ndarray) -> np.ndarray:
    import decimal as pydec

    if any(isinstance(e, pydec.Decimal) for e in d):
        keyed = [e if e is not None else pydec.Decimal(0) for e in d]
    else:
        keyed = [(e.encode("utf-8") if isinstance(e, str) else (e if e is not None else b""))
                 for e in d]
    order = sorted(range(len(keyed)), key=lambda i: keyed[i])
    rank = np.empty(len(keyed), dtype=np.int64)
    rank[order] = np.arange(len(keyed))
    return rank


def dict_rank_maps(d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(rank, inv) of a vocabulary: ``rank[code]`` is the entry's UTF-8
    byte-order rank (numeric for a wide decimal's) and ``inv[rank]`` the
    code back. min/max over
    dictionary codes run in rank space (codes are in first-occurrence
    order)."""
    rank = _dict_rank(d)
    inv = np.empty_like(rank)
    inv[rank] = np.arange(len(rank), dtype=np.int64)
    return rank, inv


def orderable_word(cv: ColumnVal) -> torch.Tensor:
    """uint64 carrier whose unsigned order == SQL ascending order."""
    dt = cv.dtype
    v = cv.values
    if dt.kind == T.TypeKind.BOOL:
        return v.to(torch.int64)
    if dt.is_dict_encoded:
        rank = torch.from_numpy(_dict_rank(cv.dict)).to(v.device)
        return rank[v.long().clamp(0, len(rank) - 1)]
    if dt.is_integer or dt.kind in (T.TypeKind.DATE32, T.TypeKind.TIMESTAMP, T.TypeKind.DECIMAL):
        return v.to(torch.int64) ^ SIGN64
    if dt.kind == T.TypeKind.FLOAT32:
        f = v.to(torch.float32)
        f = torch.where(f == 0, torch.zeros_like(f), f)
        f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
        b = (f.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) << 32
    elif dt.kind == T.TypeKind.FLOAT64:
        f = v.to(torch.float64)
        f = torch.where(f == 0, torch.zeros_like(f), f)
        f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
        b = f.view(torch.int64)
    else:
        raise TypeError(f"unsortable type {dt}")
    neg = b < 0  # the sign bit of the IEEE pattern
    return torch.where(neg, ~b, b | SIGN64)


def sort_operands(keys: list[ColumnVal], specs: list[SortSpec]) -> list[torch.Tensor]:
    """Per key: a null-placement word then the direction-adjusted value word."""
    ops: list[torch.Tensor] = []
    for cv, spec in zip(keys, specs):
        one = torch.ones_like(cv.values, dtype=torch.int64)
        zero = torch.zeros_like(one)
        nf = spec.nulls_first
        null_word = torch.where(cv.validity, one if nf else zero, zero if nf else one)
        w = orderable_word(cv)
        if not spec.asc:
            w = ~w
        ops.append(null_word)
        ops.append(torch.where(cv.validity, w, zero))
    return ops


def narrow_flags(n_keys: int) -> tuple[bool, ...]:
    """The 0/1 null-placement words have statically-zero hi halves; the
    value words use all 64 bits."""
    return (True, False) * n_keys
