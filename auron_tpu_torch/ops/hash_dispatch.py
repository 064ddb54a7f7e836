"""Multi-column Spark murmur3 over batch columns.

Port of ``auron_tpu/ops/hash_dispatch.py:hash_batch`` (per-type dispatch of
``_column_hash_fn`` and the chained loop of ``_hash_columns_jit``): column
k's hash seeds column k+1, and a NULL leaves the running hash unchanged —
Spark's Murmur3Hash contract, so a reducer receives exactly the rows the
host engine expects. A dictionary-encoded string/binary column hashes its
rows' bytes: the vocabulary (small) becomes a zero-padded byte matrix on
the batch's device and each row gathers its entry by code
(``ops/bytesmat.py`` of the JAX package). A wide decimal hashes the
minimal big-endian two's-complement bytes of its unscaled value (Java's
``BigInteger.toByteArray``, what Spark hashes past precision 18; reference
``ops/hash_dispatch.py:82-108``) through the same byte-matrix path; a
decimal64 hashes as 16 little-endian bytes. xxhash64 waits for a later
slice.
"""

from __future__ import annotations

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.ops import hashing as H
from auron_tpu_torch.ops.uwords import MASK32, hi32, lo32, u32_of_i32

_FOUR_BYTE = (T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32, T.TypeKind.DATE32,
              T.TypeKind.BOOL)
_EIGHT_BYTE = (T.TypeKind.INT64, T.TypeKind.TIMESTAMP)


def _murmur3_f32(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return H.murmur3_words([u32_of_i32(v.to(torch.float32).view(torch.int32))], seed)


def _murmur3_f64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    u = v.to(torch.float64).view(torch.int64)
    return H.murmur3_words([lo32(u), hi32(u)], seed)


def _murmur3_i128_from_i64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """decimal128: 16 LE bytes of the unscaled value, sign-extended from the
    decimal64 plane (``hashing.py:murmur3_i128_from_i64``)."""
    u = v.to(torch.int64)
    ext = torch.where(u < 0, MASK32, 0)
    return H.murmur3_words([lo32(u), hi32(u), ext, ext], seed)


def column_hash_fn(dtype: T.DataType):
    k = dtype.kind
    if k in _FOUR_BYTE:
        return H.murmur3_i32
    if k in _EIGHT_BYTE:
        return H.murmur3_i64
    if k == T.TypeKind.FLOAT32:
        return _murmur3_f32
    if k == T.TypeKind.FLOAT64:
        return _murmur3_f64
    if k == T.TypeKind.DECIMAL and not dtype.is_wide_decimal:
        return _murmur3_i128_from_i64
    raise NotImplementedError(f"murmur3 of {dtype} columns is not in this slice of the port")


def byte_matrix(vocab, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(uint8 ``[E, W]`` zero-padded bytes, int64 lengths) of a vocabulary:
    str entries as UTF-8, bytes as they are; W >= 4 and a multiple of 4."""
    raw = [v.encode("utf-8") if isinstance(v, str) else bytes(v) for v in vocab]
    width = (max([4] + [len(r) for r in raw]) + 3) & ~3
    mat = np.zeros((max(len(raw), 1), width), dtype=np.uint8)
    lens = np.zeros(max(len(raw), 1), dtype=np.int64)
    for i, r in enumerate(raw):
        mat[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
        lens[i] = len(r)
    return torch.from_numpy(mat).to(device), torch.from_numpy(lens).to(device)


def decimal_bytes(vocab, scale: int) -> list[bytes]:
    """Per entry of a wide-decimal vocabulary: the minimal big-endian
    two's-complement bytes of its unscaled value."""
    rows = []
    for e in vocab:
        if e is None:
            rows.append(b"\x00")
            continue
        u = T.unscaled_int(e, scale)
        bl = u.bit_length() if u >= 0 else (-u - 1).bit_length()
        rows.append(u.to_bytes(bl // 8 + 1, "big", signed=True))
    return rows


def _murmur3_dict(values: torch.Tensor, vocab, seed: torch.Tensor) -> torch.Tensor:
    mat, lens = byte_matrix(vocab, values.device)
    codes = values.to(torch.int64).clamp(0, mat.shape[0] - 1)
    return H.murmur3_bytes(mat[codes], lens[codes], seed)


def hash_batch(batch: Batch, cols: list[int], algo: str = "murmur3",
               seed: int = 42) -> torch.Tensor:
    """Per-row chained Spark murmur3 of the given columns, as int32. Rows
    with sel=False still get a value (callers mask as needed)."""
    if algo != "murmur3":
        raise NotImplementedError(f"{algo} is not in this slice of the port")
    dev = batch.device
    h = torch.full((batch.capacity,), seed & MASK32, dtype=torch.int64,
                   device=batch.torch_device)
    for ci in cols:
        dtype = batch.schema[ci].dtype
        if dtype.kind == T.TypeKind.NULL:
            continue
        if dtype.is_string_like:
            hashed = _murmur3_dict(dev.values[ci], batch.dicts[ci], h)
        elif dtype.is_wide_decimal:
            hashed = _murmur3_dict(dev.values[ci], decimal_bytes(batch.dicts[ci], dtype.scale),
                                   h)
        else:
            hashed = column_hash_fn(dtype)(dev.values[ci], h)
        h = torch.where(dev.validity[ci], hashed, h)
    return H.spark_hash_i32(h)
