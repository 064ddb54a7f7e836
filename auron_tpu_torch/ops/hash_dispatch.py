"""Multi-column Spark murmur3 and xxhash64 over batch columns.

Port of ``auron_tpu/ops/hash_dispatch.py:hash_batch`` (per-type dispatch of
``_column_hash_fn``, reference ``:30-58``, and the chained loop of
``_hash_columns_jit``): column k's hash seeds column k+1, and a NULL leaves
the running hash unchanged — Spark's Murmur3Hash / XxHash64 contract, so a
reducer receives exactly the rows the host engine expects. A
dictionary-encoded string/binary column hashes its rows' bytes: the
vocabulary (small) becomes a zero-padded byte matrix on the batch's device
and each row gathers its entry by code (``ops/bytesmat.py`` of the JAX
package). A wide decimal hashes the minimal big-endian two's-complement
bytes of its unscaled value (Java's ``BigInteger.toByteArray``, what Spark
hashes past precision 18; reference ``ops/hash_dispatch.py:82-108``)
through the same byte-matrix path; a decimal64 hashes as 16 little-endian
bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.ops import hashing as H
from auron_tpu_torch.ops.uwords import MASK32

_FOUR_BYTE = (T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32, T.TypeKind.DATE32,
              T.TypeKind.BOOL)
_EIGHT_BYTE = (T.TypeKind.INT64, T.TypeKind.TIMESTAMP)
ALGOS = ("murmur3", "xxhash64")

_FIXED = {
    "murmur3": (H.murmur3_i32, H.murmur3_i64, H.murmur3_f32, H.murmur3_f64,
                H.murmur3_i128_from_i64),
    "xxhash64": (H.xxhash64_i32, H.xxhash64_i64, H.xxhash64_f32, H.xxhash64_f64,
                 H.xxhash64_i128_from_i64),
}


def column_hash_fn(dtype: T.DataType, algo: str = "murmur3"):
    """The hash of one fixed-width column's values under ``algo`` (BOOL
    hashes as the int 0/1)."""
    four, eight, f32, f64, dec = _FIXED[algo]
    k = dtype.kind
    if k in _FOUR_BYTE:
        return four
    if k in _EIGHT_BYTE:
        return eight
    if k == T.TypeKind.FLOAT32:
        return f32
    if k == T.TypeKind.FLOAT64:
        return f64
    if k == T.TypeKind.DECIMAL and not dtype.is_wide_decimal:
        return dec
    raise NotImplementedError(f"{algo} of {dtype} columns is not in this slice of the port")


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


def _hash_dict(values: torch.Tensor, vocab, seed: torch.Tensor, algo: str) -> torch.Tensor:
    mat, lens = byte_matrix(vocab, values.device)
    codes = values.to(torch.int64).clamp(0, mat.shape[0] - 1)
    fn = H.murmur3_bytes if algo == "murmur3" else H.xxhash64_bytes
    return fn(mat[codes], lens[codes], seed)


def hash_batch(batch: Batch, cols: list[int], algo: str = "murmur3",
               seed: int = 42) -> torch.Tensor:
    """Per-row chained Spark hash of the given columns: int32 (murmur3) or
    int64 (xxhash64). Rows with sel=False still get a value (callers mask as
    needed)."""
    if algo not in ALGOS:
        raise ValueError(f"unknown hash algorithm {algo}")
    dev = batch.device
    init = seed & MASK32 if algo == "murmur3" else seed
    h = torch.full((batch.capacity,), init, dtype=torch.int64, device=batch.torch_device)
    for ci in cols:
        dtype = batch.schema[ci].dtype
        if dtype.kind == T.TypeKind.NULL:
            continue
        if dtype.is_string_like:
            hashed = _hash_dict(dev.values[ci], batch.dicts[ci], h, algo)
        elif dtype.is_wide_decimal:
            hashed = _hash_dict(dev.values[ci], decimal_bytes(batch.dicts[ci], dtype.scale), h,
                                algo)
        else:
            hashed = column_hash_fn(dtype, algo)(dev.values[ci], h)
        h = torch.where(dev.validity[ci], hashed, h)
    return H.spark_hash_i32(h) if algo == "murmur3" else h
