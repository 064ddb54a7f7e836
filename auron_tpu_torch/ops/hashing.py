"""Bit-exact Spark hashes and group-key fingerprints as torch functions.

Port of ``auron_tpu/ops/hashing.py`` (murmur3_x86_32 Spark variant,
xxhash64, ``fingerprint64``, ``pmod``) on the carrier convention of
``ops/uwords.py``: uint32 lanes ride as int64 values in [0, 2^32) with
products masked to 32 bits; uint64 lanes ride as int64 bit patterns,
whose add/mul wrap mod 2^64 exactly like uint64.
"""

from __future__ import annotations

import torch

from auron_tpu_torch.ops.uwords import (
    MASK32, i32_of_u32, i64, hi32, lo32, lshr64, mul32, rotl32, rotl64, u32_of_i32,
)

# ---------------------------------------------------------------------------
# murmur3_x86_32 (Spark variant); uint32 int64 carriers
# ---------------------------------------------------------------------------

_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _mix_k1(k1):
    return mul32(rotl32(mul32(k1, _C1), 15), _C2)


def _mix_h1(h1, k1):
    h1 = rotl32(h1 ^ k1, 13)
    return (h1 * 5 + 0xE6546B64) & MASK32


def _fmix(h1, length: int):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def murmur3_words(words: list[torch.Tensor], seed: torch.Tensor) -> torch.Tensor:
    """murmur3 of a fixed number of uint32 words per row; returns the uint32
    hash as an int64 carrier."""
    h1 = seed & MASK32
    for w in words:
        h1 = _mix_h1(h1, _mix_k1(w & MASK32))
    return _fmix(h1, 4 * len(words))


def murmur3_i32(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark hash of a 4-byte value (int8/16/32 sign-extended, date32, bool)."""
    return murmur3_words([u32_of_i32(v.to(torch.int32))], seed)


def murmur3_i64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    u = v.to(torch.int64)
    return murmur3_words([lo32(u), hi32(u)], seed)


def murmur3_bytes(bytes_u8: torch.Tensor, lengths: torch.Tensor,
                  seed: torch.Tensor) -> torch.Tensor:
    """Spark murmur3 of per-row byte strings (a zero-padded ``[n, W]`` uint8
    matrix, W a multiple of 4, and the lengths): aligned 4-byte words get
    standard rounds, and each of the ``len % 4`` trailing bytes gets a full
    round with the byte sign-extended (Spark's hashUnsafeBytes). Rounds past
    a row's length are masked, so one fixed loop serves every row."""
    n, width = bytes_u8.shape
    b = bytes_u8.to(torch.int64).reshape(n, width // 4, 4)
    words = b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)
    lengths = lengths.to(torch.int64)
    aligned = lengths // 4
    h1 = (seed & MASK32).expand(n).clone()
    for i in range(width // 4):
        h1 = torch.where(i < aligned, _mix_h1(h1, _mix_k1(words[:, i])), h1)
    signed = bytes_u8.view(torch.int8).to(torch.int64) & MASK32
    for t in range(3):
        pos = aligned * 4 + t
        byte = signed.gather(1, pos.clamp(max=width - 1)[:, None])[:, 0]
        h1 = torch.where(pos < lengths, _mix_h1(h1, _mix_k1(byte)), h1)
    return _fmix(h1, lengths)


def spark_hash_i32(h_u32: torch.Tensor) -> torch.Tensor:
    """The int32 Spark returns for a uint32 hash carrier."""
    return i32_of_u32(h_u32)


def pmod(hash_i32: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Spark's Pmod(hash, n) used by HashPartitioning."""
    p = torch.remainder(hash_i32.to(torch.int32), num_partitions)
    return p.to(torch.int32)


# ---------------------------------------------------------------------------
# xxhash64; uint64 int64 carriers
# ---------------------------------------------------------------------------

_P1 = i64(0x9E3779B185EBCA87)
_P2 = i64(0xC2B2AE3D27D4EB4F)
_P3 = i64(0x165667B19E3779F9)
_P4 = i64(0x85EBCA77C2B2AE63)
_P5 = i64(0x27D4EB2F165667C5)


def _xx_round(acc, lane):
    return rotl64(acc + lane * _P2, 31) * _P1


def _xx_fmix(h):
    h = h ^ lshr64(h, 33)
    h = h * _P2
    h = h ^ lshr64(h, 29)
    h = h * _P3
    return h ^ lshr64(h, 32)


def xxhash64_u64s(lanes: list[torch.Tensor], seed: torch.Tensor) -> torch.Tensor:
    """xxhash64 of a fixed number (< 4) of 8-byte lanes per row."""
    assert len(lanes) < 4
    acc = seed + (_P5 + 8 * len(lanes))
    for lane in lanes:
        acc = acc ^ _xx_round(torch.zeros_like(acc), lane)
        acc = rotl64(acc, 27) * _P1 + _P4
    return _xx_fmix(acc)


def xxhash64_i64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return xxhash64_u64s([v.to(torch.int64)], seed)


_FP_SEED = 42


def fingerprint64(words: list[torch.Tensor], bits: int = 64) -> torch.Tensor:
    """One 64-bit fingerprint per row from K canonical key words (chained
    xxhash64, the hash of word k seeds word k+1). ``bits`` < 64 truncates
    (test hook); at 64 bits UINT64_MAX is clamped away (it is the dead-row
    sentinel in sorted runs)."""
    fp = torch.full_like(words[0], _FP_SEED)
    for w in words:
        fp = xxhash64_u64s([w], fp)
    if bits < 64:
        return fp & ((1 << max(bits, 1)) - 1)
    return torch.where(fp == -1, torch.full_like(fp, -2), fp)
