"""Bit-exact Spark hashes and group-key fingerprints as torch functions.

Port of ``auron_tpu/ops/hashing.py`` (murmur3_x86_32 Spark variant and
xxhash64 of 4- and 8-byte values, floats, decimals and byte strings,
``fingerprint64``, ``pmod``) on the carrier convention of
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


def murmur3_i128_from_i64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark hash of a decimal128: 16 LE bytes of the unscaled value,
    sign-extended from the decimal64 plane."""
    u = v.to(torch.int64)
    ext = torch.where(u < 0, MASK32, 0)
    return murmur3_words([lo32(u), hi32(u), ext, ext], seed)


def murmur3_f32(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return murmur3_words([u32_of_i32(v.to(torch.float32).view(torch.int32))], seed)


def murmur3_f64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    u = v.to(torch.float64).view(torch.int64)
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


def xxhash64_i32(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """4-byte values hash as Spark hashes them: sign-extended longs."""
    return xxhash64_u64s([v.to(torch.int32).to(torch.int64)], seed)


def xxhash64_i64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return xxhash64_u64s([v.to(torch.int64)], seed)


def xxhash64_i128_from_i64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    u = v.to(torch.int64)
    return xxhash64_u64s([u, torch.where(u < 0, -1, 0)], seed)


def xxhash64_f32(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The float's 32-bit pattern, zero-extended to one 8-byte lane."""
    return xxhash64_u64s([u32_of_i32(v.to(torch.float32).view(torch.int32))], seed)


def xxhash64_f64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return xxhash64_u64s([v.to(torch.float64).view(torch.int64)], seed)


def _xx_merge(acc, lane_acc):
    return (acc ^ _xx_round(torch.zeros_like(acc), lane_acc)) * _P1 + _P4


def xxhash64_bytes(bytes_u8: torch.Tensor, lengths: torch.Tensor,
                   seed: torch.Tensor) -> torch.Tensor:
    """Standard xxHash64 of per-row byte strings (a zero-padded ``[n, W]``
    uint8 matrix, W a multiple of 4, and the lengths): the four-accumulator
    path over 32-byte stripes for rows of 32 bytes or more, then the 8-byte
    lanes, one 4-byte word and the single trailing bytes, each round masked
    past the row's length so one fixed loop serves every row (reference
    ``ops/hashing.py:177-264``)."""
    n, width = bytes_u8.shape
    lengths = lengths.to(torch.int64)
    seed = seed.to(torch.int64).expand(n)
    pad = (-width) % 32
    if pad:
        bytes_u8 = torch.cat([bytes_u8, bytes_u8.new_zeros((n, pad))], dim=1)
        width += pad
    b = bytes_u8.to(torch.int64)
    n_lanes = width // 8
    b8 = b.reshape(n, n_lanes, 8)
    lanes = b8[:, :, 0]
    for k in range(1, 8):
        lanes = lanes | (b8[:, :, k] << (8 * k))
    b4 = b.reshape(n, width // 4, 4)
    words = b4[:, :, 0] | (b4[:, :, 1] << 8) | (b4[:, :, 2] << 16) | (b4[:, :, 3] << 24)

    total_stripes = lengths // 32
    v1 = seed + i64(_P1 + _P2)
    v2 = seed + _P2
    v3 = seed
    v4 = seed - _P1
    for s in range(width // 32):
        m = s < total_stripes
        v1 = torch.where(m, _xx_round(v1, lanes[:, 4 * s]), v1)
        v2 = torch.where(m, _xx_round(v2, lanes[:, 4 * s + 1]), v2)
        v3 = torch.where(m, _xx_round(v3, lanes[:, 4 * s + 2]), v3)
        v4 = torch.where(m, _xx_round(v4, lanes[:, 4 * s + 3]), v4)
    merged = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18)
    for v in (v1, v2, v3, v4):
        merged = _xx_merge(merged, v)
    acc = torch.where(lengths >= 32, merged, seed + _P5) + lengths

    consumed_lanes = total_stripes * 4
    total_lanes = lengths // 8
    for i in range(3):
        lane_idx = (consumed_lanes + i).clamp(max=n_lanes - 1)
        lane = lanes.gather(1, lane_idx[:, None])[:, 0]
        stepped = rotl64(acc ^ _xx_round(torch.zeros_like(acc), lane), 27) * _P1 + _P4
        acc = torch.where(consumed_lanes + i < total_lanes, stepped, acc)

    consumed = total_lanes * 8
    word = words.gather(1, (consumed // 4).clamp(max=width // 4 - 1)[:, None])[:, 0]
    has_word = consumed + 4 <= lengths
    acc = torch.where(has_word, rotl64(acc ^ (word * _P1), 23) * _P2 + _P3, acc)
    consumed = torch.where(has_word, consumed + 4, consumed)
    for t in range(7):
        pos = (consumed + t).clamp(max=width - 1)
        byte = b.gather(1, pos[:, None])[:, 0]
        stepped = rotl64(acc ^ (byte * _P5), 11) * _P1
        acc = torch.where(consumed + t < lengths, stepped, acc)
    return _xx_fmix(acc)


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
