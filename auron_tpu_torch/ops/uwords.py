"""Unsigned-word carriers: uint32/uint64 math on int32/int64 tensors.

torch has no ``>>``, ``<<``, ``<``, ``+`` or ``%`` for ``uint32``/``uint64``
on the CPU, so the port carries the JAX package's unsigned key words,
hashes and sort planes as signed tensors holding the same bits:

- a uint64 word rides as the int64 with the same 64 bits;
- a uint32 value rides as an int64 in [0, 2^32) (arithmetic carrier), or as
  the int32 with the same 32 bits (storage carrier, what the CUDA kernel
  reads as ``unsigned``);
- a logical right shift is an arithmetic shift then a mask;
- an unsigned compare flips the sign bit, then compares signed;
- a product mod 2^32 is the int64 product masked to 32 bits; int64
  add/mul wrap mod 2^64 exactly like uint64.

Every helper here is pinned bit-exact against ``auron_tpu`` in
tests/test_torch_words.py.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
SIGN64 = -(1 << 63)  # int64 bit pattern of 0x8000000000000000


def i64(c: int) -> int:
    """Python int of a uint64 constant's int64 bit pattern."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= (1 << 63) else c


def lshr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of uint64 bits carried in int64."""
    if r == 0:
        return x
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | lshr64(x, 64 - r)


def flip(x: torch.Tensor) -> torch.Tensor:
    """Sign-bit flip: signed order of the result == unsigned order of x."""
    return x ^ SIGN64


def lt_u64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return flip(a) < flip(b)


def lo32(x: torch.Tensor) -> torch.Tensor:
    """Low uint32 word of a uint64 carrier, as an int64 carrier."""
    return x & MASK32


def hi32(x: torch.Tensor) -> torch.Tensor:
    """High uint32 word of a uint64 carrier, as an int64 carrier."""
    return lshr64(x, 32)


def join32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """uint64 carrier from two uint32 int64 carriers."""
    return (hi << 32) | lo


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 on uint32 int64 carriers."""
    return (a * b) & MASK32


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def u32_of_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> uint32 int64 carrier."""
    return x.to(torch.int64) & MASK32


def i32_of_u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 int64 carrier -> int32 with the same bits (wraps, never
    relies on an out-of-range narrowing conversion)."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def u64_numpy(x: torch.Tensor) -> np.ndarray:
    """uint64 view of an int64 carrier (host copy)."""
    return x.detach().cpu().numpy().view(np.uint64)


def from_u64_numpy(a: np.ndarray, device) -> torch.Tensor:
    """An int64 carrier of uint64 values on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64)).to(device)
