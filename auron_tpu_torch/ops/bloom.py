"""Spark-compatible bloom filter (the runtime filter of
``bloom_filter_might_contain``).

Port of ``auron_tpu/ops/bloom.py`` (Spark's BloomFilterImpl): k probes
from the 32-bit murmur3 double hash (h1 = hash(item, 0), h2 = hash(item,
h1), probe_i = h1 + i * h2 as int32, a negative flipped by ``~``, mod the
bit count). The bit array lives on the device as 32-bit words carried in
int64 (``ops/uwords.py``), so a probe over a column is a gather and a bit
test per hash. The serialized form is the reference's, byte for byte: a
little-endian header (version 1, hash count, bit count) and the words as
little-endian uint32, so a filter written by either package reads in the
other.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from auron_tpu_torch.device import resolve_device
from auron_tpu_torch.ops import hashing as H
from auron_tpu_torch.ops.uwords import MASK32, i32_of_u32


def optimal_num_bits(n_items: int, fpp: float) -> int:
    return max(64, int(-n_items * math.log(fpp) / (math.log(2) ** 2)))


def optimal_num_hashes(n_items: int, n_bits: int) -> int:
    return max(1, round(n_bits / max(n_items, 1) * math.log(2)))


class SparkBloomFilter:
    """``device`` places a new filter's words (``device.resolve_device``: the
    card unless the caller asks for the CPU); given ``words`` keep theirs."""

    def __init__(self, num_bits: int, num_hashes: int, words: torch.Tensor | None = None,
                 device=None):
        self.num_bits = (num_bits + 31) & ~31
        self.num_hashes = num_hashes
        self.words = (words if words is not None
                      else torch.zeros(self.num_bits // 32, dtype=torch.int64,
                                       device=resolve_device(device)))

    @staticmethod
    def create(expected_items: int, fpp: float = 0.03, device=None) -> "SparkBloomFilter":
        bits = optimal_num_bits(expected_items, fpp)
        return SparkBloomFilter(bits, optimal_num_hashes(expected_items, bits), device=device)

    def _probe_bits(self, values_i64: torch.Tensor) -> torch.Tensor:
        """``[n, k]`` bit positions per value (Spark's double-hash scheme)."""
        v = values_i64.to(torch.int64)
        h1_u = H.murmur3_i64(v, torch.zeros_like(v))
        h1 = i32_of_u32(h1_u).to(torch.int64)
        h2 = i32_of_u32(H.murmur3_i64(v, h1_u)).to(torch.int64)
        probes = []
        for i in range(1, self.num_hashes + 1):
            combined = i32_of_u32((h1 + i * h2) & MASK32).to(torch.int64)
            combined = torch.where(combined < 0, ~combined, combined)
            probes.append(torch.remainder(combined, self.num_bits))
        return torch.stack(probes, dim=1)

    def put_long(self, values_i64: torch.Tensor, valid: torch.Tensor | None = None) -> None:
        """Set the probe bits of every value (of the valid ones, when given)."""
        bits = self._probe_bits(values_i64)
        if valid is not None:
            bits = torch.where(valid[:, None], bits, self.num_bits)  # past the end: dropped
        hits = torch.zeros(self.num_bits + 1, dtype=torch.bool, device=bits.device)
        hits[bits.reshape(-1)] = True
        shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
        packed = (hits[:-1].reshape(-1, 32).to(torch.int64) << shifts).sum(dim=1)
        self.words = self.words.to(bits.device) | packed

    def might_contain_long(self, values_i64: torch.Tensor) -> torch.Tensor:
        bits = self._probe_bits(values_i64)
        words = self.words.to(bits.device)[bits // 32]
        return (((words >> (bits % 32)) & 1) == 1).all(dim=1)

    def merge(self, other: "SparkBloomFilter") -> "SparkBloomFilter":
        assert self.num_bits == other.num_bits and self.num_hashes == other.num_hashes
        return SparkBloomFilter(self.num_bits, self.num_hashes, self.words | other.words)

    def serialize(self) -> bytes:
        w = self.words.cpu().numpy().astype("<u4").tobytes()
        return struct.pack("<III", 1, self.num_hashes, self.num_bits) + w

    @staticmethod
    def deserialize(data: bytes, device=None) -> "SparkBloomFilter":
        version, k, num_bits = struct.unpack_from("<III", data, 0)
        if version != 1:
            raise ValueError(f"bloom filter version {version} is not supported")
        words = np.frombuffer(bytes(data[12:]), dtype="<u4").astype(np.int64)
        return SparkBloomFilter(num_bits, k, torch.from_numpy(words).to(resolve_device(device)))
