"""Unsigned-word carriers, hashes and sort-key words of auron_tpu_torch,
bit-exact against auron_tpu on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auron_tpu import types as JT
from auron_tpu.exprs.eval import ColumnVal as JCV
from auron_tpu.ops import bitonic as jbitonic
from auron_tpu.ops import hashing as jhash
from auron_tpu.ops import segments as jseg
from auron_tpu.ops import sortkeys as jsk

from auron_tpu_torch import types as PT
from auron_tpu_torch.exprs.eval import ColumnVal as PCV
from auron_tpu_torch.ops import bitonic as pbitonic
from auron_tpu_torch.ops import hashing as phash
from auron_tpu_torch.ops import segments as pseg
from auron_tpu_torch.ops import sortkeys as psk
from auron_tpu_torch.ops import uwords as U

_N = 4096


def _u64(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**64, _N, dtype=np.uint64)
    a[:8] = [0, 1, 2**63 - 1, 2**63, 2**64 - 1, 2**32 - 1, 2**32, 2**31]
    return a


def _t(a):
    return U.from_u64_numpy(a, "cpu")


@pytest.mark.parametrize("r", [1, 13, 31, 32, 33, 63])
def test_logical_shift_and_rotate(r):
    a = _u64(r)
    np.testing.assert_array_equal(U.u64_numpy(U.lshr64(_t(a), r)), a >> np.uint64(r))
    want = (a << np.uint64(r)) | (a >> np.uint64(64 - r))
    np.testing.assert_array_equal(U.u64_numpy(U.rotl64(_t(a), r)), want)


def test_unsigned_compare_and_words():
    a, b = _u64(1), _u64(2)
    np.testing.assert_array_equal(U.lt_u64(_t(a), _t(b)).numpy(), a < b)
    np.testing.assert_array_equal(U.u64_numpy(U.lo32(_t(a))), a & np.uint64(0xFFFFFFFF))
    np.testing.assert_array_equal(U.u64_numpy(U.hi32(_t(a))), a >> np.uint64(32))
    np.testing.assert_array_equal(U.u64_numpy(U.join32(U.hi32(_t(a)), U.lo32(_t(a)))), a)


def test_mul32_rotl32_and_i32_roundtrip():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, _N, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, _N, dtype=np.uint64).astype(np.uint32)
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    np.testing.assert_array_equal(U.mul32(ta, tb).numpy().astype(np.uint32), a * b)
    np.testing.assert_array_equal(U.rotl32(ta, 15).numpy().astype(np.uint32),
                                  (a << np.uint32(15)) | (a >> np.uint32(17)))
    i32 = U.i32_of_u32(ta)
    np.testing.assert_array_equal(i32.numpy(), a.view(np.int32))
    np.testing.assert_array_equal(U.u32_of_i32(i32).numpy(), a.astype(np.int64))


def test_murmur3_matches_reference():
    rng = np.random.default_rng(4)
    v64 = rng.integers(-(2**63), 2**63 - 1, _N, dtype=np.int64)
    v32 = v64.astype(np.int32)
    seed = jnp.uint32(42)
    want64 = np.asarray(jhash.murmur3_i64(jnp.asarray(v64), seed))
    want32 = np.asarray(jhash.murmur3_i32(jnp.asarray(v32), seed))
    got64 = phash.murmur3_i64(torch.from_numpy(v64), torch.tensor(42))
    got32 = phash.murmur3_i32(torch.from_numpy(v32), torch.tensor(42))
    np.testing.assert_array_equal(got64.numpy().astype(np.uint32), want64)
    np.testing.assert_array_equal(got32.numpy().astype(np.uint32), want32)
    want_p = np.asarray(jhash.pmod(jnp.asarray(want64.view(np.int32)), 7))
    got_p = phash.pmod(phash.spark_hash_i32(got64), 7)
    np.testing.assert_array_equal(got_p.numpy(), want_p)


@pytest.mark.parametrize("bits", [64, 12])
def test_fingerprint64_matches_reference(bits):
    words = [_u64(5), _u64(6), _u64(7)]
    want = np.asarray(jhash.fingerprint64([jnp.asarray(w) for w in words], bits))
    got = phash.fingerprint64([_t(w) for w in words], bits)
    np.testing.assert_array_equal(U.u64_numpy(got), want)
    xw = np.asarray(jhash.xxhash64_i64(jnp.asarray(words[0].view(np.int64)), jnp.uint64(42)))
    xg = phash.xxhash64_i64(_t(words[0]), torch.full((_N,), 42))
    np.testing.assert_array_equal(U.u64_numpy(xg), xw)


def _colvals(kind, seed):
    rng = np.random.default_rng(seed)
    valid = rng.random(_N) > 0.1
    if kind == "int32":
        v = rng.integers(-(2**31), 2**31 - 1, _N).astype(np.int32)
    elif kind == "int64":
        v = rng.integers(-(2**63), 2**63 - 1, _N, dtype=np.int64)
    elif kind == "float32":
        v = rng.standard_normal(_N).astype(np.float32)
        v[:4] = [0.0, -0.0, np.nan, np.inf]
    elif kind == "float64":
        v = rng.standard_normal(_N) * 1e6
        v[:4] = [0.0, -0.0, np.nan, -np.inf]
    else:
        v = rng.random(_N) > 0.5
    jt = getattr(JT, kind.upper() if kind != "bool" else "BOOL")
    pt = getattr(PT, kind.upper() if kind != "bool" else "BOOL")
    return (JCV(jnp.asarray(v), jnp.asarray(valid), jt),
            PCV(torch.from_numpy(v), torch.from_numpy(valid), pt))


@pytest.mark.parametrize("kind", ["int32", "int64", "float32", "float64", "bool"])
def test_sort_and_group_words_match_reference(kind):
    jc, pc = _colvals(kind, 8)
    for spec in (jsk.SortSpec(), jsk.SortSpec(asc=False, nulls_first=False)):
        want = jsk.sort_operands([jc], [spec])
        got = psk.sort_operands([pc], [psk.SortSpec(spec.asc, spec.nulls_first)])
        for w, g in zip(want, got):
            np.testing.assert_array_equal(U.u64_numpy(g), np.asarray(w))
    for w, g in zip(jseg.key_words([jc, jc]), pseg.key_words([pc, pc])):
        np.testing.assert_array_equal(U.u64_numpy(g), np.asarray(w))


@pytest.mark.parametrize("case", ["uint64", "uint64_narrow", "int64", "int32", "uint32"])
def test_split_planes_carrier_roundtrip(case):
    """The carrier convention round-trips every _split_planes dtype case:
    the port's planes equal the reference's uint32 planes bit for bit, and
    joining them back restores the operand."""
    rng = np.random.default_rng(9)
    if case.startswith("uint64"):
        a = _u64(10)
        if case == "uint64_narrow":
            a = a & np.uint64(0xFFFFFFFF)
        jop, pop, kind = jnp.asarray(a), _t(a), "u64"
    elif case == "int64":
        a = _u64(11).view(np.int64)
        jop, pop, kind = jnp.asarray(a), torch.from_numpy(a), "i64"
    elif case == "int32":
        a = rng.integers(-(2**31), 2**31 - 1, _N).astype(np.int32)
        jop, pop, kind = jnp.asarray(a), torch.from_numpy(a), "i32"
    else:
        a = rng.integers(0, 2**32, _N, dtype=np.uint64).astype(np.uint32)
        jop, pop, kind = jnp.asarray(a), torch.from_numpy(a.astype(np.int64)), "u32"
    narrow = case == "uint64_narrow"
    want = jbitonic._split_planes((jop,), (narrow,))
    got = pbitonic._split_planes((pop,), (narrow,), (kind,))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    back = pbitonic._join_planes(torch.stack(got), (pop,), (narrow,), (kind,))[0]
    assert torch.equal(back, pop)
    # the int32 storage planes the CUDA kernels read carry the same bits
    got32 = pbitonic._split_planes32((pop,), (narrow,), (kind,))
    assert all(g.dtype == torch.int32 for g in got32)
    for w, g in zip(want, got32):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
    back32 = pbitonic._join_planes32(torch.stack(got32), (pop,), (narrow,), (kind,))[0]
    assert back32.dtype == pop.dtype and torch.equal(back32, pop)
