"""Partition ids: the port's K1 plain version, its murmur3 dispatch and its
partitionings against auron_tpu, bit for bit. The reference's Pallas K1
runs in interpret mode where this jaxlib supports it, else its kernel body
(``_murmur3_pmod_kernel``) on host refs. The on-card kernel checks are in
test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.exec.shuffle.partitioning import HashPartitioning as JHash
from auron_tpu.exec.shuffle.partitioning import RoundRobinPartitioning as JRR
from auron_tpu.exprs.ir import col as jcol
from auron_tpu.ops import hash_dispatch as jhd
from auron_tpu.ops import pallas_kernels as jpk

from auron_tpu_torch.exec.base import ExecutionContext
from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning as PHash
from auron_tpu_torch.exec.shuffle.partitioning import RoundRobinPartitioning as PRR
from auron_tpu_torch.exec.shuffle.partitioning import SinglePartitioning as PSingle
from auron_tpu_torch.exprs.ir import col as pcol
from auron_tpu_torch.ops import hash_dispatch as phd
from auron_tpu_torch.ops import partition_kernels as ppk
from torch_carry import HostRef, carry, jax_batch

N_PARTS = (1, 3, 4, 200, 4096)
EDGES = np.array([-(2**63), 2**63 - 1, 0, -1], dtype=np.int64)


def _keys(rng, n, null_share):
    k = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True)
    k[: min(n, 4)] = EDGES[: min(n, 4)]
    valid = rng.random(n) >= null_share
    return k, valid


def _ref_kernel(keys: np.ndarray, n_parts: int) -> np.ndarray:
    """auron_tpu's K1 on 1-D int64 keys (no NULL blend)."""
    try:
        return np.asarray(jpk.partition_ids_pallas(jnp.asarray(keys), n_parts, interpret=True))
    except NotImplementedError:
        pass
    u = keys.view(np.uint64)
    out = HostRef()
    jpk._murmur3_pmod_kernel(HostRef(jnp.asarray((u & 0xFFFFFFFF).astype(np.uint32))),
                             HostRef(jnp.asarray((u >> 32).astype(np.uint32))), out,
                             seed=42, n_parts=n_parts)
    return np.asarray(out.v)


@pytest.mark.parametrize("n_parts", N_PARTS)
@pytest.mark.parametrize("n,null_share", [(1, 0.0), (1000, 0.85), (4099, 0.0), (4099, 0.5)])
def test_plain_k1_matches_reference_partitioning(n, null_share, n_parts):
    """K1's plain version and the port's HashPartitioning against the JAX
    HashPartitioning on a batch with NULLs (the NULL blend included)."""
    rng = np.random.default_rng(n * 7 + n_parts)
    k, valid = _keys(rng, n, null_share)
    jb = jax_batch({"k": k}, {"k": valid})
    want = np.asarray(JHash([jcol(0)], n_parts).partition_ids(jb, None))
    pb = carry(jb)
    got = PHash([pcol(0)], n_parts).partition_ids(pb, None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    plain = ppk.partition_ids(pb.col_values(0), pb.col_validity(0), n_parts)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert (want[~np.asarray(pb.col_validity(0))] == 42 % n_parts).all()


@pytest.mark.parametrize("n_parts", N_PARTS)
def test_plain_k1_matches_pallas_kernel_body(n_parts):
    """Negative hashes, INT64_MIN/MAX, 0 and -1, a ragged length."""
    rng = np.random.default_rng(n_parts)
    k, _ = _keys(rng, 1000 + 37, 0.0)
    want = _ref_kernel(k, n_parts)
    got = ppk.plain_partition_ids(torch.from_numpy(k), torch.ones(len(k), dtype=torch.bool),
                                  n_parts)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((want >= 0) & (want < n_parts)).all()


def test_k1_wrapper_device_contract():
    """A CPU tensor runs the plain version and counts no launch; bad inputs
    to the kernel entry raise instead of falling back."""
    before = dict(ppk.LAUNCHES)
    k = torch.arange(10, dtype=torch.int64)
    ppk.partition_ids(k, torch.ones(10, dtype=torch.bool), 4)
    assert ppk.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA int64"):
        ppk.launch_partition_ids(k, torch.ones(10, dtype=torch.bool), 4)


def test_single_int64_key_routes_to_k1(monkeypatch):
    """HashPartitioning sends one int64 key to the K1 wrapper and two keys
    to the murmur3 dispatch."""
    calls = []
    real = ppk.partition_ids
    monkeypatch.setattr(ppk, "partition_ids", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(3)
    pb = carry(jax_batch({"a": rng.integers(0, 9, 50), "b": rng.integers(0, 9, 50)}))
    PHash([pcol(0)], 4).partition_ids(pb, None)
    assert calls == [1]
    PHash([pcol(0), pcol(1)], 4).partition_ids(pb, None)
    assert calls == [1]


@pytest.mark.parametrize("n_parts", (4, 7))
def test_two_int32_keys_match_reference(n_parts):
    """q3's exchange key (d_year, i_brand_id): the chained murmur3."""
    rng = np.random.default_rng(5)
    n = 3000
    cols = {"d_year": rng.integers(1998, 2003, n).astype(np.int32),
            "i_brand_id": rng.integers(1_000_000, 1_010_000, n).astype(np.int32)}
    valid = {"i_brand_id": rng.random(n) > 0.1}
    jb = jax_batch(cols, valid)
    want = np.asarray(JHash([jcol(0), jcol(1)], n_parts).partition_ids(jb, None))
    got = PHash([pcol(0), pcol(1)], n_parts).partition_ids(carry(jb), None)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("typ", ["int8", "int16", "int32", "int64", "float32", "float64",
                                 "bool", "date32", "timestamp", "decimal"])
def test_hash_batch_fixed_types_match_reference(typ):
    rng = np.random.default_rng(11)
    n = 700
    if typ == "bool":
        arr = pa.array(rng.random(n) < 0.5)
    elif typ.startswith("float"):
        v = rng.normal(0, 1e6, n).astype(typ)
        v[:3] = [0.0, -0.0, np.inf]
        arr = pa.array(v)
    elif typ == "date32":
        arr = pa.array(rng.integers(-5000, 20000, n).astype(np.int32)).cast(pa.date32())
    elif typ == "timestamp":
        arr = pa.array(rng.integers(-2**50, 2**50, n)).cast(pa.timestamp("us"))
    elif typ == "decimal":
        import decimal

        arr = pa.array([decimal.Decimal(int(x)).scaleb(-2) for x in
                        rng.integers(-10**12, 10**12, n)], type=pa.decimal128(14, 2))
    else:
        info = np.iinfo(typ)
        arr = pa.array(rng.integers(info.min, info.max, n, endpoint=True).astype(typ))
    mask = rng.random(n) < 0.2
    arr = pa.array(arr.to_pylist(), type=arr.type, mask=mask)
    jb = JBatch.from_arrow(pa.RecordBatch.from_arrays([arr, arr], names=["a", "b"]))
    want = np.asarray(jhd.hash_batch(jb, [0, 1], "murmur3", 42))
    got = phd.hash_batch(carry(jb), [0, 1], "murmur3", 42)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("task_partition", (0, 3))
def test_round_robin_and_single_match_reference(task_partition):
    rng = np.random.default_rng(task_partition)
    jb = jax_batch({"a": rng.integers(0, 100, 1000)})
    import auron_tpu.exec.base as jbase

    jctx = jbase.ExecutionContext(partition_id=task_partition)
    want = np.asarray(JRR(5).partition_ids(jb, jctx))
    got = PRR(5).partition_ids(carry(jb), ExecutionContext(partition_id=task_partition))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not PSingle().partition_ids(carry(jb), None).any()


@pytest.mark.parametrize("n_parts", (1, 4, 7))
@pytest.mark.parametrize("order", ["string_first", "string_second"])
def test_dictionary_string_keys_match_reference(n_parts, order):
    """Spark's murmur3 over UTF-8 bytes (aligned words, then each trailing
    byte sign-extended): empty, 1-3 byte tails, multi-byte characters,
    bytes >= 0x80 and NULLs, alone and chained with an int key."""
    rng = np.random.default_rng(n_parts * 3 + len(order))
    pool = np.array(["", "a", "ab", "abc", "abcd", "héllo wörld", "key_17", "ÿ\u0080",
                     "日本語テキスト", "x" * 37], dtype=object)
    n = 800
    s = pool[rng.integers(0, len(pool), n)]
    g = rng.integers(-5, 5, n)
    cols = {"s": s, "g": g} if order == "string_first" else {"g": g, "s": s}
    jb = jax_batch(cols, {"s": rng.random(n) > 0.2})
    for keys in ([0], [0, 1]):
        want = np.asarray(jhd.hash_batch(jb, keys, "murmur3", 42))
        np.testing.assert_array_equal(phd.hash_batch(carry(jb), keys, "murmur3", 42).numpy(),
                                      want)
        want_p = np.asarray(JHash([jcol(k) for k in keys], n_parts).partition_ids(jb, None))
        got_p = PHash([pcol(k) for k in keys], n_parts).partition_ids(carry(jb), None)
        np.testing.assert_array_equal(got_p.numpy(), want_p)
