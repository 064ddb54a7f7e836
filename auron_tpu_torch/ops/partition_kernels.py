"""Hand-written kernels for partitioning: partition ids (K1) and rows per
partition (K2).

Port of ``auron_tpu/ops/pallas_kernels.py``:

K1 (``partition_ids_pallas`` with its body ``_murmur3_pmod_kernel``):
Spark ``Pmod(murmur3_32(long, seed 42), n)`` per row of one int64 key
column, with the NULL blend of the JAX caller
(``exec/shuffle/partitioning.py:49-65``: a NULL key leaves the running hash
at the seed, so its id is ``pmod(seed, n)``) done in the same pass.

- ``partition_ids`` is the wrapper: on a CUDA tensor it launches
  ``auron_murmur3_pmod`` from ``csrc/partition.cu`` (nvcc + ctypes,
  built at first use by ``ops/cuda_build.py``) or raises; it never falls
  back. On a CPU tensor it runs ``plain_partition_ids``.
- ``plain_partition_ids`` is the plain torch version (``murmur3_i64`` +
  ``pmod`` + ``torch.where`` from ``ops/hashing.py``). The CPU tests use
  it, and ``chip_smoke.py`` holds the kernel against it on the card.

Bound: bytes (8 key + 1 validity read, 4 id written per row); see the
kernel source for what its design does about it.

K2 (``partition_histogram_pallas`` with its body ``_histogram_kernel``):
int32 rows per partition id, the exact routing counts of the planned
exchange (``parallel/mesh_driver.py``). Ids outside ``[0, n_parts)`` and
rows whose ``sel`` is False fall out of every bucket: the JAX caller's
``jnp.where(sel, pid, -1)`` blend, done inside the kernel.

- ``partition_histogram`` is the wrapper: on a CUDA tensor it launches
  ``auron_partition_histogram`` (same library as K1) or raises; on a CPU
  tensor it runs ``plain_partition_histogram``.
- ``plain_partition_histogram`` is ``torch.bincount`` over the blended ids.

Bound: bytes (4 id + 1 sel byte read per row, ``n_parts`` ints written).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from auron_tpu_torch.ops import launch_count
from auron_tpu_torch.ops.hashing import murmur3_i64, pmod, spark_hash_i32

SEED = 42

#: launch counts, one per wrapper call that launched its kernel
LAUNCHES = {"murmur3_pmod": 0, "partition_histogram": 0}
_launch_lock = threading.Lock()
_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from auron_tpu_torch.ops import cuda_build

        lib = cuda_build.load("partition")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.auron_murmur3_pmod.argtypes = [vp, vp, vp, ctypes.c_longlong, ci, ctypes.c_uint, vp]
        lib.auron_murmur3_pmod.restype = ci
        lib.auron_partition_histogram.argtypes = [vp, vp, vp, ctypes.c_longlong, ci, vp]
        lib.auron_partition_histogram.restype = ci
        lib.auron_partition_histogram_shared_parts.argtypes = []
        lib.auron_partition_histogram_shared_parts.restype = ci
        lib.auron_partition_error_string.argtypes = [ci]
        lib.auron_partition_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def null_pid(n_parts: int, seed: int = SEED) -> int:
    """The id of a NULL key: Spark's pmod of the untouched seed."""
    return seed % n_parts


def plain_partition_ids(values: torch.Tensor, validity: torch.Tensor, n_parts: int,
                        seed: int = SEED) -> torch.Tensor:
    """The plain torch version of K1 (any device)."""
    h = murmur3_i64(values, torch.full_like(values, seed, dtype=torch.int64))
    pids = pmod(spark_hash_i32(h), n_parts)
    return torch.where(validity, pids, torch.full_like(pids, null_pid(n_parts, seed)))


def launch_partition_ids(values: torch.Tensor, validity: torch.Tensor, n_parts: int,
                         seed: int = SEED) -> torch.Tensor:
    """Launch K1 on the card: int32 ids of ``values`` (int64) with NULLs
    (``validity`` False) at ``pmod(seed, n_parts)``."""
    if not (values.is_cuda and values.dtype == torch.int64 and values.dim() == 1):
        raise ValueError("murmur3_pmod takes a 1-D CUDA int64 key tensor")
    if not (validity.device == values.device and validity.dtype == torch.bool
            and validity.shape == values.shape):
        raise ValueError("murmur3_pmod takes a bool validity tensor beside the keys")
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    keys = values.contiguous()
    valid = validity.contiguous()
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    n = keys.shape[0]
    if n == 0:
        return out
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = _lib().auron_murmur3_pmod(
        ctypes.c_void_p(keys.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), n, int(n_parts), seed & 0xFFFFFFFF,
        ctypes.c_void_p(stream))
    _launched("murmur3_pmod", rc)
    return out


def _launched(name: str, rc: int) -> None:
    """Raise on a refused launch, else count it."""
    if rc != 0:
        msg = _lib().auron_partition_error_string(rc).decode()
        raise RuntimeError(f"{name} CUDA kernel failed: error {rc} ({msg})")
    launch_count.add(LAUNCHES, _launch_lock, name)


def partition_ids(values: torch.Tensor, validity: torch.Tensor, n_parts: int,
                  seed: int = SEED) -> torch.Tensor:
    """Spark Pmod(murmur3(long), n) with NULL keys at pmod(seed, n): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if values.is_cuda:
        return launch_partition_ids(values, validity, n_parts, seed)
    return plain_partition_ids(values, validity, n_parts, seed)


def plain_partition_histogram(pids: torch.Tensor, n_parts: int,
                              sel: torch.Tensor | None = None) -> torch.Tensor:
    """The plain torch version of K2 (any device): bincount of the ids,
    with dead rows and out-of-range ids sent to a dropped last bucket."""
    live = (pids >= 0) & (pids < n_parts)
    if sel is not None:
        live &= sel
    blended = torch.where(live, pids.to(torch.int64), n_parts)
    return torch.bincount(blended, minlength=n_parts + 1)[:n_parts].to(torch.int32)


def histogram_shared_parts() -> int:
    """The largest ``n_parts`` K2 counts in shared memory (more use its
    global-atomic branch)."""
    return int(_lib().auron_partition_histogram_shared_parts())


def launch_partition_histogram(pids: torch.Tensor, n_parts: int,
                               sel: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K2 on the card: int32 ``[n_parts]`` live rows per id."""
    if not (pids.is_cuda and pids.dtype == torch.int32 and pids.dim() == 1):
        raise ValueError("partition_histogram takes a 1-D CUDA int32 id tensor")
    if sel is not None and not (sel.device == pids.device and sel.dtype == torch.bool
                                and sel.shape == pids.shape):
        raise ValueError("partition_histogram takes a bool sel tensor beside the ids")
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    ids = pids.contiguous()
    live = None if sel is None else sel.contiguous()
    out = torch.zeros(n_parts, dtype=torch.int32, device=ids.device)
    n = ids.shape[0]
    if n == 0:
        return out
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    rc = _lib().auron_partition_histogram(
        ctypes.c_void_p(ids.data_ptr()),
        ctypes.c_void_p(None if live is None else live.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), n, int(n_parts), ctypes.c_void_p(stream))
    _launched("partition_histogram", rc)
    return out


def partition_histogram(pids: torch.Tensor, n_parts: int,
                        sel: torch.Tensor | None = None) -> torch.Tensor:
    """Rows per partition id (ids outside [0, n_parts) and rows with sel
    False dropped): the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if pids.is_cuda:
        return launch_partition_histogram(pids, n_parts, sel)
    return plain_partition_histogram(pids, n_parts, sel)
