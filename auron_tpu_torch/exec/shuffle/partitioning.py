"""Repartitioning strategies (port of ``auron_tpu/exec/shuffle/partitioning.py``).

Each returns a per-row int32 partition id tensor on the batch's device:
Hash (Spark murmur3 + Pmod, bit-exact so reducers receive exactly the rows
the host engine expects), RoundRobin (per-task cursor), Range (host-sampled
bound words against the rows' orderable sort words) and Single. The
eager ``_hash_pids`` policy is the JAX package's: a single non-dictionary
int64 key runs the partition-id kernel K1 (``ops/partition_kernels.py``)
with NULL keys blended to ``pmod(42, n)``; every other key list runs the
chained murmur3 of ``ops/hash_dispatch.py``.

``fuse_spec`` is the static description a whole-stage fused writer stage
carries (``plan/fusion.py``); ``partition_ids_of`` computes the ids from it
inside the stage program with the SAME policy, K1 included (its wrapper
launches on torch's current stream, so a CUDA-graph capture records it).
``RangePartitioning`` has no ``fuse_spec``, as in the reference: a writer
stage over a range exchange stays eager.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exprs.eval import ColumnVal, Evaluator
from auron_tpu_torch.ops import partition_kernels
from auron_tpu_torch.ops.hash_dispatch import hash_batch
from auron_tpu_torch.ops.hashing import pmod
from auron_tpu_torch.ops.sortkeys import sort_operands
from auron_tpu_torch.ops.uwords import SIGN64, flip, i64, u64_numpy

_K1_KINDS = (T.TypeKind.INT64, T.TypeKind.TIMESTAMP)


class Partitioning:
    num_partitions: int

    def partition_ids(self, batch: Batch, ctx) -> torch.Tensor:
        raise NotImplementedError

    def fuse_spec(self, schema: T.Schema) -> tuple | None:
        """Hashable description for a fused writer stage, or None when this
        partitioning cannot ride a stage program."""
        return None


#: key kinds a fused stage may hash (fixed-width, no vocabulary)
_FUSE_HASHABLE = (T.TypeKind.BOOL, T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32,
                  T.TypeKind.INT64, T.TypeKind.FLOAT32, T.TypeKind.FLOAT64, T.TypeKind.DATE32,
                  T.TypeKind.TIMESTAMP, T.TypeKind.DECIMAL)


def _roundrobin_pids(sel: torch.Tensor, start, n_out: int) -> torch.Tensor:
    ordinal = torch.cumsum(sel.to(torch.int32), 0) - 1
    return torch.remainder(ordinal + start, n_out).to(torch.int32)


def partition_ids_of(spec: tuple, batch: Batch, n_out: int, rr_start=None) -> torch.Tensor:
    """The ids a ``fuse_spec`` describes, by the eager policy (a stage
    program's twin of ``partition_ids``): ``rr_start`` is a device scalar,
    so one program serves every task partition."""
    if spec[0] == "single":
        return torch.zeros(batch.capacity, dtype=torch.int32, device=batch.torch_device)
    if spec[0] == "roundrobin":
        return _roundrobin_pids(batch.device.sel, rr_start, n_out)
    vals = Evaluator(batch.schema).evaluate(batch, list(spec[1]))
    return _hash_pids(vals, batch.device.sel, n_out)


def _hash_pids(vals: list[ColumnVal], sel: torch.Tensor, n_out: int) -> torch.Tensor:
    if len(vals) == 1 and vals[0].dict is None and vals[0].dtype.kind in _K1_KINDS:
        return partition_kernels.partition_ids(vals[0].values, vals[0].validity, n_out)
    from auron_tpu_torch.exec.basic import batch_from_columns

    kb = batch_from_columns(vals, [f"k{i}" for i in range(len(vals))], sel)
    return pmod(hash_batch(kb, list(range(len(vals))), "murmur3", seed=42), n_out)


@dataclass
class SinglePartitioning(Partitioning):
    num_partitions: int = 1

    def partition_ids(self, batch: Batch, ctx) -> torch.Tensor:
        return torch.zeros(batch.capacity, dtype=torch.int32, device=batch.torch_device)

    def fuse_spec(self, schema: T.Schema) -> tuple | None:
        return ("single",)


@dataclass
class HashPartitioning(Partitioning):
    exprs: list
    num_partitions: int

    def partition_ids(self, batch: Batch, ctx) -> torch.Tensor:
        vals = Evaluator(batch.schema).evaluate(batch, self.exprs)
        return _hash_pids(vals, batch.device.sel, self.num_partitions)

    def fuse_spec(self, schema: T.Schema) -> tuple | None:
        for e in self.exprs:
            dt = e.dtype_of(schema)
            if dt.is_dict_encoded or dt.kind not in _FUSE_HASHABLE:
                return None
        return ("hash", tuple(self.exprs))


@dataclass
class RoundRobinPartitioning(Partitioning):
    num_partitions: int

    def partition_ids(self, batch: Batch, ctx) -> torch.Tensor:
        # deterministic start per task partition (shuffle/mod.rs RoundRobin)
        start = (ctx.partition_id if ctx is not None else 0) % self.num_partitions
        return _roundrobin_pids(batch.device.sel, start, self.num_partitions)

    def fuse_spec(self, schema: T.Schema) -> tuple | None:
        return ("roundrobin",)


@dataclass
class RangePartitioning(Partitioning):
    """Spark's RangePartitioner over host-sampled bounds (reference
    ``partitioning.py:166-199``): ``bound_words`` holds one row of uint64
    sort words per bound, as ``sort_operands`` encodes the keys, so the
    unsigned order of the words is the ORDER BY."""

    sort_exprs: list
    specs: list
    num_partitions: int
    bound_words: np.ndarray = field(default=None)  # [num_bounds, n_words] uint64

    def partition_ids(self, batch: Batch, ctx) -> torch.Tensor:
        keys = Evaluator(batch.schema).evaluate(batch, self.sort_exprs)
        # the words' unsigned order as the signed order of their flipped bits
        words = [flip(w) for w in sort_operands(keys, self.specs)]
        n = batch.capacity
        pid = torch.zeros(n, dtype=torch.int32, device=batch.torch_device)
        # a row goes to the first partition whose bound is >= its key: the
        # number of bounds strictly below it
        for bound in self.bound_words:
            lt = torch.zeros(n, dtype=torch.bool, device=batch.torch_device)
            eq = torch.ones_like(lt)
            for w, bw in zip(words, bound):
                b = i64(int(bw)) ^ SIGN64
                lt = lt | (eq & (w > b))
                eq = eq & (w == b)
            pid += lt.to(torch.int32)
        return torch.clamp(pid, max=self.num_partitions - 1)


def make_range_bounds(sample: Batch, sort_exprs: list, specs: list,
                      num_partitions: int) -> np.ndarray:
    """Range bound words from a sample batch (reference
    ``partitioning.py:202-214``): the live rows' sort words, lexsorted,
    bound i the row at i * n // num_partitions."""
    keys = Evaluator(sample.schema).evaluate(sample, sort_exprs)
    words = [u64_numpy(w) for w in sort_operands(keys, specs)]
    live = np.nonzero(sample.device.sel.cpu().numpy())[0]
    mat = np.stack([w[live] for w in words], axis=1)  # [n, n_words]
    mat = mat[np.lexsort([mat[:, i] for i in reversed(range(mat.shape[1]))])]
    n = mat.shape[0]
    bounds = [mat[min(n - 1, max(0, (i * n) // num_partitions))]
              for i in range(1, num_partitions)]
    if not bounds:
        return np.zeros((0, len(words)), dtype=np.uint64)
    return np.stack(bounds).astype(np.uint64)
