"""Broadcast exchange halves and AQE partition statistics (port of
``auron_tpu/parallel/broadcast.py``).

- The broadcast exchange (Spark's NativeBroadcastExchangeBase): the driver
  runs the build side's plan and collects its output as blocks
  (``collect_ipc``), which the engine turns back into batches
  (``batches_from_ipc``). The blocks are the port's own v2 shuffle blocks
  (``exec/shuffle/format.encode_block``, what ``IpcWriterExec`` emits); no
  pyarrow is on the path. ``replicate_to_mesh`` puts the build side on
  every partition's device: the mesh's device in one process, and under
  SPMD rank 0's batch broadcast over the data plane to every process.
- AQE statistics: the shuffle writer's index files are the map output
  sizes (Spark's MapStatus). ``map_output_sizes`` reads the [map, reduce
  partition] byte matrix (AQE skew splitting slices a partition by map
  ranges), ``map_output_stats`` its column sums, and
  ``plan_coalesced_partitions`` groups adjacent small reduce partitions up
  to a target size (Spark's CoalesceShufflePartitions).
"""

from __future__ import annotations

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import Batch, DeviceBatch
from auron_tpu_torch.exec.shuffle.format import read_index_tagged


def collect_ipc(op, partitions: list[int] | None = None, device="cuda",
                resources: dict | None = None) -> list[bytes]:
    """Run the plan (driver side) over ``partitions`` (default [0]) with
    ``resources`` as its task resource map and collect its live rows as
    length-prefixed v2 blocks, one per non-empty batch."""
    from auron_tpu_torch.exec.base import ExecutionContext
    from auron_tpu_torch.exec.shuffle.format import encode_block, fallback_codec, host_planes
    from auron_tpu_torch.memory.memmgr import release_task_consumers
    from auron_tpu_torch.utils.config import conf_scope

    blocks: list[bytes] = []
    for p in partitions if partitions is not None else [0]:
        ctx = ExecutionContext(partition_id=p, resources=resources or {},
                               device=str(torch.device(device)))
        try:
            with conf_scope(ctx.conf):
                for b in op.execute(p, ctx):
                    n, cols = host_planes(b)
                    if n:
                        blocks.append(encode_block(b.schema, cols,
                                                   codec=fallback_codec(ctx.conf)))
        finally:
            release_task_consumers(ctx)
    return blocks


def batches_from_ipc(blocks: list[bytes], schema, device="cuda") -> list[Batch]:
    """The batches of ``collect_ipc`` blocks on ``device``, one per block
    (column types from ``schema``: the port's blocks carry no types of
    their own that the reader trusts)."""
    from auron_tpu_torch.device import resolve_device
    from auron_tpu_torch.exec.shuffle.format import decode_block, iter_block_payloads
    from auron_tpu_torch.exec.shuffle.reader import _BucketAssembler

    asm = _BucketAssembler(schema, resolve_device(device))
    out = []
    for blk in blocks:
        for payload in iter_block_payloads(blk):
            asm.add(*decode_block(payload, schema))
            if asm.rows:
                out.append(asm.emit())
    return out


def _moved(batch: Batch, dev: torch.device) -> Batch:
    d = batch.device
    return batch.with_device(DeviceBatch(d.sel.to(dev), tuple(v.to(dev) for v in d.values),
                                         tuple(m.to(dev) for m in d.validity)))


def replicate_to_mesh(batch: Batch | None, mesh) -> Batch:
    """The build side on the mesh: in one process ``batch`` on the mesh's
    device. Under SPMD (a ``multihost.global_mesh``) rank 0's ``batch`` on
    every process (the others pass any batch or None): its schema,
    capacity and vocabularies over the control plane, its planes in one
    broadcast over the data plane."""
    if mesh.process_count == 1:
        return _moved(batch, mesh.device)
    import torch.distributed as dist

    from auron_tpu_torch.parallel import multihost

    rank, _ = multihost.process_info()
    if rank == 0:
        b = _moved(batch, mesh.device)
        planes = [b.device.sel, *b.device.values, *b.device.validity]
        meta = [(b.schema, b.capacity, b.dicts, [str(t.dtype) for t in planes])]
    else:
        meta = [None]
    dist.broadcast_object_list(meta, src=0, group=multihost.control_group())
    schema, cap, dicts, dtypes = meta[0]
    dtypes = [getattr(torch, s.split(".")[-1]) for s in dtypes]
    if rank != 0:
        planes = [torch.zeros(cap, dtype=dt, device=mesh.device) for dt in dtypes]
    views = [t.contiguous().view(torch.uint8) for t in planes]
    buf = torch.cat(views)
    dist.broadcast(buf, src=0, group=multihost.data_group())
    out, off = [], 0
    for v, dt in zip(views, dtypes):
        out.append(buf[off:off + v.numel()].view(dt))
        off += v.numel()
    k = len(schema)
    return Batch(schema, DeviceBatch(out[0], tuple(out[1:1 + k]), tuple(out[1 + k:])), dicts)


# ---------------------------------------------------------------------------
# AQE statistics
# ---------------------------------------------------------------------------


def map_output_sizes(index_files: list[str], n_parts: int) -> np.ndarray:
    """[map task, reduce partition] output bytes."""
    if not index_files:
        return np.zeros((0, n_parts), np.int64)
    return np.stack([np.diff(np.asarray(read_index_tagged(f)[0], dtype=np.int64))
                     for f in index_files])


def map_output_stats(index_files: list[str]) -> np.ndarray:
    """Per-reduce-partition output bytes summed over all map tasks."""
    if not index_files:
        return np.zeros(0, np.int64)
    n_parts = len(read_index_tagged(index_files[0])[0]) - 1
    return map_output_sizes(index_files, n_parts).sum(axis=0)


def plan_coalesced_partitions(partition_bytes: np.ndarray,
                              target_bytes: int) -> list[list[int]]:
    """AQE post-shuffle coalescing: group adjacent small reduce partitions
    until each group reaches ~target_bytes."""
    groups: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for p, sz in enumerate(partition_bytes.tolist()):
        cur.append(p)
        cur_bytes += sz
        if cur_bytes >= target_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        groups.append(cur)
    return groups
