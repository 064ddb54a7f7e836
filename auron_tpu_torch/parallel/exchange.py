"""The planned exchange's row mover and the sharded aggregation steps (port
of ``auron_tpu/parallel/exchange.py``).

The JAX package moves rows between chips inside ``shard_map``: each shard
ranks its rows within their destination (one stable device sort), scatters
them into a fixed-capacity send matrix ``[P_dst, slot_cap]`` and swaps
blocks with ``lax.all_to_all``; destination d receives source 0's slots,
then source 1's, and so on. Here the logical partitions of one process
live on one device as stacked ``[P_src, cap]`` tensors, and within a
process the all_to_all is a relayout: a row of source s bound for d at
rank r lands in slot ``s * slot_cap + r`` of d's ``[P * slot_cap]``
receive row. The port scatters each row straight into that receive
layout (the send matrix and the relayout are one scatter), which is
exactly ``send.permute(1, 0, 2).reshape(P, P * slot_cap)`` without the
second copy of every column. Slot layout, row order and the zero fill of
empty slots are the reference's, bit for bit. Dead rows, and live rows
ranked at or past ``slot_cap`` (counted as ``overflow``), are dropped, as
with ``mode="drop"``.

Across processes (``group`` given; a ``multihost.global_mesh``) each rank
holds the ``[L, cap]`` rows of its ``L`` partitions. The same scatter over
its local sources lays out its send buffer in (destination rank,
destination partition, source partition, slot) order; one
``dist.all_to_all_single`` swaps the blocks (every column packed into one
byte buffer) and the received ``[world, L, L * slot_cap]`` blocks are laid
out in global source order, so each rank's ``[L, P * slot_cap]`` receive
rows are bit for bit those of the one-process relayout of the whole
stacked input. The overflow is summed with ``dist.all_reduce``. The
collectives take the device's tensors as they are: a data plane that
refuses them (a gloo built without CUDA) raises its own error.

This is plain XLA in the JAX package, not a Pallas kernel, so it is plain
torch here. ``batch_exchange_step`` routes by the partition-id kernel K1
(one INT64 key) or a chained murmur3 (several), and
``sharded_agg_exchange_step`` (partial sum and count -> route by K1 ->
final merge) is the reference's flagship distributed step. Both take the
one-process stacked form and the multi-process local form; group sums add
floats in a fixed order on the card (``ops/segments.add_at_``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from auron_tpu_torch.parallel.mesh import Mesh


class ExchangeResult(NamedTuple):
    arrays: tuple  # exchanged row arrays, each [n_local, P * slot_cap]
    sel: torch.Tensor  # liveness of received rows
    overflow: torch.Tensor  # int64 count of dropped rows (global)


def _slot_ranks(pids: torch.Tensor, sel: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Rank of each row within its destination, per source row of the
    stacked ``[P_src, cap]`` ids (a stable sort: ties keep row order)."""
    cap = pids.shape[-1]
    key = torch.where(sel, pids.to(torch.int32), n_parts)
    s_key, order = torch.sort(key, dim=-1, stable=True)
    iota = torch.arange(cap, dtype=torch.int64, device=pids.device).expand_as(s_key)
    boundary = torch.ones_like(s_key, dtype=torch.bool)
    boundary[..., 1:] = s_key[..., 1:] != s_key[..., :-1]
    run_start = torch.cummax(torch.where(boundary, iota, 0), dim=-1).values
    return torch.empty_like(run_start).scatter_(-1, order, iota - run_start)


def _relayout(arrays: Sequence[torch.Tensor], sel: torch.Tensor, pids: torch.Tensor,
              n_parts: int, slot_cap: int):
    """The rows of stacked ``[P_src, cap]`` arrays scattered into
    ``[n_parts, P_src * slot_cap]`` destination rows; (arrays, sel, local
    overflow)."""
    n_src = pids.shape[0]
    ranks = _slot_ranks(pids, sel, n_parts)
    keep = sel & (ranks < slot_cap)
    overflow = (sel & ~keep).sum()
    row = n_src * slot_cap
    src = torch.arange(n_src, dtype=torch.int64, device=pids.device)[:, None]
    # one spare slot past the receive rows takes every dropped row
    dest = torch.where(keep, pids.to(torch.int64) * row + src * slot_cap + ranks,
                       n_parts * row).reshape(-1)

    def scatter(a: torch.Tensor) -> torch.Tensor:
        recv = torch.zeros(n_parts * row + 1, dtype=a.dtype, device=a.device)
        recv[dest] = a.reshape(-1)
        return recv[:-1].view(n_parts, row)

    return tuple(scatter(a) for a in arrays), scatter(sel), overflow


def all_to_all_rows(arrays: Sequence[torch.Tensor], sel: torch.Tensor, pids: torch.Tensor,
                    n_parts: int, slot_cap: int, group=None):
    """Route the rows of stacked ``[P_src, cap]`` arrays to their
    destinations. Returns an ``ExchangeResult`` (received arrays ``[n_local,
    P * slot_cap]``, received sel, overflow as a device scalar): ``n_local =
    n_parts`` in one
    process; with ``group`` (a ``torch.distributed`` group) the rows are
    this rank's ``L = n_parts / world`` partitions and so is the receive
    block."""
    if group is None:
        return ExchangeResult(*_relayout(arrays, sel, pids, n_parts, slot_cap))
    import torch.distributed as dist

    world = dist.get_world_size(group)
    n_local = pids.shape[0]
    if n_local * world != n_parts:
        raise ValueError(f"{n_local} local partitions x {world} ranks != {n_parts} partitions")
    sent, send_sel, overflow = _relayout(arrays, sel, pids, n_parts, slot_cap)
    cols = (*sent, send_sel)
    # every column as bytes side by side: one collective a call
    views = [c.contiguous().view(torch.uint8) for c in cols]
    widths = [v.shape[1] for v in views]
    send = torch.cat(views, dim=1)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    overflow = overflow.to(torch.int64).reshape(1)
    dist.all_reduce(overflow, group=group)
    overflow = overflow[0]
    out, off = [], 0
    row = n_parts * slot_cap
    for c, w in zip(cols, widths):
        block = recv[:, off:off + w].contiguous().view(c.dtype)
        off += w
        # [world * L_dst, L_src * slot_cap] -> [L_dst, world * L_src * slot_cap]
        out.append(block.view(world, n_local, -1).permute(1, 0, 2).reshape(n_local, row))
    return ExchangeResult(tuple(out[:-1]), out[-1], overflow)


# ---------------------------------------------------------------------------
# group sums and the step functions
# ---------------------------------------------------------------------------


def _group_sums(keys: torch.Tensor, cols: Sequence[torch.Tensor], sel: torch.Tensor):
    """Per-shard sort-segmented sums of ``cols`` by int64 ``keys`` over the
    live rows. Groups come prefix-packed in the unsigned order of the key
    (the JAX package sorts the keys' uint64 view); returns (group keys,
    [sums], group valid). Slots past the last group hold the last sorted
    key and zero sums, as the reference's clipped gather leaves them."""
    cap = keys.shape[0]
    dev = keys.device
    if cap == 0:
        return keys.clone(), [c.clone() for c in cols], sel.clone()
    ukey = torch.bitwise_xor(keys.to(torch.int64), torch.tensor(-(1 << 63), device=dev))
    order = torch.sort(ukey, stable=True).indices
    order = order[torch.sort((~sel[order]).to(torch.int8), stable=True).indices]
    s_sel, s_uk, s_keys = sel[order], ukey[order], keys[order]
    boundary = torch.ones(cap, dtype=torch.bool, device=dev)
    boundary[1:] = s_uk[1:] != s_uk[:-1]
    boundary &= s_sel
    seg = torch.where(s_sel, torch.cumsum(boundary.to(torch.int64), 0) - 1, cap)
    from auron_tpu_torch.ops.segments import add_at_

    sums = []
    for c in cols:
        s_vals = c[order]
        out = torch.zeros(cap + 1, dtype=c.dtype, device=dev)
        add_at_(out, seg, torch.where(s_sel, s_vals, torch.zeros_like(s_vals)))
        sums.append(out[:cap])
    gkeys = s_keys[cap - 1:].expand(cap + 1).clone()
    # non-first rows all write the dropped slot past the groups
    gkeys.scatter_(0, torch.where(boundary, seg, cap), s_keys)
    gvalid = torch.arange(cap, device=dev) < boundary.sum()
    return gkeys[:cap], sums, gvalid


def _group_sum_i64(keys: torch.Tensor, vals: torch.Tensor, sel: torch.Tensor):
    """Per-shard sort-segmented sum of int64/float64 ``vals`` by int64
    ``keys``; returns prefix-packed (keys, sums, counts, group_valid)."""
    gk, (sums, counts), gv = _group_sums(keys, [vals, sel.to(torch.int64)], sel)
    return gk, sums, counts, gv


def _group(mesh: Mesh):
    if mesh.process_count == 1:
        return None
    from auron_tpu_torch.parallel import multihost

    return multihost.data_group()


def _check_inputs(mesh: Mesh, tensors: Sequence[torch.Tensor], label: str) -> None:
    n_src = mesh.parts_per_process
    shape = tensors[-1].shape
    for a in tensors:
        if a.device.type != mesh.device.type or a.shape != shape or a.dim() != 2 \
                or a.shape[0] != n_src:
            raise ValueError(
                f"{label} inputs must be [{n_src}, cap] on {mesh.device}, got "
                f"{tuple(a.shape)} on {a.device}")


def _leaves(payload) -> tuple[list, object]:
    """The arrays of a dict (in sorted key order, as ``jax.tree`` flattens
    it), list or tuple payload, and the function that rebuilds it."""
    if isinstance(payload, dict):
        keys = sorted(payload)
        return [payload[k] for k in keys], lambda xs: dict(zip(keys, xs))
    return list(payload), type(payload)


def _route(key_cols: Sequence[torch.Tensor], n_parts: int) -> torch.Tensor:
    """Spark-exact ``pmod(murmur3(keys), P)`` of ``[n, cap]`` int64 key
    columns: K1 for one column (every key valid), a murmur3 chained from
    seed 42 over several."""
    from auron_tpu_torch.ops.hashing import murmur3_i64, pmod, spark_hash_i32
    from auron_tpu_torch.ops.partition_kernels import SEED, partition_ids

    shape = key_cols[0].shape
    if len(key_cols) == 1:
        flat = key_cols[0].reshape(-1).to(torch.int64)
        return partition_ids(flat, torch.ones_like(flat, dtype=torch.bool), n_parts).view(shape)
    h = torch.full(shape, SEED, dtype=torch.int64, device=key_cols[0].device)
    for k in key_cols:
        h = murmur3_i64(k, h)
    return pmod(spark_hash_i32(h), n_parts)


def batch_exchange_step(mesh: Mesh, slot_cap: int, n_hash_cols: int = 1):
    """Generic repartitioner: ``step(key_cols, payload, sel)`` routes the
    rows of a tuple of ``n_hash_cols`` int64 key columns and a payload
    (dict, list or tuple of ``[n, cap]`` arrays of any dtypes) to the
    partition owning ``pmod(murmur3(keys), P)``; ``n = P`` (one process) or
    this rank's ``L`` (a multi-process mesh). Returns (key_cols, payload of
    the same structure, sel, overflow), each array ``[n, P * slot_cap]``."""
    n_parts = mesh.n_parts
    group = _group(mesh)

    def step(key_cols, payload, sel: torch.Tensor):
        key_cols = tuple(key_cols)
        if len(key_cols) != n_hash_cols:
            raise ValueError(f"step built for {n_hash_cols} key columns, got {len(key_cols)}")
        flat, rebuild = _leaves(payload)
        _check_inputs(mesh, (*key_cols, *flat, sel), "batch exchange")
        pid = _route(key_cols, n_parts)
        recv, rsel, overflow = all_to_all_rows((*key_cols, *flat), sel, pid, n_parts, slot_cap,
                                               group)
        k = len(key_cols)
        return tuple(recv[:k]), rebuild(list(recv[k:])), rsel, overflow

    return step


def pid_exchange_step(mesh: Mesh, slot_cap: int):
    """Repartitioner routed by precomputed partition ids: ``step(arrays,
    sel, pids)`` takes ``[n, cap]`` row arrays, liveness and int32
    destinations on the mesh's device (``n = P`` in one process, this
    rank's ``L`` on a multi-process mesh) and returns (arrays ``[n, P *
    slot_cap]``, sel, overflow)."""
    n_parts = mesh.n_parts
    group = _group(mesh)

    def step(arrays: Sequence[torch.Tensor], sel: torch.Tensor, pids: torch.Tensor):
        _check_inputs(mesh, (*arrays, sel, pids), "exchange")
        return all_to_all_rows(arrays, sel, pids, n_parts, slot_cap, group)

    return step


def sharded_agg_exchange_step(mesh: Mesh, slot_cap: int):
    """``SELECT k, sum(v), count(v) GROUP BY k`` as one distributed step:
    partial sums and counts of each shard's live rows -> route the groups
    by K1 (``pmod(murmur3(k), P)``) -> final merge of the received
    partials. ``step(keys, vals, sel)`` takes ``[n, cap]`` int64 keys,
    float64 values and liveness (``n = P`` in one process, this rank's
    ``L`` on a multi-process mesh); returns (keys, sums, counts, valid),
    each ``[n, P * slot_cap]`` with every shard's groups prefix-packed, and
    the global overflow."""
    n_parts = mesh.n_parts
    group = _group(mesh)

    def step(keys: torch.Tensor, vals: torch.Tensor, sel: torch.Tensor):
        _check_inputs(mesh, (keys, vals, sel), "sharded aggregation")
        # 1. partial aggregation of each shard's rows
        parts = [_group_sum_i64(keys[i], vals[i], sel[i]) for i in range(keys.shape[0])]
        gk, gs, gc, gv = (torch.stack(x) for x in zip(*parts))
        # 2. route the groups to their owners
        pid = _route((gk,), n_parts)
        (rk, rs, rc), rsel, overflow = all_to_all_rows((gk, gs, gc), gv, pid, n_parts,
                                                       slot_cap, group)
        # 3. merge the received partials: sums and counts both summed
        final = [_group_sums(rk[i], [rs[i], rc[i]], rsel[i]) for i in range(rk.shape[0])]
        fk = torch.stack([f[0] for f in final])
        fs = torch.stack([f[1][0] for f in final])
        fc = torch.stack([f[1][1] for f in final])
        fv = torch.stack([f[2] for f in final])
        return fk, fs, fc, fv, overflow

    return step
