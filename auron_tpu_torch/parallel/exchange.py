"""The planned exchange's row mover on one card (port of
``auron_tpu/parallel/exchange.py:47-96, 166-199``).

The JAX package moves rows between chips inside ``shard_map``: each shard
ranks its rows within their destination (one stable device sort), scatters
them into a fixed-capacity send matrix ``[P_dst, slot_cap]`` and swaps
blocks with ``lax.all_to_all``; destination d receives source 0's slots,
then source 1's, and so on. Here the P logical partitions live on one
device as stacked ``[P_src, cap]`` tensors, and the all_to_all is a
relayout: a row of source s bound for d at rank r lands in slot
``s * slot_cap + r`` of d's ``[P * slot_cap]`` receive row. The port
scatters each row straight into that receive layout (the send matrix and
the relayout are one scatter), which is exactly
``send.permute(1, 0, 2).reshape(P, P * slot_cap)`` without the second
copy of every column. Slot layout, row order and the zero fill of empty
slots are the reference's, bit for bit. Dead rows, and live rows ranked at
or past ``slot_cap`` (counted as ``overflow``), are dropped, as with
``mode="drop"``.

This is plain XLA in the JAX package, not a Pallas kernel, so it is plain
torch here. ``batch_exchange_step`` and ``sharded_agg_exchange_step`` have
no driver caller and are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch

from auron_tpu_torch.parallel.mesh import Mesh


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


def all_to_all_rows(arrays: Sequence[torch.Tensor], sel: torch.Tensor, pids: torch.Tensor,
                    n_parts: int, slot_cap: int):
    """Route the rows of stacked ``[P_src, cap]`` arrays to their
    destinations. Returns (received arrays ``[n_parts, P_src * slot_cap]``,
    received sel, overflow as a device scalar)."""
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


def pid_exchange_step(mesh: Mesh, slot_cap: int):
    """Mesh repartitioner routed by precomputed partition ids: ``step(arrays,
    sel, pids)`` takes stacked ``[P, cap]`` row arrays, liveness and int32
    destinations on the mesh's device and returns (arrays ``[P, P *
    slot_cap]``, sel, overflow)."""
    n_parts = mesh.n_parts

    def step(arrays: Sequence[torch.Tensor], sel: torch.Tensor, pids: torch.Tensor):
        for a in (*arrays, sel, pids):
            if a.device.type != mesh.device.type or a.shape != pids.shape or a.shape[0] != n_parts:
                raise ValueError(
                    f"exchange inputs must be [{n_parts}, cap] on {mesh.device}, got "
                    f"{tuple(a.shape)} on {a.device}")
        return all_to_all_rows(arrays, sel, pids, n_parts, slot_cap)

    return step
