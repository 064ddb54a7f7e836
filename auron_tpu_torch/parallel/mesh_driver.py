"""Planned-query execution over the logical partition mesh.

Port of ``auron_tpu/parallel/mesh_driver.py``. A plan
carries ``MeshExchangeExec`` stage boundaries (the ``mesh_exchange`` node of
the plan IR); ``MeshQueryDriver.run`` resolves them bottom-up:

1. run the child sub-plan once per partition (the map stage), concatenate
   each partition's output and compute its rows' destinations with the
   same ``Partitioning`` code the file shuffle writer uses, so both
   transports route bit-identically;
2. count the exact ``[P_src, P_dst]`` routing matrix with the histogram
   kernel K2 (``ops/partition_kernels.partition_histogram``: the CUDA
   kernel on a CUDA shard, its plain version on a CPU shard) and read it
   once on the host;
3. pick the transport: ``exchange.mode`` = mesh | file | auto (auto = mesh
   when the hottest receiving shard's estimated payload fits
   ``exchange.mesh.max.bytes``, else file);
4. mesh: unify dictionaries, pad every shard to a common capacity, stack
   to ``[P, cap]`` and move the rows with ``pid_exchange_step`` (slots sized
   from the exact counts, so nothing overflows); each partition's received
   rows become one batch behind a ``ResourceScanExec``. file: one
   ``ShuffleWriterExec`` per shard, read back through an ``IpcReaderExec``
   over a ``MultiMapBlockProvider``, with AQE coalescing of small reduce
   partitions, and AQE skew-join splitting of a stage whose one sort-merge
   join reads two file exchanges (``_maybe_split_skew``: a hot partition
   becomes map-range slices of its larger splittable side, each joined
   against the whole other side, so the stage runs more tasks than P and
   the next exchange sees more map shards than partitions);
5. splice the scan where the exchange was, in a NEW tree: the caller's
   tree is never changed, so a warm-up and a timed run can share it.

The driver takes an operator tree or a plan proto (pruned with the port's
``prune_columns``, then planned), and fuses every stage it runs
(``plan/fusion.fuse_exec_tree``) as ``task_from_proto`` does.

SPMD (``spmd=True`` on a mesh of several processes,
``multihost.global_mesh``; port of ``mesh_driver.py:138-225, 415-820``):
every process runs the same driver over the same plan and resources and
executes only the partitions it owns (``mesh.local_parts``). Per exchange,
each rank counts its own shards' routing with K2 and one control-plane
allgather gives every rank the global ``[P, P]`` matrix and the agreed
stacking capacity; dictionary columns are unified across processes with
two allgathers (the vocabularies merged in rank order, so every rank
builds the same one and codes match the one-process driver's); the mesh
transport's rows cross processes in one ``all_to_all_single`` on the data
plane; the file transport needs a work_dir every rank sees (a token write,
a barrier and an allgather that ANDs the answers probe it once): each rank
writes its own map outputs under global shard names, then a barrier, then
every rank reads all P maps. AQE coalescing and skew splitting stay off
under SPMD (each rank owns a fixed set of partitions). In one process
``spmd=True`` runs the one-process driver, as the JAX package ignores it;
a mesh of several processes without ``spmd=True`` raises.
Every rank walks the same collective sequence; a rank that raises leaves
its peers to fail at the groups' timeout.

Differences from the JAX driver: the file transport's writers reuse the
ids the driver computed for the routing counts instead of hashing each
shard again; the AQE rules walk operator trees where the JAX driver walks
protos; ``collect`` returns host numpy columns. ``ExchangeStats`` adds
the mesh transport's ``slot_cap``, ``walls`` holds
each stage's wall clock, and ``routed_bytes`` the rows each exchange
routed times their device width.
"""

from __future__ import annotations

import copy
import os
import shutil
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import (
    Batch, DeviceBatch, bucket_capacity, device_concat, unify_dict,
)
from auron_tpu_torch.exec.base import ExecOperator, ExecutionContext
from auron_tpu_torch.exec.basic import ResourceScanExec
from auron_tpu_torch.memory.memmgr import release_task_consumers
from auron_tpu_torch.ops.partition_kernels import partition_histogram
from auron_tpu_torch.parallel.exchange import pid_exchange_step
from auron_tpu_torch.parallel.mesh import Mesh
from auron_tpu_torch.plan.fusion import fuse_exec_tree
from auron_tpu_torch.runtime import dispatch
from auron_tpu_torch.utils.config import (
    EXCHANGE_COALESCE_ENABLE, EXCHANGE_COALESCE_TARGET_BYTES, EXCHANGE_MESH_MAX_BYTES,
    EXCHANGE_MODE, EXCHANGE_SKEW_ENABLE, EXCHANGE_SKEW_FACTOR, EXCHANGE_SKEW_MIN_BYTES,
    Configuration, conf_scope,
)


@dataclass
class ExchangeStats:
    """Map-output statistics of one resolved exchange (AQE input)."""

    exchange_id: str
    mode: str  # "mesh" | "file"
    rows: np.ndarray  # [P_src, P_dst] routed row counts
    est_bytes_per_shard: int  # payload of the hottest receiving shard
    coalesced_groups: list | None = None  # AQE partition grouping, if applied
    slot_cap: int | None = None  # rows per (src, dst) slot of a mesh exchange
    #: AQE skew-split task table, if applied: [(pid, map_lo, map_hi | None)]
    skew_tasks: list | None = None
    #: live rows routed times the row's device width (values + validity)
    routed_bytes: int = 0

    def partition_sizes(self) -> np.ndarray:
        return self.rows.sum(axis=0)


class MeshExchangeExec(ExecOperator):
    """The ``mesh_exchange`` plan node: rows of ``child`` repartitioned by
    ``partitioning``. A stage boundary that ``MeshQueryDriver`` resolves; it
    never streams."""

    def __init__(self, child: ExecOperator, partitioning, exchange_id: str = ""):
        super().__init__([child], child.schema)
        self.partitioning = partitioning
        self.exchange_id = exchange_id

    def _execute(self, partition: int, ctx: ExecutionContext):
        raise ValueError(
            "mesh_exchange is a stage boundary resolved by "
            "parallel.mesh_driver.MeshQueryDriver, not a streaming operator; "
            "run the plan through the driver"
        )


class CoalescedBlockProvider:
    """AQE post-shuffle coalescing consumer: reduce task p reads every
    original partition of its group (grouping whole hash partitions keeps
    group-by and join co-partitioning)."""

    def __init__(self, inner, groups: list[list[int]]):
        self.inner = inner
        self.groups = groups

    def iter_payloads(self, partition: int):
        for orig in self.groups[partition]:
            yield from self.inner.iter_payloads(orig)


class SkewSplitProvider:
    """AQE skew-join split consumer (Spark OptimizeSkewedJoin): stage task i
    reads ``tasks[i] = (pid, map_lo, map_hi)``, the map outputs [map_lo,
    map_hi) of partition pid, or all of them when map_hi is None."""

    def __init__(self, inner, tasks: list[tuple[int, int, int | None]]):
        self.inner = inner
        self.tasks = tasks

    def iter_payloads(self, task: int):
        pid, lo, hi = self.tasks[task]
        if hi is None:
            yield from self.inner.iter_payloads(pid)
        else:
            yield from self.inner.read_slice(pid, lo, hi)


#: join types whose result survives splitting the given side: every row of
#: the split side lands in exactly one slice, and the other side must not
#: emit unmatched rows (they would repeat once per slice)
_SPLITTABLE_SIDES = {
    "inner": ("left", "right"),
    "left": ("left",),
    "left_semi": ("left",),
    "left_anti": ("left",),
    "right": ("right",),
}


class _ShardPids:
    """An exchange's partitioning whose ids the driver already computed,
    one tensor per map shard: the file transport's writer for shard p
    (task partition p, one batch) reads them instead of hashing again."""

    def __init__(self, num_partitions: int, pids: list[torch.Tensor]):
        self.num_partitions = num_partitions
        self.pids = pids

    def partition_ids(self, batch: Batch, ctx: ExecutionContext) -> torch.Tensor:
        pid = self.pids[ctx.partition_id]
        assert pid.shape[0] == batch.capacity, (pid.shape, batch.capacity)
        return pid


class MeshQueryDriver:
    """Executes a plan containing mesh exchanges on a ``Mesh``."""

    def __init__(self, mesh: Mesh, conf: Configuration | None = None,
                 work_dir: str | None = None, spmd: bool = False):
        self.mesh = mesh
        self.n_parts = mesh.n_parts
        if mesh.process_count > 1 and not spmd:
            raise ValueError(
                f"a mesh of {mesh.process_count} processes needs spmd=True: each "
                "process holds only its own partitions")
        #: SPMD across processes: every process runs this same driver over
        #: the global mesh and executes only the partitions it owns; one
        #: process ignores the flag
        self.spmd = bool(spmd) and mesh.process_count > 1
        self.local_parts = list(mesh.local_parts) if self.spmd else list(range(self.n_parts))
        if self.spmd:
            lp = self.local_parts
            assert lp, (
                "SPMD driver: this process owns no device of the mesh — "
                "every participating process must contribute devices")
            assert len(lp) * mesh.process_count == self.n_parts, (
                "SPMD driver needs an equal device count per process "
                f"(local {len(lp)} x {mesh.process_count} != {self.n_parts})")
            assert lp == list(range(lp[0], lp[0] + len(lp))), (
                "SPMD driver needs process-contiguous mesh device order")
        self._workdir_shared: bool | None = None  # SPMD probe, cached
        self.conf = conf or Configuration()
        self.work_dir = work_dir
        self.stats: list[ExchangeStats] = []
        #: wall seconds: "<exchange id>.map_s", "<exchange id>.exchange_s",
        #: "reduce_s" (each ends in a synchronize of the current stream)
        self.walls: dict[str, float] = {}
        self._exchange_seq = 0
        self._tmp_dirs: list[str] = []
        #: ex_id -> (provider, per-partition byte totals, [map, partition]
        #: bytes) of just-resolved file exchanges, consumed by AQE
        #: coalescing and skew splitting
        self._coalesce_candidates: dict[str, tuple] = {}

    # ------------------------------------------------------------------

    def run(self, plan, resources: dict) -> list[list[Batch]]:
        """Resolve exchanges, then run the residual plan on every partition.
        Returns per-partition batch lists (the reduce-stage outputs; under
        SPMD only this process's partitions are filled)."""
        try:
            self.stats = []
            self.walls = {}
            self._exchange_seq = 0
            self._coalesce_candidates = {}
            resolved = self._rewrite(_as_tree(plan), resources)
            t0 = time.perf_counter()
            n_reduce = self._maybe_coalesce_inputs(resolved, resources)
            if n_reduce == self.n_parts and not self.spmd:
                n_reduce = self._maybe_split_skew(resolved, resources)
            resolved = fuse_exec_tree(resolved, self.conf, str(self.mesh.device))
            # SPMD: only this process's partitions run (the others stay empty)
            parts = self.local_parts if self.spmd else range(n_reduce)
            outs: list[list[Batch]] = [[] for _ in range(n_reduce)]
            for p in parts:
                outs[p] = self._run_partition(resolved, p, resources)
            self._sync()
            self.walls["reduce_s"] = time.perf_counter() - t0
            return outs
        finally:
            self._cleanup_tmp()

    def collect(self, plan, resources: dict) -> dict[str, np.ndarray] | None:
        """run() then every partition's live rows as host numpy columns
        (None when nothing came out)."""
        from auron_tpu_torch.models.tpcds import collect

        batches = [b for part in self.run(plan, resources) for b in part]
        return collect(batches) if batches else None

    def _ctx(self, partition: int, resources: dict) -> ExecutionContext:
        return ExecutionContext(partition_id=partition, conf=self.conf.copy(),
                                resources=resources, device=str(self.mesh.device))

    def _run_partition(self, op: ExecOperator, partition: int, resources: dict) -> list[Batch]:
        ctx = self._ctx(partition, resources)
        try:
            with conf_scope(ctx.conf):
                return list(op.execute(partition, ctx))
        finally:
            release_task_consumers(ctx)

    def _sync(self) -> None:
        """Wait for this run's work: the current stream's, not the whole
        device's (a query served beside others runs on a stream of its own,
        ``serve/server.py``, and must not wait for theirs; it gives up the
        host's turn for the wait, if there is one)."""
        if self.mesh.device.type == "cuda":
            dispatch.wait_for(torch.cuda.current_stream(self.mesh.device))

    def _cleanup_tmp(self) -> None:
        for d in self._tmp_dirs:
            shutil.rmtree(d, ignore_errors=True)
        self._tmp_dirs.clear()

    def _maybe_coalesce_inputs(self, plan: ExecOperator, resources: dict) -> int:
        """AQE post-shuffle coalescing, per consuming stage. Sound iff every
        leaf of the stage is a just-resolved file exchange: the same grouping
        then applies to all of them, which keeps hash co-partitioning across
        the stage's inputs. Returns the stage width."""
        if not self.conf.get(EXCHANGE_COALESCE_ENABLE):
            # candidates may exist for skew splitting alone
            return self.n_parts
        leaves = _collect_sources(plan)
        ex_ids = [rid for kind, rid in leaves
                  if kind == "ipc_reader" and rid in self._coalesce_candidates]
        if not ex_ids or len(ex_ids) != len(leaves):
            return self.n_parts
        # a self-join may read the same exchange on both sides: one grouping
        # decision, sizes counted once
        ex_ids = list(dict.fromkeys(ex_ids))
        from auron_tpu_torch.parallel.broadcast import plan_coalesced_partitions

        combined = sum(self._coalesce_candidates[ex][1] for ex in ex_ids)
        groups = plan_coalesced_partitions(combined,
                                           self.conf.get(EXCHANGE_COALESCE_TARGET_BYTES))
        if len(groups) >= self.n_parts:
            return self.n_parts
        by_id = {s.exchange_id: s for s in self.stats}
        for ex in ex_ids:
            provider, _, _ = self._coalesce_candidates.pop(ex)
            resources[ex] = CoalescedBlockProvider(provider, groups)
            by_id[ex].coalesced_groups = groups
        return len(groups)

    def _maybe_split_skew(self, plan: ExecOperator, resources: dict) -> int:
        """AQE skew-join splitting over a stage whose one sort-merge join
        reads two just-resolved file exchanges and nothing else: a reduce
        partition larger than factor x the median (and the minimum bytes)
        splits into map-range slices of its larger side whose join type
        allows it (``_SPLITTABLE_SIDES``), each joined against the whole
        other side; the stage widens to one task per slice. Returns the
        stage width (``mesh_driver.py:301-382``)."""
        if not self.conf.get(EXCHANGE_SKEW_ENABLE):
            return self.n_parts
        smj = _find_single_smj(plan)
        if smj is None:
            return self.n_parts
        sides = {}
        for i, side in enumerate(("left", "right")):
            leaves = _collect_sources(smj.children[i])
            if (len(leaves) != 1 or leaves[0][0] != "ipc_reader"
                    or leaves[0][1] not in self._coalesce_candidates):
                return self.n_parts
            sides[side] = leaves[0][1]
        if sides["left"] == sides["right"]:
            return self.n_parts  # a self-join on one exchange: slices collide
        # the whole stage reads only these two exchanges: widening its task
        # range would mis-index any other source
        all_leaves = _collect_sources(plan)
        if {rid for _, rid in all_leaves} != set(sides.values()) or len(all_leaves) != 2:
            return self.n_parts

        sizes = {s: self._coalesce_candidates[ex][1] for s, ex in sides.items()}
        factor = self.conf.get(EXCHANGE_SKEW_FACTOR)
        min_bytes = self.conf.get(EXCHANGE_SKEW_MIN_BYTES)
        total = sizes["left"] + sizes["right"]
        median = float(np.median(total)) if total.size else 0.0
        threshold = max(median * factor, float(min_bytes))
        allowed = _SPLITTABLE_SIDES.get(smj.driver.join_type, ())

        tasks: dict[str, list] = {"left": [], "right": []}
        split_any = False
        for pid in range(self.n_parts):
            split_side = None
            if total[pid] > threshold:
                # split the larger side where the join type allows it
                order = sorted(("left", "right"), key=lambda s: -int(sizes[s][pid]))
                split_side = next((s for s in order if s in allowed), None)
            if split_side is None:
                for s in ("left", "right"):
                    tasks[s].append((pid, 0, None))
                continue
            per_map = self._coalesce_candidates[sides[split_side]][2][:, pid]
            groups = _group_maps_by_bytes(per_map, max(median, float(min_bytes) / 2, 1.0))
            other = "left" if split_side == "right" else "right"
            for lo, hi in groups:
                tasks[split_side].append((pid, lo, hi))
                tasks[other].append((pid, 0, None))  # the whole other side per slice
            split_any = split_any or len(groups) > 1
        if not split_any:
            return self.n_parts
        by_id = {s.exchange_id: s for s in self.stats}
        for side, ex in sides.items():
            provider, _, _ = self._coalesce_candidates.pop(ex)
            resources[ex] = SkewSplitProvider(provider, tasks[side])
            by_id[ex].skew_tasks = tasks[side]
        return len(tasks["left"])

    # ------------------------------------------------------------------

    def _rewrite(self, op: ExecOperator, resources: dict) -> ExecOperator:
        """The tree with every exchange resolved (bottom-up), as new nodes
        wherever something below changed."""
        if isinstance(op, MeshExchangeExec):
            child = self._rewrite(op.children[0], resources)
            return self._execute_exchange(op, child, resources)
        kids = [self._rewrite(c, resources) for c in op.children]
        if all(k is c for k, c in zip(kids, op.children)):
            return op
        new = copy.copy(op)
        new.children = kids
        return new

    def _execute_exchange(self, ex: MeshExchangeExec, child: ExecOperator,
                          resources: dict) -> ExecOperator:
        part = ex.partitioning
        if part.num_partitions != self.n_parts:
            raise ValueError(f"exchange over {part.num_partitions} partitions on a "
                             f"{self.n_parts}-partition mesh")
        ex_id = ex.exchange_id or f"__mesh_exchange_{self._exchange_seq}"
        self._exchange_seq += 1

        # ---- map stage: the child sub-plan per shard (AQE may have
        # coalesced this stage's shuffle inputs, shrinking its width); SPMD:
        # only this process's shards run here, its peers run theirs
        t0 = time.perf_counter()
        n_src = self._maybe_coalesce_inputs(child, resources)
        if n_src == self.n_parts and not self.spmd:
            n_src = self._maybe_split_skew(child, resources)
        schema = child.schema
        child = fuse_exec_tree(child, self.conf, str(self.mesh.device))
        shard_batches: list[Batch] = []
        pids: list[torch.Tensor] = []
        for p in (self.local_parts if self.spmd else range(n_src)):
            ctx = self._ctx(p, resources)
            with conf_scope(ctx.conf):
                try:
                    got = list(child.execute(p, ctx))
                finally:
                    release_task_consumers(ctx)
                b = device_concat(got) if got else Batch.empty(schema, device=self.mesh.device)
                shard_batches.append(b)
                pids.append(part.partition_ids(b, ctx).to(torch.int32))
        self._sync()
        t1 = time.perf_counter()

        # ---- statistics + transport decision
        counts = self._routing_counts(shard_batches, pids)
        spmd_cap = None
        if self.spmd:
            local_cap = max((b.capacity for b in shard_batches), default=1)
            counts, spmd_cap = self._allgather_counts(counts, local_cap)
        # the hot receiving shard bounds device residency, not the mean
        max_shard_rows = int(counts.sum(axis=0).max()) if counts.size else 0
        est_shard_bytes = max_shard_rows * _row_width_bytes(schema)
        mode = self.conf.get(EXCHANGE_MODE)
        if mode not in ("mesh", "file", "auto"):
            raise ValueError(f"exchange.mode must be mesh, file or auto, got {mode!r}")
        if mode == "auto":
            mode = ("mesh" if est_shard_bytes <= self.conf.get(EXCHANGE_MESH_MAX_BYTES)
                    else "file")
        if n_src != self.n_parts:
            # the mesh transport is square (P src = P dst); a coalesced map
            # stage routes through the file transport
            mode = "file"
        if self.spmd and mode == "file" and not self._workdir_is_shared():
            # the file transport needs every process to see every map output
            if self.conf.get(EXCHANGE_MODE) == "file":
                raise RuntimeError(
                    "exchange.mode=file in SPMD mode requires a SHARED "
                    "auron.work_dir (capability probe failed: peers cannot "
                    "see this process's files). Point work_dir at shared "
                    "storage or use exchange.mode=mesh.")
            # auto routed to file (payload over exchange.mesh.max.bytes) but
            # no shared storage: stay on the collective and say so
            import logging

            logging.getLogger("auron_tpu_torch").warning(
                "SPMD exchange %s: est %d bytes/shard exceeds exchange.mesh.max.bytes and "
                "work_dir is not shared; riding all_to_all anyway", ex_id, est_shard_bytes)
            mode = "mesh"
        stats = ExchangeStats(ex_id, mode, counts, est_shard_bytes,
                              routed_bytes=int(counts.sum()) * _row_width_bytes(schema))
        self.stats.append(stats)
        if mode == "file":
            node = self._file_exchange(_ShardPids(part.num_partitions, pids), schema,
                                       shard_batches, ex_id, resources)
        else:
            node = self._mesh_exchange(schema, shard_batches, pids, stats, resources, spmd_cap)
        self._sync()
        self.walls[f"{ex_id}.map_s"] = t1 - t0
        self.walls[f"{ex_id}.exchange_s"] = time.perf_counter() - t1
        return node

    def _routing_counts(self, batches: list[Batch], pids: list[torch.Tensor]) -> np.ndarray:
        """Exact [P_src, P_dst] live-row routing matrix: K2 once per source
        shard (the plain version on CPU shards), one host read."""
        hists = [partition_histogram(pid, self.n_parts, b.device.sel)
                 for b, pid in zip(batches, pids)]
        return torch.stack(hists).cpu().numpy().astype(np.int64)

    def _allgather_counts(self, local: np.ndarray, local_cap: int) -> tuple[np.ndarray, int]:
        """SPMD: each process's ``[L, P]`` routing counts merged into the
        global ``[P, P]`` matrix, and the global stacking capacity agreed:
        one control-plane allgather per exchange (the partition ids and the
        capacity ride as extra columns)."""
        from auron_tpu_torch.parallel import multihost

        payload = np.concatenate([
            np.asarray(self.local_parts, dtype=np.int64)[:, None],
            local.reshape(len(self.local_parts), self.n_parts),
            np.full((len(self.local_parts), 1), local_cap, dtype=np.int64),
        ], axis=1)
        rows = multihost.allgather_array(payload).reshape(-1, payload.shape[1])
        full = np.zeros((self.n_parts, self.n_parts), dtype=np.int64)
        for r in rows:
            full[int(r[0])] = r[1:-1]
        return full, int(rows[:, -1].max())

    def _unify_dicts_global(self, batches: list[Batch], dict_cols: list[int]) -> dict:
        """SPMD cross-process dictionary unification: each process unifies
        its local shards per column, the local vocabularies cross in two
        control-plane allgathers (lengths, then padded pickled payloads)
        whatever the column count, and every process merges them in rank
        order with the same ``merge_vocab``, so all build the same
        vocabulary, the one-process driver's. Returns {column: (unified,
        [local code -> global code table per local shard])}."""
        import pickle

        from auron_tpu_torch.columnar.batch import merge_vocab
        from auron_tpu_torch.parallel import multihost

        local_vocab, local_remaps = {}, {}
        for ci in dict_cols:
            unified, remaps = unify_dict(batches, ci)
            # no placeholder entry for a process whose shards hold none
            local_vocab[ci] = list(unified) if any(len(r) for r in remaps) else []
            local_remaps[ci] = remaps
        per_proc = [pickle.loads(b) for b in
                    multihost.allgather_bytes(pickle.dumps(local_vocab, protocol=4))]
        out = {}
        for ci in dict_cols:
            unified, proc_remaps = merge_vocab([pv.get(ci, []) for pv in per_proc])
            mine = proc_remaps[self.mesh.process_index]
            # compose: local batch codes -> local unified -> global
            out[ci] = (unified, [mine[r] for r in local_remaps[ci]])
        return out

    # ---- device-resident transport ------------------------------------

    def _mesh_exchange(self, schema: T.Schema, batches: list[Batch],
                       pids: list[torch.Tensor], stats: ExchangeStats,
                       resources: dict, spmd_cap: int | None = None) -> ExecOperator:
        ncols = len(schema)
        # unify dictionaries so codes mean the same in every shard (SPMD:
        # in every process)
        dicts: list = [None] * ncols
        values = [[b.col_values(ci) for b in batches] for ci in range(ncols)]
        dict_cols = [ci for ci, f in enumerate(schema) if f.dtype.is_dict_encoded]
        if self.spmd and dict_cols:
            unified_remaps = self._unify_dicts_global(batches, dict_cols)
        else:
            unified_remaps = {ci: unify_dict(batches, ci) for ci in dict_cols}
        for ci, (unified, remaps) in unified_remaps.items():
            dicts[ci] = unified
            values[ci] = [torch.from_numpy(r).to(v.device)[v.clamp(0, len(r) - 1).long()]
                          for v, r in zip(values[ci], remaps)]
        # SPMD: the capacity agreed in the counts allgather
        cap = spmd_cap if spmd_cap is not None else max(b.capacity for b in batches)
        dev = self.mesh.device

        def stacked(parts: list[torch.Tensor]) -> torch.Tensor:
            out = torch.zeros((len(parts), cap), dtype=parts[0].dtype, device=dev)
            for i, a in enumerate(parts):
                out[i, : a.shape[0]] = a
            return out

        arrays = [stacked(v) for v in values]
        arrays += [stacked([b.col_validity(ci) for b in batches]) for ci in range(ncols)]
        sel = stacked([b.device.sel for b in batches])
        pid = stacked(pids)

        # slot capacity from the exact routing matrix: overflow is impossible
        slot_cap = bucket_capacity(max(int(stats.rows.max()), 1))
        recv, rsel, overflow = pid_exchange_step(self.mesh, slot_cap)(arrays, sel, pid)
        if int(overflow) != 0:
            raise RuntimeError(f"mesh exchange {stats.exchange_id} dropped {int(overflow)} "
                               "rows from slots sized by the exact routing counts")
        stats.slot_cap = slot_cap
        rvals, rmasks = recv[:ncols], recv[ncols:]
        # the partitions this process holds, keyed by global id (SPMD: local
        # receive row i is partition local_parts[i])
        resources[stats.exchange_id] = {
            p: [Batch(schema, DeviceBatch(rsel[i], tuple(v[i] for v in rvals),
                                          tuple(m[i] for m in rmasks)), tuple(dicts))]
            for i, p in enumerate(self.local_parts)
        }
        return ResourceScanExec(schema, stats.exchange_id)

    # ---- durable file transport ---------------------------------------

    def _workdir_is_shared(self) -> bool:
        """SPMD capability probe (once per driver): process 0 writes a token
        under work_dir, a control-plane barrier lands, every process checks
        that it sees the token, and an allgather ANDs the answers."""
        if self._workdir_shared is not None:
            return self._workdir_shared
        from auron_tpu_torch.parallel import multihost

        # every process walks the same collective sequence even without a
        # work_dir of its own: an early return would leave its peers waiting
        token = os.path.join(self.work_dir, ".auron_shared_probe") if self.work_dir else None
        if token and self.mesh.process_index == 0:
            os.makedirs(self.work_dir, exist_ok=True)
            with open(token, "w") as f:
                f.write("probe")
        multihost.barrier()
        saw = np.array([1 if token and os.path.exists(token) else 0], dtype=np.int64)
        self._workdir_shared = bool(multihost.allgather_array(saw).min() == 1)
        return self._workdir_shared

    def _file_exchange(self, part, schema: T.Schema, batches: list[Batch], ex_id: str,
                       resources: dict) -> ExecOperator:
        from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec, MultiMapBlockProvider
        from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec

        if self.work_dir:
            work = self.work_dir
            os.makedirs(work, exist_ok=True)
        else:
            work = tempfile.mkdtemp(prefix="auron_exchange_")
            self._tmp_dirs.append(work)  # removed after the residual run
        src_id = ex_id + "__src"
        resources[src_id] = [[b] for b in batches]
        # SPMD: this process writes only its own shards' map outputs, named
        # by global shard id; a barrier then makes every peer's files
        # visible before any read
        map_ids = self.local_parts if self.spmd else list(range(len(batches)))
        pairs = [(os.path.join(work, f"{ex_id}_map{p}.data"),
                  os.path.join(work, f"{ex_id}_map{p}.index"))
                 for p in (range(self.n_parts) if self.spmd else map_ids)]
        try:
            for local_i, p in enumerate(map_ids):
                data_f, index_f = pairs[p]
                w = ShuffleWriterExec(ResourceScanExec(schema, src_id), part, data_f, index_f)
                for _ in self._run_partition(w, local_i, resources):
                    pass
        finally:
            resources.pop(src_id, None)
        if self.spmd:
            from auron_tpu_torch.parallel import multihost

            multihost.barrier()
        provider = MultiMapBlockProvider(pairs)
        # SPMD: coalescing and skew splitting would resize the reduce stage,
        # but every process owns a fixed set of partitions
        if not self.spmd and (self.conf.get(EXCHANGE_COALESCE_ENABLE)
                              or self.conf.get(EXCHANGE_SKEW_ENABLE)):
            from auron_tpu_torch.parallel.broadcast import map_output_sizes

            # coalescing reads the per-partition totals, skew splitting the
            # per-map breakdown
            per_map = map_output_sizes([i for _, i in pairs], self.n_parts)
            self._coalesce_candidates[ex_id] = (provider, per_map.sum(axis=0), per_map)
        resources[ex_id] = provider
        return IpcReaderExec(schema, ex_id)


def _as_tree(plan) -> ExecOperator:
    """An operator tree as given, or a plan proto pruned and planned."""
    if isinstance(plan, ExecOperator):
        return plan
    from auron_tpu_torch.plan.optimizer import prune_columns
    from auron_tpu_torch.plan.planner import plan_from_proto

    return plan_from_proto(prune_columns(plan))


def _collect_sources(op: ExecOperator) -> list[tuple[str, str]]:
    """All leaves of a resolved sub-plan as (kind, resource id)."""
    if op.children:
        return [s for c in op.children for s in _collect_sources(c)]
    kind = {"IpcReaderExec": "ipc_reader", "ResourceScanExec": "memory_scan"}.get(op.name,
                                                                                  op.name)
    return [(kind, getattr(op, "resource_id", ""))]


def _partition_scoped(op: ExecOperator) -> bool:
    """Operators whose output depends on seeing a whole partition: running a
    partition as several slices would change their result (a regrouping
    aggregate, a window, a limit, a per-partition top-k)."""
    if op.name == "HashAggExec":
        return op.mode != "partial"
    if op.name == "SortExec":
        return op.fetch is not None
    return op.name in ("WindowExec", "WindowGroupLimitExec", "LimitExec")


#: operators allowed between the SMJ and its exchange leaf on a split side:
#: per-row ones, or whole-input sorts feeding the join
_SLICE_SAFE_BELOW = ("SortExec", "ProjectExec", "FilterExec", "IpcReaderExec",
                     "RenameColumnsExec")


def _slice_safe(op: ExecOperator) -> bool:
    if op.name not in _SLICE_SAFE_BELOW or (op.name == "SortExec" and op.fetch is not None):
        return False
    return op.name == "IpcReaderExec" or _slice_safe(op.children[0])


def _find_single_smj(plan: ExecOperator):
    """The stage's sort-merge join when the stage can be skew-split: exactly
    one SMJ, no partition-scoped operator above it, and only slice-safe
    operators from it down to its leaves (``mesh_driver.py:836-887``)."""
    found: list = []
    blocked = False

    def rec(op: ExecOperator, above_scoped: bool) -> None:
        nonlocal blocked
        if op.name == "SortMergeJoinExec":
            found.append(op)
            blocked = blocked or above_scoped or not all(_slice_safe(c) for c in op.children)
            return
        scoped = above_scoped or _partition_scoped(op)
        for c in op.children:
            rec(c, scoped)

    rec(plan, False)
    return found[0] if len(found) == 1 and not blocked else None


def _group_maps_by_bytes(per_map, target: float) -> list[tuple[int, int]]:
    """Contiguous map ranges of about ``target`` bytes each (at least one
    map a range; together they cover every map). A small tail folds into
    the last range: every extra slice re-reads the other side."""
    groups: list[tuple[int, int]] = []
    lo, acc = 0, 0.0
    for m, b in enumerate(per_map):
        acc += b
        if acc >= target:
            groups.append((lo, m + 1))
            lo, acc = m + 1, 0.0
    if lo < len(per_map):
        if groups and acc < target / 2:
            groups[-1] = (groups[-1][0], len(per_map))
        else:
            groups.append((lo, len(per_map)))
    return groups or [(0, len(per_map))]


def _row_width_bytes(schema: T.Schema) -> int:
    """Rough per-row device byte width (values + validity) for stats."""
    width = 1  # sel
    for f in schema:
        width += f.dtype.numpy_dtype().itemsize + 1
    return width
