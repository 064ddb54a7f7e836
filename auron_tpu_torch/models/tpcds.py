"""TPC-DS-class data and query pipelines (port of the parts of
``auron_tpu/models/tpcds.py`` the ported slices need).

- ``generate(sf, seed)``: the synthetic star schema as numpy columns,
  bit-identical to ``auron_tpu.models.tpcds.generate`` for the same
  ``sf``/``seed`` (same ``numpy.random.default_rng`` call sequence; no
  pandas);
- ``to_batches``: per-partition device batch lists (``1 << 20`` rows per
  batch by default, as in the JAX package);
- ``q42_plan``, ``q93_map_plan``/``q93_reduce_plan`` and
  ``q3_map_plan``/``q3_reduce_plan``: the reference's plans of those
  classes, made by the port's builders (``plan/builders.py``); each
  ``*_tree`` of them is the planner's tree of its plan
  (``planner.tree_from_plan``: elision, pruning, planning);
- ``run_q42_class``: star join + group-by + ORDER BY revenue DESC LIMIT 10
  (TakeOrdered), started from ``TaskDefinition`` bytes through
  ``bridge.api.call_native``, as every task of ``run_q93_class`` and
  ``run_q3_class`` is; ``run_q42_c_abi`` and ``run_q93_c_abi`` run the
  same plans from a C host through the port's C ABI (``csrc/``);
- ``q42_class_oracle``: the same answer in plain numpy;
- ``run_q93_class``: the null-skew left join across a file hash shuffle on
  one nullable int64 key (the partition-id kernel K1's main user), and
  ``run_q3_class``: the flagship two-join partial aggregate, file shuffle on
  two int32 keys, final aggregate and driver-side top-k — both two-stage
  flows through ``_shuffle_stage``, with numpy oracles;
- ``run_q93_mesh`` and ``run_q3_mesh``: the same two queries as ONE plan
  with a ``MeshExchangeExec`` stage boundary, run by the planned-exchange
  driver (``parallel/mesh_driver.py``) over P logical partitions on one
  device, mesh or file transport; q3 then runs the lowered SQL q3's
  single-task collect stage (``SortExec`` fetch 100 -> ``LimitExec``);
- the other shuffle-heavy gate classes, each over file shuffles through
  ``_run_stages`` with a numpy oracle: ``run_q72_class`` (both facts
  shuffled on item, a sort-merge join on (item, date) under
  ``auron.smj.elide.sorts``), ``run_q95_class`` (left-semi joins below two
  exchanges, a left-anti join above), ``run_q18_class``,
  ``run_q14_class`` (two chained exchanges), ``run_q65_class`` and
  ``run_q5_class`` (a union of two exchanges);
- ``run_q72_mesh`` (q72 as one plan through the planned-exchange driver)
  and ``run_skew_join`` (a hot-key join stage that AQE skew-join
  splitting widens);
- the 22 classes of ``TAIL_CLASSES`` (CASE, IN, LIKE, residual join
  conditions, a three-way sort-merge join chain, CTEs read twice,
  INTERSECT/EXCEPT as semi/anti joins, ...), each through the task runtime
  with the JAX function's partition and task counts and its operator
  tree, with a numpy oracle.

- the decimal paths (``DECIMAL_CLASSES``): ``run_q9b_class`` (the
  reference's wide-decimal class: 20,000 decimal(38,4) amounts in 8 groups,
  one of them past 38 digits), ``run_q3_decimal_class`` (q3 with the price
  cast to TPC-DS's money type decimal(7,2): the partial sum is
  decimal(17,2) and crosses the shuffle as DEC128 planes),
  ``run_q42_decimal_class`` (q42 with ``sum(price * quantity)`` a wide
  decimal(28,2) sum and ``avg(price)`` a decimal(11,6)) and
  ``run_windowed_class(..., money=True)`` (the windowed class over
  decimal(17,2) revenues), each with an exact oracle in int64 cents or
  Python decimals.
- the probe class (``run_probe_agg_class``): a generic aggregate of the
  fact by (item, date) whose keys repeat across batches, the workload of
  the incremental aggregate's sorted-state probe; no reference class has
  it at SF 8.
- the generate classes (``GENERATE_CLASSES``): ``run_generate_class``
  (the reference's 42nd class: ``explode(split(i_tags, ','))`` over item,
  count by tag) and ``run_tag_revenue_class`` (the same explode over the
  whole fact after a broadcast join with item, count and price sum by
  tag), with numpy oracles; ``exploded_rows`` counts what each explodes.

Every run's ``stats`` (``add_timers``) gets the host timers, the
``COUNTERS`` (with each aggregate's dense / probe / generic batches) and
``fusion`` (segments fused and left eager by reason, CUDA-graph captures,
replays and graph bytes).

A stage's tasks run on ``runtime.task.slots`` concurrent slots
(``run_tasks_parallel``: a thread each, and on the card a CUDA stream
each; the JAX package runs them on threads), one after another by default;
the two-stage classes take ``parallel`` and q93 and q72 ``transport="rss"``
(an in-process remote shuffle service over TCP, ``RssTransport``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exec.base import ExecOperator
from auron_tpu_torch.exprs.ir import (
    BinaryOp, Case, Cast, If, In, IsNull, Like, Literal, ScalarFunc, col, lit,
)
from auron_tpu_torch.ops.sortkeys import SortSpec
from auron_tpu_torch.plan import builders as B
from auron_tpu_torch.plan.planner import tree_from_plan
from auron_tpu_torch.utils.config import Configuration, conf_scope


@dataclass
class Table:
    schema: T.Schema
    columns: dict  # name -> numpy array (strings: object / unicode arrays)
    valid: dict  # name -> bool array, only for columns holding NULLs

    def __len__(self) -> int:
        return len(next(iter(self.columns.values())))

    def validity(self, name: str) -> np.ndarray:
        v = self.valid.get(name)
        return np.ones(len(self), bool) if v is None else v


@dataclass
class TpcdsData:
    store_sales: Table
    date_dim: Table
    item: Table

    def fact_rows(self) -> int:
        return len(self.store_sales)


def _schema(*fields) -> T.Schema:
    return T.Schema(tuple(T.Field(n, t, True) for n, t in fields))


STORE_SALES_SCHEMA = _schema(
    ("ss_sold_date_sk", T.INT64), ("ss_item_sk", T.INT64), ("ss_customer_sk", T.INT64),
    ("ss_quantity", T.INT32), ("ss_ext_sales_price", T.FLOAT64),
)
DATE_DIM_SCHEMA = _schema(("d_date_sk", T.INT64), ("d_year", T.INT32), ("d_moy", T.INT32))
ITEM_SCHEMA = _schema(
    ("i_item_sk", T.INT64), ("i_brand_id", T.INT32), ("i_category_id", T.INT32),
    ("i_category", T.STRING), ("i_tags", T.STRING),
)


def generate(sf: float = 0.01, seed: int = 42) -> TpcdsData:
    """Synthetic star schema; sf=1 ~ 2.88M fact rows. The rng calls follow
    auron_tpu.models.tpcds.generate one for one."""
    rng = np.random.default_rng(seed)
    n_fact = int(2_880_000 * sf)
    n_dates = 365 * 5
    n_items = max(int(18_000 * min(sf * 10, 1.0)), 100)

    date_sk = 2_450_815 + np.arange(n_dates)
    years = 1998 + (np.arange(n_dates) // 365)
    moy = (np.arange(n_dates) % 365) // 31 + 1
    date_dim = Table(DATE_DIM_SCHEMA, {
        "d_date_sk": date_sk.astype(np.int64),
        "d_year": years.astype(np.int32),
        "d_moy": np.minimum(moy, 12).astype(np.int32),
    }, {})

    tag_pool = np.array(["new", "sale", "clearance", "eco", "import", "bulk"])
    item_cols = {"i_item_sk": np.arange(1, n_items + 1, dtype=np.int64)}
    item_cols["i_brand_id"] = rng.integers(1_000_000, 1_010_000, n_items).astype(np.int32)
    item_cols["i_category_id"] = rng.integers(1, 11, n_items).astype(np.int32)
    item_cols["i_category"] = rng.choice(
        ["Books", "Home", "Electronics", "Music", "Sports"], n_items).astype(object)
    tags = np.empty(n_items, dtype=object)
    tags[:] = [",".join(rng.choice(tag_pool, rng.integers(1, 4), replace=False))
               for _ in range(n_items)]
    item_cols["i_tags"] = tags
    item = Table(ITEM_SCHEMA, item_cols, {})

    prices = np.round(rng.gamma(2.0, 25.0, n_fact), 2)
    ss = {"ss_sold_date_sk": rng.choice(date_sk, n_fact).astype(np.int64)}
    ss["ss_item_sk"] = rng.integers(1, n_items + 1, n_fact).astype(np.int64)
    null_cust = rng.random(n_fact) < 0.04
    cust = rng.integers(1, 100_000, n_fact)
    ss["ss_customer_sk"] = np.where(null_cust, 0, cust).astype(np.int64)
    ss["ss_quantity"] = rng.integers(1, 100, n_fact).astype(np.int32)
    ss["ss_ext_sales_price"] = prices
    store_sales = Table(STORE_SALES_SCHEMA, ss, {"ss_customer_sk": ~null_cust})
    return TpcdsData(store_sales, date_dim, item)


def to_batches(table: Table, n_partitions: int, batch_rows: int = 1 << 20,
               device="cuda") -> list[list[Batch]]:
    """Split a table into per-partition device batch lists."""
    parts: list[list[Batch]] = []
    n = len(table)
    per = (n + n_partitions - 1) // n_partitions
    names = table.schema.names
    for p in range(n_partitions):
        lo, hi = min(p * per, n), min((p + 1) * per, n)
        starts = list(range(lo, hi, batch_rows)) or [lo]
        parts.append([
            Batch.from_numpy(
                [table.columns[c][s:min(s + batch_rows, hi)] for c in names],
                table.schema,
                [table.validity(c)[s:min(s + batch_rows, hi)] for c in names],
                device=device,
            )
            for s in starts
        ])
    return parts


# ---------------------------------------------------------------------------
# q42-class: star group-by + TakeOrdered
# ---------------------------------------------------------------------------


#: the leaf builders of the plans below, from (schema, resource id): device
#: batches (``memory_scan``) or host Arrow batches (``ffi_reader``)
_resource_scan = B.memory_scan
_ffi_reader = B.ffi_reader


def q42_plan(scan=_resource_scan):
    """SELECT i_brand_id brand, sum(ss_ext_sales_price) rev FROM store_sales
    JOIN item ON ss_item_sk = i_item_sk GROUP BY brand ORDER BY rev DESC,
    brand LIMIT 10: the reference's plan (``auron_tpu/models/tpcds.py``
    ``run_q42_class``). ``scan`` builds the leaves."""
    fact = scan(STORE_SALES_SCHEMA, "q42_fact")
    item = scan(ITEM_SCHEMA, "q42_item")
    j = B.hash_join(fact, item, [col(1)], [col(0)], "inner", build_side="right")
    pr = B.project(j, [(col(6), "brand"), (col(4), "p")])
    p = B.hash_agg(pr, [(col(0), "brand")], [("sum", col(1), "rev")], "partial")
    f = B.hash_agg(p, [(col(0), "brand")], [("sum", col(1), "rev")], "final")
    return B.sort(f, [(col(1), SortSpec(asc=False)), (col(0), SortSpec())], fetch=10)


def q42_exec_tree(scan=_resource_scan):
    """The planner's tree of ``q42_plan(scan)`` (the join's projection keeps
    [price, brand])."""
    return tree_from_plan(q42_plan(scan))


def ingest_q42(data: TpcdsData, device="cuda", batch_rows: int = 1 << 20) -> dict:
    """Device-resident inputs of the q42 task (resource id -> partitions)."""
    return {
        "q42_fact": to_batches(data.store_sales, 1, batch_rows, device),
        "q42_item": to_batches(data.item, 1, batch_rows, device),
    }


def collect(batches: list[Batch], nulls: bool = False) -> dict[str, np.ndarray]:
    """Live rows of output batches as host columns. A repeated column name
    gets its position appended (a join's ``i``, ``i_2``); ``nulls`` adds
    each column's validity as ``<name>_valid``."""
    cols: dict[str, list] = {}
    for b in batches:
        names, seen = [], set()
        for i, n in enumerate(b.schema.names):
            names.append(n if n not in seen else f"{n}_{i}")
            seen.add(n)
        named = Batch(T.Schema(tuple(T.Field(n, f.dtype, f.nullable)
                                     for n, f in zip(names, b.schema))), b.device, b.dicts)
        for name, (v, m) in named.to_numpy().items():
            cols.setdefault(name, []).append(v)
            if nulls:
                cols.setdefault(f"{name}_valid", []).append(m)
    return {k: np.concatenate(v) for k, v in cols.items()}


def run_q42_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  ingested: dict | None = None, stats: dict | None = None) -> dict[str, np.ndarray]:
    """The q42-class query, started from its ``TaskDefinition`` bytes through
    ``bridge.api.call_native``; returns {brand, rev}. ``stats`` gets the
    metric tree's host timers (``add_timers``), ``task_bytes``,
    ``decode_s`` and ``plan_s``."""
    if ingested is None:
        ingested = ingest_q42(data, device)
    out, snapshot = run_task_bytes(B.task(q42_plan(), conf=conf).SerializeToString(),
                                   dict(ingested), device)
    if stats is not None:
        add_timers(stats, snapshot)
    out = collect(out)
    return {"brand": out["brand"], "rev": out["rev"]}


def run_task_bytes(task: bytes, resources: dict, device) -> tuple[list[Batch], dict]:
    """One task from serialized ``TaskDefinition`` bytes through
    ``bridge.api.call_native`` (``resources`` overlay the bridge's map for
    this task), drained: (output batches, metric snapshot, whose ``"task"``
    holds the bytes, decode and planning seconds)."""
    from auron_tpu_torch.bridge import api

    run = api.native_task(task, resources, device)
    with run as h:
        out = list(iter(lambda: api.next_batch(h), None))
    return out, run.metrics


def q42_class_oracle(data: TpcdsData) -> dict[str, np.ndarray]:
    ss, it = data.store_sales.columns, data.item.columns
    order = np.argsort(it["i_item_sk"], kind="stable")
    keys = it["i_item_sk"][order]
    pos = np.clip(np.searchsorted(keys, ss["ss_item_sk"]), 0, len(keys) - 1)
    hit = keys[pos] == ss["ss_item_sk"]
    brand = it["i_brand_id"][order][pos][hit]
    price = ss["ss_ext_sales_price"][hit]
    uniq, inv = np.unique(brand, return_inverse=True)
    rev = np.bincount(inv.reshape(-1), weights=price, minlength=len(uniq))
    top = np.lexsort((uniq, -rev))[:10]
    return {"brand": uniq[top].astype(np.int32), "rev": rev[top]}


# ---------------------------------------------------------------------------
# two-stage flows: map tasks hash-shuffled into files, then reduce tasks
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run_tasks_parallel(fns: list, device="cpu", slots: int | None = None) -> list:
    """Run task closures on concurrent slots (Spark's task slots; reference
    ``tpcds.py:943-955``): a thread each, at most ``slots`` at once (all of
    them by default), and on the card a CUDA stream each, ordered after the
    caller's stream (the inputs it made) and finished before the slot
    returns. Results in input order; the first error propagates. One task
    or one slot runs them one after another on the caller's thread."""
    import concurrent.futures as cf

    slots = len(fns) if slots is None else slots
    if len(fns) <= 1 or slots <= 1:
        return [fn() for fn in fns]
    if not str(device).startswith("cuda"):
        def run(fn):
            return fn()
    else:
        import torch

        from auron_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        base = torch.cuda.current_stream(dev)

        def run(fn):
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(base)
            with torch.cuda.stream(stream):
                out = fn()
            stream.synchronize()
            return out

    with cf.ThreadPoolExecutor(max_workers=min(len(fns), slots)) as ex:
        return list(ex.map(run, fns))


def _slots(conf: Configuration) -> int:
    from auron_tpu_torch.utils.config import TASK_SLOTS

    return conf.get(TASK_SLOTS)


class RssTransport:
    """A stage's shuffle through a remote shuffle service: an in-process
    ``RssNetServer`` on 127.0.0.1 over a ``LocalRssService`` with
    ``replicas`` replicas, one client for the run's tasks (map tasks push
    through ``RemotePartitionWriter``, reduce tasks fetch through
    ``RemoteBlockProvider``). ``close`` stops both."""

    def __init__(self, replicas: int = 2, replica: int = 0):
        from auron_tpu_torch.exec.shuffle.rss import LocalRssService
        from auron_tpu_torch.exec.shuffle.rss_net import RssNetClient, RssNetServer

        self.server = RssNetServer(LocalRssService(num_replicas=replicas))
        self.client = RssNetClient(self.server.addr)
        self.replica = replica

    def writer(self, shuffle_id: str, map_id: int):
        from auron_tpu_torch.exec.shuffle.rss_net import RemotePartitionWriter

        return RemotePartitionWriter(self.client, shuffle_id, map_id)

    def provider(self, shuffle_id: str):
        from auron_tpu_torch.exec.shuffle.rss_net import RemoteBlockProvider

        return RemoteBlockProvider(self.client, shuffle_id, self.replica)

    def close(self) -> None:
        self.client.close()
        self.server.close()


def _shuffle_stage(plan, out_schema: T.Schema, key_cols: list[int], n_map: int, n_reduce: int,
                   work: str, rid: str, resources: dict, stage_id: int = 1,
                   conf: Configuration | None = None, device="cuda", stats: dict | None = None,
                   rss: RssTransport | None = None):
    """Run ``plan`` as ``n_map`` map tasks hash-shuffled on ``key_cols``
    into files under ``work`` (or pushed to ``rss``), on
    ``runtime.task.slots`` concurrent slots; registers the exchange's block
    provider as ``resources[rid]`` and returns the reduce side's reader. A
    plan proto's tasks start from ``TaskDefinition`` bytes
    (``run_task_bytes``) and its reader is an ``ipc_reader`` node; an exec
    tree's (the classes not moved to the plan IR yet) run through
    ``run_task`` and its reader is an ``IpcReaderExec``."""
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec, MultiMapBlockProvider
    from auron_tpu_torch.exec.shuffle.writer import RssShuffleWriterExec, ShuffleWriterExec
    from auron_tpu_torch.runtime.task import run_task

    conf = conf or Configuration()
    pairs = [(os.path.join(work, f"{rid}_m{p}.data"), os.path.join(work, f"{rid}_m{p}.index"))
             for p in range(n_map)]
    wkey = f"{rid}_rss_writer"

    def map_task(p: int):
        d, i = pairs[p]
        res = resources if rss is None else {**resources, wkey: rss.writer(rid, p)}
        if isinstance(plan, ExecOperator):
            part = HashPartitioning([col(c) for c in key_cols], n_reduce)
            w = (ShuffleWriterExec(plan, part, d, i) if rss is None
                 else RssShuffleWriterExec(plan, part, wkey))
            return run_task(w, res, stage_id, p, conf, device)[1]
        part = B.hash_partitioning([col(c) for c in key_cols], n_reduce)
        w = (B.shuffle_writer(plan, part, d, i) if rss is None
             else B.rss_shuffle_writer(plan, part, wkey))
        task = B.task(w, stage_id, p, dict(conf.items()))
        return run_task_bytes(task.SerializeToString(), res, device)[1]

    for metrics in run_tasks_parallel([(lambda p=p: map_task(p)) for p in range(n_map)],
                                      device, _slots(conf)):
        if stats is not None:
            stats["shuffle_bytes"] = stats.get("shuffle_bytes", 0) + metrics["values"]["data_size"]
            add_timers(stats, metrics)
    resources[rid] = MultiMapBlockProvider(pairs) if rss is None else rss.provider(rid)
    if isinstance(plan, ExecOperator):
        return IpcReaderExec(out_schema, rid)
    return B.ipc_reader(out_schema, rid)


#: operator counters ``add_timers`` also sums: batches folded into a dense
#: aggregate table, the generic path's merges and partial-skip switches,
#: the spills (sort runs, aggregate states, shuffle staging runs), and the
#: host reads (``runtime/transfer.py``): probe streams that reached a
#: unique-join compaction boundary, reads the code blocked on (seed,
#: repair), harvests that found their copy done, in-stream harvests that
#: had to wait for the card, end-of-stream harvests that waited, and
#: predicted buckets that proved too small; the shuffle writer's DEC128
#: (decimal) columns written; and a GenerateExec's input batches, output
#: chunks and exploded rows
COUNTERS = ("elapsed_compute_n", "num_merges", "partial_agg_skipped", "spilled_runs",
            "spilled_aggs", "spilled_shuffle_runs", "unique_streams", "blocking_reads",
            "async_reads", "waited_reads", "drain_waits", "sel_mispredicts",
            "shuffle_enc_dec128", "dense_batches", "probe_batches", "probe_miss_batches",
            "generic_batches", "probe_hit_rows", "merge_path_merges", "fp_collision_batches",
            "fused_batches", "stage_captures", "stage_replays", "generate_batches",
            "generate_chunks", "exploded_rows", "row_groups_total", "row_groups_pruned",
            "row_groups_pruned_late", "stripes_pruned_late", "corrupted_files_skipped",
            "bytes_scanned", "fs_raw_reads", "fs_bytes_fetched", "rows_written",
            "partitions_written", "shuffle_bytes_raw", "shuffle_bytes_written",
            "shuffle_bytes_read", "shuffle_enc_codec", "shuffle_enc_arrow", "shuffle_enc_dict")

#: the counters ``stats["fusion"]`` sums over every operator: the fused
#: stages' (and standalone fused filters') CUDA-graph captures and replays
_FUSION_COUNTERS = {"stage_captures": "captures", "stage_replays": "replays",
                    "fused_batches": "fused_batches"}


@contextlib.contextmanager
def memory_scope(conf: Configuration, stats: dict | None):
    """The run's memory manager: a fresh one built under ``conf`` when it
    sets any ``memory.*`` key (the process manager comes back after the
    run), else the process manager. ``stats["memory"]`` gets the run's
    budget, the manager's spills and waits, and what the spill containers
    parked (``memmgr.SPILL_STATS``: bytes on host and on disk, demotions)."""
    from auron_tpu_torch.memory.memmgr import SPILL_STATS, MemManager

    scoped = any(k.startswith("memory.") for k in conf.keys())
    prev = MemManager._instance
    if scoped:
        with conf_scope(conf):
            mm = MemManager.init()
    else:
        mm = MemManager.get()
    spills, waits, parked = mm.num_spills, mm.num_waits, dict(SPILL_STATS)
    try:
        yield
    finally:
        if scoped:
            MemManager._instance = prev
        if stats is not None:
            mem = stats.setdefault("memory", {"budget_bytes": mm.budget, "num_spills": 0,
                                              "num_waits": 0, **dict.fromkeys(SPILL_STATS, 0)})
            mem["num_spills"] += mm.num_spills - spills
            mem["num_waits"] += mm.num_waits - waits
            for k, v in SPILL_STATS.items():
                mem[k] += v - parked[k]


def add_timers(stats: dict, snapshot: dict) -> None:
    """Sum the metric tree's host timers (seconds) into ``stats["timers"]``,
    keyed operator.timer (timers nest: a parent's span covers the children
    it pulls from), and the ``COUNTERS`` into ``stats["counters"]``
    (per HashAggExec: the batches that folded into the dense table, took
    the probe or the generic path, the probe's hit rows and harvested miss
    batches, merge-path merges and collision batches). ``stats["fusion"]``
    gets the task's fused segments and the segments left eager by reason
    (plan time), its CUDA-graph captures and replays, and the bytes of
    the graphs the process-wide cache holds after it (``pool_bytes``). A
    task started from bytes adds its ``task_bytes``, ``decode_s`` and
    ``plan_s`` (``runtime/task.py``), summed over the run's tasks."""
    for k, v in snapshot.get("task", {}).items():
        stats[k] = stats.get(k, 0) + v
    timers = stats.setdefault("timers", {})
    counters = stats.setdefault("counters", {})
    fusion = stats.setdefault("fusion", {"segments": 0, "eager": {}, "captures": 0,
                                         "replays": 0, "fused_batches": 0})
    if "fusion" in snapshot:
        from auron_tpu_torch.plan.fusion import fusion_stats

        fusion["pool_bytes"] = fusion_stats()["pool_bytes"]  # the cache's, now
        fusion["segments"] += snapshot["fusion"]["segments"]
        for r, n in snapshot["fusion"]["eager"].items():
            fusion["eager"][r] = fusion["eager"].get(r, 0) + n
    op = snapshot["name"].split(".")[0]
    for k, v in snapshot["values"].items():
        if k.endswith(("_time", "elapsed_compute", "merge_path_s")):
            timers[f"{op}.{k}"] = timers.get(f"{op}.{k}", 0.0) + v / 1e9
        elif k in COUNTERS:
            counters[f"{op}.{k}"] = counters.get(f"{op}.{k}", 0) + v
        if k in _FUSION_COUNTERS:
            fusion[_FUSION_COUNTERS[k]] += v
    for c in snapshot["children"]:
        add_timers(stats, c)


def _run_stages(stages: list, reduce_plan_of, resources: dict, n_reduce: int, label: str,
                work_dir, conf, device, stats, nulls: bool = False,
                transport: str = "file") -> list[dict]:
    """Map stages hash-shuffled into files (or, with ``transport="rss"``,
    pushed to an in-process remote shuffle service over TCP:
    ``RssTransport``) one after another, then one reduce task per partition
    over ``reduce_plan_of(*readers)``; the tasks of a stage run on
    ``runtime.task.slots`` concurrent slots (``run_tasks_parallel``).
    Returns the reduce tasks' outputs as host columns. A stage is a
    callable taking the readers of the stages before it and returning (map
    plan, output schema, key columns, map tasks, resource id); plans are
    plan protos (each task from ``TaskDefinition`` bytes) or exec trees
    (``_shuffle_stage``). ``stats`` gets each stage's wall (``stage_s``),
    their sum ``map_s``, ``reduce_s``, the shuffle bytes and the slots."""
    from auron_tpu_torch.runtime.task import run_task

    work = work_dir or tempfile.mkdtemp(prefix=f"auron_{label}_")
    os.makedirs(work, exist_ok=True)
    stats = stats if stats is not None else {}
    if transport not in ("file", "rss"):
        raise ValueError(f"transport must be file or rss, got {transport!r}")
    rss = RssTransport() if transport == "rss" else None
    stats["slots"] = _slots(conf)
    rids = []
    try:
        with memory_scope(conf, stats):
            readers = []
            stage_s = stats.setdefault("stage_s", {})
            for sid, stage in enumerate(stages, 1):
                t0 = time.perf_counter()
                plan, schema, keys, n_map, rid = stage(readers)
                rids.append(rid)
                readers.append(_shuffle_stage(plan, schema, keys, n_map, n_reduce, work, rid,
                                              resources, sid, conf, device, stats, rss))
                _sync(device)
                stage_s[rid] = time.perf_counter() - t0
            t1 = time.perf_counter()
            reduce_plan = reduce_plan_of(*readers)

            def reduce_task(r: int):
                if isinstance(reduce_plan, ExecOperator):
                    batches, metrics = run_task(reduce_plan, resources, len(stages) + 1, r,
                                                conf, device)
                else:
                    task = B.task(reduce_plan, len(stages) + 1, r, dict(conf.items()))
                    batches, metrics = run_task_bytes(task.SerializeToString(), resources,
                                                      device)
                return collect(batches, nulls), metrics

            outs = []
            for out, metrics in run_tasks_parallel(
                    [(lambda r=r: reduce_task(r)) for r in range(n_reduce)], device,
                    _slots(conf)):
                outs.append(out)
                add_timers(stats, metrics)
            _sync(device)
            stats["map_s"] = sum(stage_s[r] for r in rids)
            stats["reduce_s"] = time.perf_counter() - t1
            return outs
    finally:
        for rid in rids:
            resources.pop(rid, None)
        if rss is not None:
            rss.close()
        if work_dir is None:
            shutil.rmtree(work, ignore_errors=True)


def _run_two_stage(map_plan, out_schema, key_cols, reduce_plan_of, resources, n_map, n_reduce,
                   rid, work_dir, conf, device, stats, transport: str = "file") -> list[dict]:
    """One map stage, then one reduce task per partition."""
    return _run_stages([lambda _: (map_plan, out_schema, key_cols, n_map, rid)],
                       reduce_plan_of, resources, n_reduce, rid, work_dir, conf, device, stats,
                       transport=transport)


def _concat(outs: list[dict], names: list[str], dtypes: list) -> dict[str, np.ndarray]:
    return {n: np.concatenate([o[n] for o in outs if o] or [np.empty(0, dt)])
            for n, dt in zip(names, dtypes)}


# ---------------------------------------------------------------------------
# q93-class: null-skew left join across a hash shuffle
# ---------------------------------------------------------------------------

CUSTOMER_SCHEMA = _schema(("c_customer_sk", T.INT64), ("c_band", T.INT64))
Q93_INTER_SCHEMA = _schema(("k", T.INT64), ("price", T.FLOAT64))


def customer_table() -> Table:
    """q93's 5,000-row customer dimension."""
    sk = np.arange(1, 5001, dtype=np.int64)
    return Table(CUSTOMER_SCHEMA, {"c_customer_sk": sk, "c_band": sk % 5}, {})


def ingest_q93(data: TpcdsData, n_map: int, device="cuda", fact=None) -> dict:
    """Device-resident inputs: the fact table in ``n_map`` partitions and
    the 5,000-row customer dimension."""
    return {"fact": fact if fact is not None else to_batches(data.store_sales, n_map,
                                                              device=device),
            "cust": to_batches(customer_table(), 1, device=device)[0]}


def q93_map_plan(scan=_resource_scan):
    """SELECT CASE WHEN ss_quantity < 85 THEN NULL ELSE ss_customer_sk END k,
    ss_ext_sales_price price FROM store_sales: ~85 % of the keys are NULL.
    The map side of the reference's plan (``auron_tpu/models/tpcds.py``
    ``run_q93_class``); ``scan`` builds the leaf."""
    key = If(BinaryOp("lt", col(3), Literal(85, T.INT32)), Literal(None, T.INT64), col(2))
    return B.project(scan(STORE_SALES_SCHEMA, "q93_fact"), [(key, "k"), (col(4), "price")])


def q93_reduce_plan(read, scan=_resource_scan):
    """``read`` (an ipc_reader or mesh_exchange node) LEFT JOIN customer ON
    k = c_customer_sk, grouped by k IS NULL: count(*) rows,
    count(c_customer_sk) matched, sum(price) s."""
    j = B.hash_join(read, scan(CUSTOMER_SCHEMA, "q93_cust"), [col(0)], [col(0)], "left",
                    build_side="right")
    p = B.hash_agg(j, [(IsNull(col(0)), "k_null")],
                   [("count_star", None, "rows"), ("count", col(2), "matched"),
                    ("sum", col(1), "s")], "partial")
    return B.hash_agg(p, [(col(0), "k_null")],
                      [("count_star", None, "rows"), ("count", col(1), "matched"),
                       ("sum", col(2), "s")], "final")


def q93_map_tree(scan=_resource_scan):
    """The planner's tree of ``q93_map_plan(scan)``."""
    return tree_from_plan(q93_map_plan(scan))


def q93_reduce_tree(read, scan=_resource_scan):
    """The planner's tree of ``q93_reduce_plan(read, scan)`` (the join keeps
    k, price and c_customer_sk)."""
    return tree_from_plan(q93_reduce_plan(read, scan))


def with_slots(conf: dict | None, parallel: bool | int, n_tasks: int) -> Configuration:
    """``conf`` with ``runtime.task.slots``: ``parallel`` True gives a slot
    per task, an int that many slots, False (or a slots key in ``conf``)
    leaves it."""
    from auron_tpu_torch.utils.config import TASK_SLOTS

    c = Configuration(conf or {})
    if parallel:
        c.set(TASK_SLOTS, n_tasks if parallel is True else int(parallel))
    return c


def run_q93_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                  work_dir: str | None = None, device="cuda", conf: dict | None = None,
                  ingested: dict | None = None, stats: dict | None = None,
                  transport: str = "file", parallel: bool | int = False) -> dict:
    """The q93-class query in two stages, every task from its
    ``TaskDefinition`` bytes; returns {k_null, rows, matched, s} sorted by
    k_null. ``transport="rss"`` shuffles through a remote shuffle service
    (``RssTransport``); ``parallel`` runs each stage's tasks on concurrent
    slots (``with_slots``). ``stats`` (optional) gets map_s, reduce_s,
    shuffle_bytes, the NULL keys' partition, rows per reduce partition, and
    the tasks' ``task_bytes``, ``decode_s`` and ``plan_s``."""
    if ingested is None:
        ingested = ingest_q93(data, n_map, device)
    n_map = len(ingested["fact"])
    resources = {"q93_fact": ingested["fact"], "q93_cust": [ingested["cust"]] * n_reduce}
    stats = stats if stats is not None else {}
    outs = _run_two_stage(q93_map_plan(), Q93_INTER_SCHEMA, [0], q93_reduce_plan, resources,
                          n_map, n_reduce, "q93_ex0", work_dir,
                          with_slots(conf, parallel, max(n_map, n_reduce)), device, stats,
                          transport)
    stats["null_partition"] = 42 % n_reduce
    stats["partition_rows"] = [int(o["rows"].sum()) if o else 0 for o in outs]
    return _q93_by_key(outs)


def _q93_by_key(outs: list[dict]) -> dict:
    """Per-partition q93 outputs summed by k_null, sorted by k_null."""
    got = _concat(outs, ["k_null", "rows", "matched", "s"],
                  [bool, np.int64, np.int64, np.float64])
    keys = np.unique(got["k_null"])
    return {"k_null": keys,
            "rows": np.array([got["rows"][got["k_null"] == k].sum() for k in keys], np.int64),
            "matched": np.array([got["matched"][got["k_null"] == k].sum() for k in keys],
                                np.int64),
            "s": np.array([got["s"][got["k_null"] == k].sum() for k in keys], np.float64)}


def q93_class_oracle(data: TpcdsData) -> dict:
    ss = data.store_sales
    c = ss.columns["ss_customer_sk"]
    k_valid = ss.validity("ss_customer_sk") & (ss.columns["ss_quantity"] >= 85)
    matched = k_valid & (c >= 1) & (c <= 5000)
    price = ss.columns["ss_ext_sales_price"]
    keys = np.unique(~k_valid)
    return {"k_null": keys,
            "rows": np.array([np.count_nonzero(~k_valid == k) for k in keys], np.int64),
            "matched": np.array([np.count_nonzero(matched & (~k_valid == k)) for k in keys],
                                np.int64),
            "s": np.array([price[~k_valid == k].sum() for k in keys], np.float64)}


# ---------------------------------------------------------------------------
# the host boundary: q42 and q93 from host Arrow batches to host answers
# ---------------------------------------------------------------------------


def host_batches(table: Table, n_partitions: int, batch_rows: int = 1 << 20) -> list[list]:
    """Per-partition host Arrow batches (``arrow_c.HostBatch``) of a table,
    split as ``to_batches`` splits it: what a host engine holds before it
    hands a scan over. Fixed-width columns are views of the table's arrays;
    validity is packed."""
    from auron_tpu_torch.columnar.arrow_c import HostBatch

    parts: list[list] = []
    n = len(table)
    per = (n + n_partitions - 1) // n_partitions
    names = table.schema.names
    for p in range(n_partitions):
        lo, hi = min(p * per, n), min((p + 1) * per, n)
        parts.append([
            HostBatch.from_numpy(
                [table.columns[c][s:min(s + batch_rows, hi)] for c in names], table.schema,
                [table.valid[c][s:min(s + batch_rows, hi)] if c in table.valid else None
                 for c in names])
            for s in (list(range(lo, hi, batch_rows)) or [lo])
        ])
    return parts


def _hand_over(rid: str, batches: list, schema: T.Schema) -> None:
    """Export ``batches`` as an ``ArrowArrayStream`` and hand its pointer to
    the bridge (``api.put_resource_c_stream``), as a JVM calls
    ``auron_put_resource_arrow``."""
    import ctypes

    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.columnar.arrow_c import ArrowArrayStream, export_stream

    s = ArrowArrayStream()
    export_stream(batches, ctypes.addressof(s), schema)
    api.put_resource_c_stream(rid, ctypes.addressof(s))


def _boundary_stats(stats: dict, before: dict, egress_s: float) -> None:
    """``stats`` gets the run's ingest counters (``batch.ingest_stats``
    deltas: ``ingest_s``, ``ingest_bytes``, ``zerocopy_planes``,
    ``copied_planes``) and ``egress_s``."""
    from auron_tpu_torch.columnar.batch import ingest_stats

    after = ingest_stats()
    for k, v in after.items():
        stats[k] = stats.get(k, 0) + v - before[k]
    stats["egress_s"] = stats.get("egress_s", 0.0) + egress_s


def host_q42(data: TpcdsData, batch_rows: int = 1 << 20) -> dict:
    """The q42 task's inputs as host Arrow batches (resource id -> batches)."""
    return {"q42_fact": host_batches(data.store_sales, 1, batch_rows)[0],
            "q42_item": host_batches(data.item, 1, batch_rows)[0]}


def run_q42_bridge(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                   host: dict | None = None, stats: dict | None = None) -> dict[str, np.ndarray]:
    """The q42-class query through the host boundary: its ``memory_scan``
    leaves are ``ffi_reader``s fed by Arrow C streams over host batches
    (``host_q42``), the task starts through ``bridge.api.call_native`` and
    the answer leaves through an ``ipc_writer`` as blocks the host decodes.
    Returns {brand, rev}. ``stats`` gets the host timers, the ingest
    counters, ``egress_s`` (the writer's ``egress_time`` and the host's
    decode) and ``stage_s`` (the task's wall)."""
    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.columnar.batch import ingest_stats
    from auron_tpu_torch.exec.shuffle.format import decode_block, iter_block_payloads
    from auron_tpu_torch.exec.sink import IpcWriterExec

    host = host if host is not None else host_q42(data)
    tree = IpcWriterExec(q42_exec_tree(_ffi_reader), "q42_out")
    schemas = {"q42_fact": STORE_SALES_SCHEMA, "q42_item": ITEM_SCHEMA}
    before = ingest_stats()
    channel: list = []
    t0 = time.perf_counter()
    try:
        for rid, batches in host.items():
            _hand_over(rid, batches, schemas[rid])
        h = api.call_native(tree, {"q42_out": channel}, device=device, conf=conf)
        try:
            while api.next_batch(h) is not None:
                pass
        finally:
            snapshot = api.finalize_native(h)
    finally:
        for rid in host:
            api.remove_resource(rid)
    t1 = time.perf_counter()
    brand, rev = [np.empty(0, np.int32)], [np.empty(0, np.float64)]
    for blk in channel:
        for payload in iter_block_payloads(blk):
            _, ((b, _), (r, _)) = decode_block(payload, tree.schema)
            brand.append(b)
            rev.append(r)
    decode_s = time.perf_counter() - t1
    if stats is not None:
        add_timers(stats, snapshot)
        _boundary_stats(stats, before, snapshot["values"].get("egress_time", 0) / 1e9 + decode_s)
        stats.setdefault("stage_s", {})["q42"] = t1 - t0
    return {"brand": np.concatenate(brand), "rev": np.concatenate(rev)}


def host_q93(data: TpcdsData, n_map: int, batch_rows: int = 1 << 20) -> dict:
    """The q93 inputs as host Arrow batches: the fact in ``n_map``
    partitions and the 5,000-row customer dimension."""
    return {"fact": host_batches(data.store_sales, n_map, batch_rows),
            "cust": host_batches(customer_table(), 1)[0]}


def run_q93_bridge(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                   work_dir: str | None = None, device="cuda", conf: dict | None = None,
                   host: dict | None = None, stats: dict | None = None) -> dict:
    """The q93-class query through the host boundary: each map task's
    ``ffi_reader`` takes its partition's Arrow C stream (``q93_fact.<p>``),
    the reduce tasks' customer leaf a callable exporter, every task starts
    through ``bridge.api.call_native``, and the reduce answers leave through
    ``next_batch_c`` into C structs the host imports. Returns {k_null, rows,
    matched, s} as ``run_q93_class`` does. ``stats`` gets map_s, reduce_s,
    ``stage_s``, shuffle bytes, host timers, the ingest counters and
    ``egress_s`` (``next_arrow``'s ``egress_time`` and the host's import)."""
    import ctypes

    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.columnar.arrow_c import ArrowArray, ArrowSchema, import_batch
    from auron_tpu_torch.columnar.batch import ingest_stats
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.exec.shuffle.reader import MultiMapBlockProvider
    from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec

    host = host if host is not None else host_q93(data, n_map)
    n_map = len(host["fact"])
    stats = stats if stats is not None else {}
    work = work_dir or tempfile.mkdtemp(prefix="auron_q93_bridge_")
    os.makedirs(work, exist_ok=True)
    names, dtypes = ["k_null", "rows", "matched", "s"], [bool, np.int64, np.int64, np.float64]
    before = ingest_stats()
    keys: list[str] = []
    outs: list[dict] = []
    egress_s = 0.0
    try:
        with memory_scope(Configuration(conf or {}), stats):
            t0 = time.perf_counter()
            for p in range(n_map):
                keys.append(f"q93_fact.{p}")
                _hand_over(keys[-1], host["fact"][p], STORE_SALES_SCHEMA)
            keys.append("q93_cust")
            api.put_resource("q93_cust", lambda _partition: host["cust"])
            part = HashPartitioning([col(0)], n_reduce)
            map_tree = q93_map_tree(_ffi_reader)
            pairs = []
            for p in range(n_map):
                d, i = os.path.join(work, f"q93_m{p}.data"), os.path.join(work, f"q93_m{p}.index")
                h = api.call_native(ShuffleWriterExec(map_tree, part, d, i), device=device,
                                    conf=conf, stage_id=1, partition_id=p)
                try:
                    while api.next_batch(h) is not None:
                        pass
                finally:
                    metrics = api.finalize_native(h)
                stats["shuffle_bytes"] = stats.get("shuffle_bytes", 0) + \
                    metrics["values"]["data_size"]
                add_timers(stats, metrics)
                pairs.append((d, i))
            _sync(device)
            t1 = time.perf_counter()
            keys.append("q93_ex0")
            api.put_resource("q93_ex0", MultiMapBlockProvider(pairs))
            reduce_tree = q93_reduce_tree(B.ipc_reader(Q93_INTER_SCHEMA, "q93_ex0"), _ffi_reader)
            for r in range(n_reduce):
                h = api.call_native(reduce_tree, device=device, conf=conf, stage_id=2,
                                    partition_id=r)
                rows: dict = {n: [] for n in names}
                try:
                    while True:
                        arr, sch = ArrowArray(), ArrowSchema()
                        if not api.next_batch_c(h, ctypes.addressof(arr), ctypes.addressof(sch)):
                            break
                        te = time.perf_counter()
                        for n, vals in import_batch(ctypes.addressof(arr),
                                                    ctypes.addressof(sch)).to_pydict().items():
                            rows[n] += vals
                        egress_s += time.perf_counter() - te
                finally:
                    metrics = api.finalize_native(h)
                egress_s += metrics["values"].get("egress_time", 0) / 1e9
                add_timers(stats, metrics)
                outs.append({n: np.array(rows[n], dt) for n, dt in zip(names, dtypes)}
                            if rows["k_null"] else {})
            _sync(device)
            t2 = time.perf_counter()
    finally:
        for k in keys:
            api.remove_resource(k)
        if work_dir is None:
            shutil.rmtree(work, ignore_errors=True)
    stats["map_s"], stats["reduce_s"] = t1 - t0, t2 - t1
    stats.setdefault("stage_s", {}).update({"map": t1 - t0, "reduce": t2 - t1})
    stats["null_partition"] = 42 % n_reduce
    stats["partition_rows"] = [int(o["rows"].sum()) if o else 0 for o in outs]
    _boundary_stats(stats, before, egress_s)
    return _q93_by_key(outs)


# ---------------------------------------------------------------------------
# the C host: q42 and q93 through the port's C ABI (csrc/auron_bridge.cpp)
# ---------------------------------------------------------------------------


def _c_abi_stats(stats: dict, runs: list) -> None:
    """Per harness process of a C-host run: its wall, the engine's start
    inside it, the resource registrations and the task (``processes``), the
    bytes it took as resources (``resource_bytes``) and the kernel launches
    it counted (``launches``)."""
    stats.setdefault("processes", []).extend(
        {"process_s": r.process_s, "init_s": r.init_s, "resources_s": r.resources_s,
         "task_s": r.task_s} for r in runs)
    stats["resource_bytes"] = stats.get("resource_bytes", 0) + sum(r.resource_bytes for r in runs)
    launches = stats.setdefault("launches", {})
    for r in runs:
        for k, v in r.metrics["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v


def run_q42_c_abi(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  host: dict | None = None, work_dir: str | None = None,
                  stats: dict | None = None) -> dict[str, np.ndarray]:
    """The q42-class query from a C host: ``q42_plan`` over ``ffi_reader``
    leaves, its ``TaskDefinition`` bytes and its inputs (``host_q42``) as
    Arrow IPC streams run through ``bridge_harness``, a separate C process
    that embeds the engine through the port's ``libauron_bridge``; the
    answer comes back as the harness's IPC batches. Returns {brand, rev}.
    ``stats`` gets the task's host timers, ``task_bytes``, ``decode_s`` and
    ``plan_s`` (``add_timers``) and what ``_c_abi_stats`` lists."""
    from auron_tpu_torch.bridge.host import run_harnesses
    from auron_tpu_torch.columnar import arrow_ipc

    host = host if host is not None else host_q42(data)
    task = B.task(q42_plan(_ffi_reader), conf=conf).SerializeToString()
    resources = {"q42_fact": arrow_ipc.write_stream(host["q42_fact"], STORE_SALES_SCHEMA),
                 "q42_item": arrow_ipc.write_stream(host["q42_item"], ITEM_SCHEMA)}
    work = work_dir or tempfile.mkdtemp(prefix="auron_q42_c_abi_")
    try:
        (run,) = run_harnesses([(task, resources)], work, device, "q42")
    finally:
        if work_dir is None:
            shutil.rmtree(work, ignore_errors=True)
    if stats is not None:
        add_timers(stats, run.metrics)
        _c_abi_stats(stats, [run])
    brand, rev = [], []
    for hb in run.batches:
        d = hb.to_pydict()
        brand += d["brand"]
        rev += d["rev"]
    return {"brand": np.array(brand, np.int32), "rev": np.array(rev, np.float64)}


def run_q93_c_abi(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                  device="cuda", conf: dict | None = None, host: dict | None = None,
                  work_dir: str | None = None, via: str = "process",
                  stats: dict | None = None) -> dict:
    """The q93-class query from a C host through the port's C ABI: each map
    task (``q93_map_plan`` over an ``ffi_reader``, its partition's host
    batches as an Arrow IPC stream) writes shuffle files; the host commits
    them (``convert/stages.ShuffleManager``) and each reduce task reads them
    through a ``shuffle:q93_ex0`` JSON manifest, the customer dimension as
    IPC. ``via`` "process": every task in its own ``bridge_harness``
    process, the map tasks at once, then the reduce tasks; "library":
    ``libauron_bridge`` loaded into this process with ``ctypes``
    (``bridge/host.CLibrary``), tasks one after another. Returns {k_null,
    rows, matched, s} as ``run_q93_class``; ``stats`` gets ``map_s``,
    ``reduce_s`` and what ``_c_abi_stats`` lists (no per-process figures
    or ``launches`` with ``via="library"``: this process counts them)."""
    from auron_tpu_torch.bridge.host import CLibrary, run_harnesses
    from auron_tpu_torch.columnar import arrow_ipc
    from auron_tpu_torch.convert.stages import ShuffleManager

    host = host if host is not None else host_q93(data, n_map)
    n_map = len(host["fact"])
    stats = stats if stats is not None else {}
    work = work_dir or tempfile.mkdtemp(prefix="auron_q93_c_abi_")
    os.makedirs(work, exist_ok=True)
    part = B.hash_partitioning([col(0)], n_reduce)
    shuffle = ShuffleManager()
    map_tasks, fact, files = [], [], []
    for p in range(n_map):
        files.append((os.path.join(work, f"q93_m{p}.data"),
                      os.path.join(work, f"q93_m{p}.index")))
        w = B.shuffle_writer(q93_map_plan(_ffi_reader), part, *files[-1])
        map_tasks.append(B.task(w, 1, p, conf).SerializeToString())
        fact.append(arrow_ipc.write_stream(host["fact"][p], STORE_SALES_SCHEMA))
    cust = arrow_ipc.write_stream(host["cust"], CUSTOMER_SCHEMA)
    reduce_plan = q93_reduce_plan(B.ipc_reader(Q93_INTER_SCHEMA, "q93_ex0"), _ffi_reader)
    reduce_tasks = [B.task(reduce_plan, 2, r, conf).SerializeToString() for r in range(n_reduce)]
    keys: list[str] = []
    try:
        t0 = time.perf_counter()
        if via == "process":
            runs = run_harnesses([(t, {"q93_fact": f}) for t, f in zip(map_tasks, fact)], work,
                                 device, "map")
            maps = [r.metrics for r in runs]
            t1 = time.perf_counter()
            for p, (d, i) in enumerate(files):  # the host commits the map outputs
                shuffle.register_map_output("q93_ex0", p, d, i)
            manifest = shuffle.manifest("q93_ex0")
            rruns = run_harnesses([(t, {"shuffle:q93_ex0": manifest, "q93_cust": cust})
                                   for t in reduce_tasks], work, device, "reduce")
            answers, reduces = [r.batches for r in rruns], [r.metrics for r in rruns]
            _c_abi_stats(stats, runs + rruns)
        elif via == "library":
            lib = CLibrary(device)
            for p, f in enumerate(fact):
                keys.append(f"q93_fact.{p}")
                lib.put_resource(keys[-1], f)
            maps = [lib.run(t)[1] for t in map_tasks]
            t1 = time.perf_counter()
            for p, (d, i) in enumerate(files):
                shuffle.register_map_output("q93_ex0", p, d, i)
            keys += ["q93_ex0", "q93_cust"]
            lib.put_resource_shuffle("q93_ex0", shuffle.manifest("q93_ex0"))
            lib.put_resource("q93_cust", cust)
            answers, reduces = zip(*(lib.run(t) for t in reduce_tasks))
            for k in keys:
                lib.remove_resource(k)
            keys = []
            stats["resource_bytes"] = stats.get("resource_bytes", 0) + sum(map(len, fact)) + \
                len(cust) + len(shuffle.manifest("q93_ex0"))
        else:
            raise ValueError(f"via must be process or library, not {via!r}")
        t2 = time.perf_counter()
    finally:
        if keys:
            from auron_tpu_torch.bridge import api

            for k in keys:
                api.remove_resource(k)
        if work_dir is None:
            shutil.rmtree(work, ignore_errors=True)
    for m in [*maps, *reduces]:
        add_timers(stats, m)
    stats["shuffle_bytes"] = sum(m["values"]["data_size"] for m in maps)
    stats["map_s"], stats["reduce_s"] = t1 - t0, t2 - t1
    outs = [_host_columns(batches) for batches in answers]
    stats["partition_rows"] = [int(o["rows"].sum()) if o else 0 for o in outs]
    return _q93_by_key(outs)


# ---------------------------------------------------------------------------
# q3-class: the flagship join + shuffle + agg + top-k pipeline
# ---------------------------------------------------------------------------


def ingest_q3(data: TpcdsData, n_map: int, device="cuda", fact=None) -> dict:
    """Device-resident inputs: the fact table in ``n_map`` partitions and
    one batch per dimension."""
    return {"fact": fact if fact is not None else to_batches(data.store_sales, n_map,
                                                              device=device),
            "dd": to_batches(data.date_dim, 1, device=device)[0],
            "item": to_batches(data.item, 1, device=device)[0]}


def q3_map_plan(moy: int = 11, category_id: int = 1, money: bool = False):
    """store_sales JOIN date_dim (d_moy = moy) JOIN item (i_category_id =
    cat), partial sum(price) by (d_year, i_brand_id): the map side of the
    reference's plan (``auron_tpu/models/tpcds.py`` ``run_q3_class``), the
    dimension builds cached per executor. ``money``: the price is
    ``Cast(price AS decimal(7,2))``, TPC-DS's type for it."""
    scan = B.memory_scan(STORE_SALES_SCHEMA, "q3_fact")
    dscan = B.filter_(B.memory_scan(DATE_DIM_SCHEMA, "q3_dd"), [BinaryOp("eq", col(2), lit(moy))])
    iscan = B.filter_(B.memory_scan(ITEM_SCHEMA, "q3_item"),
                      [BinaryOp("eq", col(2), lit(category_id))])
    j1 = B.hash_join(scan, dscan, [col(0)], [col(0)], "inner", build_side="right",
                     cached_build_id="q3_dd_build")
    # fact (5 columns) + date_dim (3): ss_item_sk at 1, price 4, d_year 6
    j2 = B.hash_join(j1, iscan, [col(1)], [col(0)], "inner", build_side="right",
                     cached_build_id="q3_it_build")
    # + item (4): i_brand_id at 9
    price = Cast(col(4), MONEY) if money else col(4)
    proj = B.project(j2, [(col(6), "d_year"), (col(9), "i_brand_id"), (price, "price")])
    return B.hash_agg(proj, [(col(0), "d_year"), (col(1), "i_brand_id")],
                      [("sum", col(2), "s")], "partial")


def q3_reduce_plan(read):
    """The final sum by (d_year, i_brand_id) over ``read`` (an ipc_reader or
    mesh_exchange node)."""
    return B.hash_agg(read, [(col(0), "d_year"), (col(1), "i_brand_id")],
                      [("sum", col(2), "s")], "final")


#: the dimension builds ``q3_map_plan``'s joins cache in the bridge's map
_Q3_BUILDS = ("q3_dd_build", "q3_it_build")


def q3_map_tree(moy: int = 11, category_id: int = 1, money: bool = False):
    """The planner's tree of ``q3_map_plan`` (the joins' projections keep
    (ss_item_sk, price, d_year), then (price, d_year, i_brand_id))."""
    return tree_from_plan(q3_map_plan(moy, category_id, money))


def q3_reduce_tree(read):
    """The planner's tree of ``q3_reduce_plan(read)``."""
    return tree_from_plan(q3_reduce_plan(read))


def _top_k(d_year, brand, s, limit: int) -> dict[str, np.ndarray]:
    """ORDER BY d_year, s DESC LIMIT k (ties by brand), the driver's
    takeOrdered."""
    top = np.lexsort((brand, -s, d_year))[:limit]
    return {"d_year": d_year[top].astype(np.int32), "i_brand_id": brand[top].astype(np.int32),
            "s": s[top]}


def _q3_rows(data: TpcdsData, moy: int, category_id: int):
    """(d_year, i_brand_id, fact row mask) of the q3 join's rows."""
    ss, dd, it = data.store_sales.columns, data.date_dim.columns, data.item.columns
    dm = dd["d_moy"] == moy
    im = it["i_category_id"] == category_id
    drow, dhit = _lookup(dd["d_date_sk"][dm], ss["ss_sold_date_sk"])
    irow, ihit = _lookup(it["i_item_sk"][im], ss["ss_item_sk"])
    hit = dhit & ihit
    year = dd["d_year"][dm][drow[hit]].astype(np.int64)
    brand = it["i_brand_id"][im][irow[hit]].astype(np.int64)
    return year, brand, hit


def run_q3_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                 moy: int = 11, category_id: int = 1, limit: int = 100,
                 work_dir: str | None = None, device="cuda", conf: dict | None = None,
                 ingested: dict | None = None, stats: dict | None = None,
                 money: bool = False, parallel: bool | int = False) -> dict:
    """SELECT d_year, i_brand_id, sum(ss_ext_sales_price) s FROM store_sales
    JOIN date_dim ON ss_sold_date_sk = d_date_sk JOIN item ON ss_item_sk =
    i_item_sk WHERE d_moy = <moy> AND i_category_id = <cat> GROUP BY d_year,
    i_brand_id ORDER BY d_year, s DESC LIMIT <k>, in two stages, every task
    from its ``TaskDefinition`` bytes (``parallel`` as ``run_q93_class``).
    With ``money`` the price is decimal(7,2) and ``s`` the exact
    decimal(17,2) sums as int64 cents."""
    from auron_tpu_torch.bridge import api

    if ingested is None:
        ingested = ingest_q3(data, n_map, device)
    n_map = len(ingested["fact"])
    resources = {"q3_fact": ingested["fact"], "q3_dd": [ingested["dd"]] * n_map,
                 "q3_item": [ingested["item"]] * n_map}
    partial = q3_map_plan(moy, category_id, money)
    try:
        outs = _run_two_stage(partial, tree_from_plan(partial).schema, [0, 1], q3_reduce_plan,
                              resources, n_map, n_reduce, "q3_blocks", work_dir,
                              with_slots(conf, parallel, max(n_map, n_reduce)), device, stats)
    finally:
        for k in _Q3_BUILDS:  # the bridge's map caches them for the run's tasks
            api.remove_resource(k)
    got = _concat(outs, ["d_year", "i_brand_id", "s"],
                  [np.int32, np.int32, np.int64 if money else np.float64])
    return _top_k(got["d_year"], got["i_brand_id"], got["s"], limit)


def _lookup(keys: np.ndarray, probe: np.ndarray):
    """(row of keys matching each probe value, hit) for unique keys."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    pos = np.clip(np.searchsorted(k, probe), 0, max(len(k) - 1, 0))
    hit = (k[pos] == probe) if len(k) else np.zeros(len(probe), bool)
    return order[pos] if len(k) else pos, hit


def q3_class_oracle(data: TpcdsData, moy: int = 11, category_id: int = 1,
                    limit: int = 100) -> dict[str, np.ndarray]:
    ss = data.store_sales.columns
    year, brand, hit = _q3_rows(data, moy, category_id)
    uniq, inv = np.unique(np.stack([year, brand], 1), axis=0, return_inverse=True)
    s = np.bincount(inv.reshape(-1), weights=ss["ss_ext_sales_price"][hit],
                    minlength=len(uniq))
    return _top_k(uniq[:, 0], uniq[:, 1], s, limit)


# ---------------------------------------------------------------------------
# the same queries through the planned-exchange driver (one plan, P logical
# partitions on one device)
# ---------------------------------------------------------------------------


def q93_mesh_tree(n_parts: int = 4):
    """The planner's tree of the q93 plan with a ``mesh_exchange`` hashed on
    k between its map and reduce sides."""
    ex = B.mesh_exchange(q93_map_plan(), B.hash_partitioning([col(0)], n_parts), "q93_ex0")
    return tree_from_plan(q93_reduce_plan(ex))


def q3_mesh_tree(n_parts: int = 4, moy: int = 11, category_id: int = 1):
    """The planner's tree of q3's partial aggregate -> mesh exchange hashed
    on (d_year, i_brand_id) -> final aggregate."""
    ex = B.mesh_exchange(q3_map_plan(moy, category_id),
                         B.hash_partitioning([col(0), col(1)], n_parts), "q3_ex0")
    return tree_from_plan(q3_reduce_plan(ex))


def q3_collect_tree(schema: T.Schema, limit: int = 100):
    """The single-task collect stage of the lowered SQL q3: ORDER BY d_year,
    s DESC, i_brand_id with fetch, then LIMIT, over the gathered output."""
    from auron_tpu_torch.exec.basic import LimitExec, ResourceScanExec
    from auron_tpu_torch.exec.sort_exec import SortExec

    sort = SortExec(ResourceScanExec(schema, "q3_stage"), [col(0), col(2), col(1)],
                    [SortSpec(), SortSpec(asc=False), SortSpec()], fetch=limit)
    return LimitExec(sort, limit)


def _run_mesh(tree, resources: dict, n_parts: int, device, conf, stats: dict | None):
    """One driver run over fresh per-run resources; ``stats`` gets the
    exchange's statistics, stage walls, kernel launches and peak device
    memory."""
    import torch

    from auron_tpu_torch.ops import partition_kernels
    from auron_tpu_torch.parallel.mesh import make_mesh
    from auron_tpu_torch.parallel.mesh_driver import MeshQueryDriver

    mesh = make_mesh(n_parts, device)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = dict(partition_kernels.LAUNCHES)
    driver = MeshQueryDriver(mesh, Configuration(conf or {}))
    outs = driver.run(tree, resources)
    if stats is not None:
        exchanges = [{
            "id": ex.exchange_id, "mode": ex.mode, "routing": ex.rows.tolist(),
            "slot_cap": ex.slot_cap, "est_bytes_per_shard": ex.est_bytes_per_shard,
            "coalesced_groups": ex.coalesced_groups, "skew_tasks": ex.skew_tasks,
            "map_s": driver.walls[f"{ex.exchange_id}.map_s"],
            "exchange_s": driver.walls[f"{ex.exchange_id}.exchange_s"],
        } for ex in driver.stats]
        if len(exchanges) == 1:  # one exchange: its figures at the top level
            stats.update({k: v for k, v in exchanges[0].items() if k != "id"})
        stats.update({
            "exchanges": exchanges,
            "reduce_s": driver.walls["reduce_s"],
            "launches": {k: v - before[k] for k, v in partition_kernels.LAUNCHES.items()},
            "peak_bytes": (torch.cuda.max_memory_allocated()
                           if mesh.device.type == "cuda" else None),
        })
    return outs


def run_q93_mesh(data: TpcdsData | None = None, n_parts: int = 4, device="cuda",
                 conf: dict | None = None, stats: dict | None = None,
                 ingested: dict | None = None) -> dict:
    """The q93-class query through the planned-exchange driver; returns
    {k_null, rows, matched, s} sorted by k_null, as ``run_q93_class``."""
    if ingested is None:
        ingested = ingest_q93(data, n_parts, device)
    resources = {"q93_fact": ingested["fact"], "q93_cust": [ingested["cust"]] * n_parts}
    outs = _run_mesh(q93_mesh_tree(n_parts), resources, n_parts, device, conf, stats)
    return _q93_by_key([collect(o) for o in outs])


def run_q3_mesh(data: TpcdsData | None = None, n_parts: int = 4, device="cuda",
                conf: dict | None = None, stats: dict | None = None, moy: int = 11,
                category_id: int = 1, limit: int = 100, ingested: dict | None = None) -> dict:
    """The q3-class query through the planned-exchange driver, then its
    single-task collect stage; returns {d_year, i_brand_id, s}."""
    from auron_tpu_torch.runtime.task import run_task

    if ingested is None:
        ingested = ingest_q3(data, n_parts, device)
    resources = {"q3_fact": ingested["fact"], "q3_dd": [ingested["dd"]] * n_parts,
                 "q3_item": [ingested["item"]] * n_parts}
    tree = q3_mesh_tree(n_parts, moy, category_id)
    outs = _run_mesh(tree, resources, n_parts, device, conf, stats)
    gathered = [b for part in outs for b in part]
    t0 = time.perf_counter()
    batches, _ = run_task(q3_collect_tree(tree.schema, limit), {"q3_stage": [gathered]},
                          conf=Configuration(conf or {}), device=device)
    out = collect(batches)
    _sync(device)
    if stats is not None:
        stats["collect_s"] = time.perf_counter() - t0
    return {"d_year": out["d_year"].astype(np.int32),
            "i_brand_id": out["i_brand_id"].astype(np.int32), "s": out["s"]}


# ---------------------------------------------------------------------------
# the shuffle-heavy gate classes (perf_gate.py HEAVY): q72, q95, q18, q14,
# q65, q5, each in stages over file shuffles, with numpy oracles
# ---------------------------------------------------------------------------


def _fact_scan(rid: str):
    from auron_tpu_torch.exec.basic import ResourceScanExec

    return ResourceScanExec(STORE_SALES_SCHEMA, rid)


def _aggs(*specs) -> list:
    from auron_tpu_torch.exec.agg_exec import AggExpr

    return [(AggExpr(func, expr), name) for func, expr, name in specs]


def _partial(child, keys: list, aggs: list):
    from auron_tpu_torch.exec.agg_exec import HashAggExec

    return HashAggExec(child, keys, aggs, "partial")


def _final(read, keys: list, aggs: list):
    """The final aggregate of ``_partial(child, keys, aggs)``'s rows (its
    key and aggregate expressions are positional)."""
    from auron_tpu_torch.exec.agg_exec import HashAggExec

    return HashAggExec(read, [(col(i), n) for i, (_, n) in enumerate(keys)], aggs, "final")


def _lex_order(keys: list[np.ndarray]) -> np.ndarray:
    """``np.lexsort`` order of ``keys`` (primary first). Integer keys whose
    ranges fit in 63 bits together pack into one int64 and take one stable
    argsort (none when already sorted)."""
    if keys and len(keys[0]) and all(k.dtype.kind in "biu" for k in keys):
        spans = [(int(k.min()), int(k.max())) for k in keys]
        bits = [max((hi - lo).bit_length(), 1) for lo, hi in spans]
        if sum(bits) <= 63:
            packed = np.zeros(len(keys[0]), np.int64)
            for k, (lo, _), b in zip(keys, spans, bits):
                packed = (packed << b) | (k.astype(np.int64) - lo)
            if (packed[1:] >= packed[:-1]).all():
                return np.arange(len(packed))
            return np.argsort(packed, kind="stable")
    return np.lexsort(tuple(reversed(keys)))


def _sorted_by(got: dict, keys: list[str]) -> dict:
    order = _lex_order([got[k] for k in keys])
    return {k: v[order] for k, v in got.items()}


def _group(keys: np.ndarray):
    """(distinct keys ascending, inverse index) of an integer key vector:
    through a presence table where the key range is at most four times
    the rows (linear), else a sort."""
    if len(keys):
        lo = int(keys.min())
        span = int(keys.max()) - lo + 1
        if span <= max(4 * len(keys), 1 << 16):
            off = keys - lo
            present = np.zeros(span, bool)
            present[off] = True
            return (np.flatnonzero(present) + lo).astype(keys.dtype), np.cumsum(present)[off] - 1
    uniq, inv = np.unique(keys, return_inverse=True)
    return uniq, inv.reshape(-1)


def _shuffle_one(plan, key_cols: list[int], n_map: int, rid: str):
    """A map stage whose plan does not depend on earlier stages."""
    return lambda _readers: (plan, plan.schema, key_cols, n_map, rid)


# ---- q72-class: both facts shuffled on item, sort-merge join, aggregate ----

#: q72's default SMJ input-sort elision (the JAX function's task conf)
Q72_ELIDE_SORTS = "full"


def q72_second_fact_rows(n: int) -> np.ndarray:
    """Row indices of q72's second fact table: ``store_sales.sample(frac=0.5,
    random_state=3)`` of pandas, without pandas."""
    return np.random.RandomState(3).choice(n, size=round(0.5 * n), replace=False)


def q72_second_fact(data: TpcdsData) -> Table:
    ss = data.store_sales
    rows = q72_second_fact_rows(len(ss))
    return Table(ss.schema, {c: v[rows] for c, v in ss.columns.items()},
                 {c: v[rows] for c, v in ss.valid.items()})


def ingest_q72(data: TpcdsData, n_map: int, device="cuda", fact=None) -> dict:
    """Device-resident inputs: both fact tables in ``n_map`` partitions."""
    return {"fact": fact if fact is not None else to_batches(data.store_sales, n_map,
                                                              device=device),
            "fact2": to_batches(q72_second_fact(data), n_map, device=device)}


def _elide_mode(conf: dict | None) -> str:
    from auron_tpu_torch.plan.optimizer import SMJ_ELIDE_SORTS_KEY

    mode = (conf or {}).get(SMJ_ELIDE_SORTS_KEY, Q72_ELIDE_SORTS)
    if mode not in ("build", "full", "off"):
        raise ValueError(f"{SMJ_ELIDE_SORTS_KEY} must be build, full or off, got {mode!r}")
    return mode


def _smj_side(child, keys: list, mode: str, side: str):
    """``child``, or a SortExec on ``keys`` over it unless the elision mode
    drops this side's sort (build: the right side's; full: both)."""
    from auron_tpu_torch.exec.sort_exec import SortExec

    if mode == "full" or (mode == "build" and side == "right"):
        return child
    return SortExec(child, keys, [SortSpec() for _ in keys])


def q72_join_tree(lread, rread, mode: str = Q72_ELIDE_SORTS):
    """Both facts' shuffled rows, each sorted on (item, date) unless
    elided, sort-merge joined on (item, date), then the partial aggregate
    by item: the pruned tree of the JAX q72 reduce plan (join projection
    [item, qty, right price])."""
    from auron_tpu_torch.exec.basic import ProjectExec
    from auron_tpu_torch.exec.joins.smj import SortMergeJoinExec

    keys = [col(1), col(0)]
    smj = SortMergeJoinExec(_smj_side(lread, keys, mode, "left"),
                            _smj_side(rread, keys, mode, "right"), keys, [col(1), col(0)],
                            "inner", projection=[1, 3, 9])
    proj = ProjectExec(smj, [col(0), col(1), col(2)], ["item", "qty", "price"])
    return _partial(proj, [(col(0), "item")], _q72_aggs())


def _q72_aggs() -> list:
    return _aggs(("count_star", None, "cnt"), ("sum", col(1), "qty"), ("avg", col(2), "p_avg"))


def q72_reduce_tree(lread, rread, mode: str = Q72_ELIDE_SORTS):
    return _final(q72_join_tree(lread, rread, mode), [(col(0), "item")], _q72_aggs())


def run_q72_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                  work_dir: str | None = None, device="cuda", conf: dict | None = None,
                  ingested: dict | None = None, stats: dict | None = None,
                  transport: str = "file", parallel: bool | int = False) -> dict:
    """SELECT ss.ss_item_sk item, count(*) cnt, sum(ss.ss_quantity) qty,
    avg(sr.ss_ext_sales_price) p_avg FROM store_sales ss JOIN store_sales2 sr
    ON ss.ss_item_sk = sr.ss_item_sk AND ss.ss_sold_date_sk =
    sr.ss_sold_date_sk GROUP BY item: both sides shuffled on item, each
    reduce task sort-merge joins its co-partitioned slices and aggregates.
    ``conf`` may set ``auron.smj.elide.sorts`` (default full, as the JAX
    function's tasks); ``transport`` and ``parallel`` as ``run_q93_class``.
    Returns {item, cnt, qty, p_avg} sorted by item."""
    if ingested is None:
        ingested = ingest_q72(data, n_map, device)
    mode = _elide_mode(conf)
    n_map = len(ingested["fact"])
    resources = {"q72_l": ingested["fact"], "q72_r": ingested["fact2"]}
    outs = _run_stages(
        [_shuffle_one(_fact_scan("q72_l"), [1], n_map, "q72_lb"),
         _shuffle_one(_fact_scan("q72_r"), [1], n_map, "q72_rb")],
        lambda lr, rr: q72_reduce_tree(lr, rr, mode), resources, n_reduce, "q72",
        work_dir, with_slots(conf, parallel, max(n_map, n_reduce)), device, stats,
        transport=transport)
    got = _concat(outs, ["item", "cnt", "qty", "p_avg"],
                  [np.int64, np.int64, np.int64, np.float64])
    return _sorted_by(got, ["item"])


def q72_class_oracle(data: TpcdsData) -> dict:
    ss, sr = data.store_sales.columns, q72_second_fact(data).columns
    base = int(min(ss["ss_sold_date_sk"].min(initial=0), sr["ss_sold_date_sk"].min(initial=0)))

    def pair_key(t):
        return t["ss_item_sk"] * (1 << 24) + (t["ss_sold_date_sk"] - base)

    rkeys, rinv = _group(pair_key(sr))
    r_cnt = np.bincount(rinv, minlength=len(rkeys))
    r_sum = np.bincount(rinv, weights=sr["ss_ext_sales_price"], minlength=len(rkeys))
    lk = pair_key(ss)
    pos = np.clip(np.searchsorted(rkeys, lk), 0, max(len(rkeys) - 1, 0))
    hit = (rkeys[pos] == lk) if len(rkeys) else np.zeros(len(lk), bool)
    items, inv = _group(ss["ss_item_sk"][hit])
    n = len(items)
    cnt = np.bincount(inv, weights=r_cnt[pos[hit]], minlength=n).astype(np.int64)
    qty = np.bincount(inv, weights=ss["ss_quantity"][hit] * r_cnt[pos[hit]],
                      minlength=n).astype(np.int64)
    p_sum = np.bincount(inv, weights=r_sum[pos[hit]], minlength=n)
    return {"item": items, "cnt": cnt, "qty": qty, "p_avg": p_sum / cnt}


# ---- q95-class: semi joins below the exchanges, anti join above ----------

Q95_BAD_SCHEMA = _schema(("c", T.INT64))


def ingest_q95(data: TpcdsData, n_map: int, device="cuda", fact=None) -> dict:
    return {"fact": fact if fact is not None else to_batches(data.store_sales, n_map,
                                                              device=device),
            "item": to_batches(data.item, 1, device=device)[0]}


def q95_map_trees():
    """(fact rows whose item is in category 1, customers of fact rows whose
    item is in category 2): left semi broadcast joins below the customer
    exchange, as the host engine plans them."""
    from auron_tpu_torch.exec.basic import FilterExec, ProjectExec, ResourceScanExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec

    def category(c: int):
        return FilterExec(ResourceScanExec(ITEM_SCHEMA, "q95_item"),
                          [BinaryOp("eq", col(2), lit(c))])

    semi = BroadcastHashJoinExec(_fact_scan("q95_fact"), category(1), [col(1)], [col(0)],
                                 "left_semi", build_side="right",
                                 cached_build_id="q95_cat1_build")
    bad = ProjectExec(
        BroadcastHashJoinExec(_fact_scan("q95_fact"), category(2), [col(1)], [col(0)],
                              "left_semi", build_side="right",
                              cached_build_id="q95_cat2_build", projection=[2]),
        [col(0)], ["c"])
    return semi, bad


def q95_reduce_tree(read, bad):
    """read LEFT ANTI JOIN bad customers ON customer, counted per customer
    (a NULL customer never matches, so its rows stay)."""
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec

    anti = BroadcastHashJoinExec(read, bad, [col(2)], [col(0)], "left_anti",
                                 build_side="right", projection=[2])
    keys, aggs = [(col(0), "customer")], _aggs(("count_star", None, "cnt"))
    return _final(_partial(anti, keys, aggs), keys, aggs)


def run_q95_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                  work_dir: str | None = None, device="cuda", conf: dict | None = None,
                  ingested: dict | None = None, stats: dict | None = None) -> dict:
    """EXISTS / NOT EXISTS (q95-class): rows of customers who bought an item
    of category 1 and never one of category 2, counted per customer.
    Returns {customer, customer_valid, cnt}, NULL customer last."""
    if ingested is None:
        ingested = ingest_q95(data, n_map, device)
    n_map = len(ingested["fact"])
    resources = {"q95_fact": ingested["fact"],
                 "q95_item": [ingested["item"]] * max(n_map, n_reduce)}
    semi, bad = q95_map_trees()
    outs = _run_stages(
        [_shuffle_one(semi, [2], n_map, "q95_blocks"),
         _shuffle_one(bad, [0], n_map, "q95_bad")],
        q95_reduce_tree, resources, n_reduce, "q95", work_dir, Configuration(conf or {}),
        device, stats, nulls=True)
    got = _concat(outs, ["customer", "customer_valid", "cnt"], [np.int64, bool, np.int64])
    got["customer"] = np.where(got["customer_valid"], got["customer"], 0)
    return _q95_order(got)


def _q95_order(got: dict) -> dict:
    order = np.lexsort((got["customer"], ~got["customer_valid"]))
    return {k: v[order] for k, v in got.items()}


def q95_class_oracle(data: TpcdsData) -> dict:
    ss, it = data.store_sales, data.item.columns
    item, cust = ss.columns["ss_item_sk"], ss.columns["ss_customer_sk"]
    valid = ss.validity("ss_customer_sk")
    cat1 = np.isin(item, it["i_item_sk"][it["i_category_id"] == 1])
    cat2 = np.isin(item, it["i_item_sk"][it["i_category_id"] == 2])
    bad = np.unique(cust[cat2 & valid])
    keep = cat1 & ~(valid & np.isin(cust, bad))
    keys, inv = _group(np.where(valid[keep], cust[keep], -1))
    cnt = np.bincount(inv, minlength=len(keys)).astype(np.int64)
    got = {"customer": np.where(keys == -1, 0, keys), "customer_valid": keys != -1, "cnt": cnt}
    return _q95_order(got)


# ---- q18-class: agg-heavy, two joins, shuffle on two int32 keys ----------


def q18_map_tree():
    """fact JOIN date_dim JOIN item -> (cat, d_year, qty, price) -> partial
    avg(qty), avg(price), sum(price), count(*) by (cat, d_year): the pruned
    tree of the JAX q18 map plan."""
    from auron_tpu_torch.exec.basic import ProjectExec, ResourceScanExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec

    j1 = BroadcastHashJoinExec(_fact_scan("q18_fact"), ResourceScanExec(DATE_DIM_SCHEMA, "q18_dd"),
                               [col(0)], [col(0)], "inner", build_side="right",
                               cached_build_id="q18_dd_b", projection=[1, 3, 4, 6])
    j2 = BroadcastHashJoinExec(j1, ResourceScanExec(ITEM_SCHEMA, "q18_item"), [col(0)],
                               [col(0)], "inner", build_side="right",
                               cached_build_id="q18_it_b", projection=[1, 2, 3, 6])
    proj = ProjectExec(j2, [col(3), col(2), col(0), col(1)], ["cat", "d_year", "qty", "price"])
    return _partial(proj, _Q18_KEYS, _q18_aggs())


_Q18_KEYS = [(col(0), "cat"), (col(1), "d_year")]


def _q18_aggs() -> list:
    return _aggs(("avg", col(2), "q_avg"), ("avg", col(3), "p_avg"), ("sum", col(3), "p_sum"),
                 ("count_star", None, "cnt"))


def run_q18_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                  work_dir: str | None = None, device="cuda", conf: dict | None = None,
                  ingested: dict | None = None, stats: dict | None = None) -> dict:
    """SELECT i_category_id cat, d_year, avg(qty), avg(price), sum(price),
    count(*) FROM fact JOIN date_dim JOIN item GROUP BY cat, d_year, with a
    file shuffle on (cat, d_year) between the partial and final aggregate.
    Returns {cat, d_year, q_avg, p_avg, p_sum, cnt} sorted by (cat, d_year)."""
    if ingested is None:
        ingested = ingest_q3(data, n_map, device)
    n_map = len(ingested["fact"])
    resources = {"q18_fact": ingested["fact"], "q18_dd": [ingested["dd"]] * n_map,
                 "q18_item": [ingested["item"]] * n_map}
    outs = _run_stages([_shuffle_one(q18_map_tree(), [0, 1], n_map, "q18_blocks")],
                       lambda r: _final(r, _Q18_KEYS, _q18_aggs()), resources, n_reduce, "q18",
                       work_dir, Configuration(conf or {}), device, stats)
    got = _concat(outs, ["cat", "d_year", "q_avg", "p_avg", "p_sum", "cnt"],
                  [np.int32, np.int32, np.float64, np.float64, np.float64, np.int64])
    return _sorted_by(got, ["cat", "d_year"])


def q18_class_oracle(data: TpcdsData) -> dict:
    ss, dd, it = data.store_sales.columns, data.date_dim.columns, data.item.columns
    drow, dhit = _lookup(dd["d_date_sk"], ss["ss_sold_date_sk"])
    irow, ihit = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    hit = dhit & ihit
    cat = it["i_category_id"][irow[hit]].astype(np.int64)
    year = dd["d_year"][drow[hit]].astype(np.int64)
    keys, inv = _group(cat * (1 << 32) + year)
    n = len(keys)
    cnt = np.bincount(inv, minlength=n).astype(np.int64)
    qty = np.bincount(inv, weights=ss["ss_quantity"][hit], minlength=n)
    price = np.bincount(inv, weights=ss["ss_ext_sales_price"][hit], minlength=n)
    return {"cat": (keys >> 32).astype(np.int32), "d_year": (keys & 0xFFFFFFFF).astype(np.int32),
            "q_avg": qty / cnt, "p_avg": price / cnt, "p_sum": price, "cnt": cnt}


# ---- q14-class: COUNT(DISTINCT) as two chained shuffles ------------------

_Q14_KEYS1 = [(col(0), "y"), (col(1), "i")]
_Q14_KEYS2 = [(col(0), "y")]


def q14_map_tree():
    """fact JOIN date_dim -> (y, i) -> partial count(*) by (y, i)."""
    from auron_tpu_torch.exec.basic import ProjectExec, ResourceScanExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec

    j = BroadcastHashJoinExec(_fact_scan("q14_fact"), ResourceScanExec(DATE_DIM_SCHEMA, "q14_dd"),
                              [col(0)], [col(0)], "inner", build_side="right",
                              projection=[1, 6])
    proj = ProjectExec(j, [col(1), col(0)], ["y", "i"])
    return _partial(proj, _Q14_KEYS1, _aggs(("count_star", None, "c")))


def q14_regroup_tree(read1):
    """final count by (y, i), then partial count of its rows by y."""
    f1 = _final(read1, _Q14_KEYS1, _aggs(("count_star", None, "c")))
    return _partial(f1, _Q14_KEYS2, _aggs(("count_star", None, "d_items")))


def run_q14_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                  work_dir: str | None = None, device="cuda", conf: dict | None = None,
                  ingested: dict | None = None, stats: dict | None = None) -> dict:
    """COUNT(DISTINCT item) per year, Spark's distinct-aggregate rewrite: a
    group-by on (year, item) across one shuffle, regrouped by year across
    a second (its map tasks are the first's reduce partitions). Returns
    {y, d_items} sorted by y."""
    if ingested is None:
        ingested = ingest_q3(data, n_map, device)
    n_map = len(ingested["fact"])
    resources = {"q14_fact": ingested["fact"], "q14_dd": [ingested["dd"]] * max(n_map, n_reduce)}
    def regroup(readers):
        plan = q14_regroup_tree(readers[0])
        return plan, plan.schema, [0], n_reduce, "q14_ex1"

    outs = _run_stages(
        [_shuffle_one(q14_map_tree(), [0, 1], n_map, "q14_ex0"), regroup],
        lambda _r1, r2: _final(r2, _Q14_KEYS2, _aggs(("count_star", None, "d_items"))),
        resources, n_reduce, "q14", work_dir, Configuration(conf or {}), device, stats)
    got = _concat(outs, ["y", "d_items"], [np.int32, np.int64])
    return _sorted_by(got, ["y"])


def q14_class_oracle(data: TpcdsData) -> dict:
    ss, dd = data.store_sales.columns, data.date_dim.columns
    drow, dhit = _lookup(dd["d_date_sk"], ss["ss_sold_date_sk"])
    year = dd["d_year"][drow[dhit]].astype(np.int64)
    pairs = np.unique(year * (1 << 32) + ss["ss_item_sk"][dhit])
    y, d_items = np.unique(pairs >> 32, return_counts=True)
    return {"y": y.astype(np.int32), "d_items": d_items.astype(np.int64)}


# ---- q65-class: two aggregated subqueries over two shuffles, joined ------


def q65_map_trees():
    """(partial avg(price) by item, partial max(price) by item)."""
    keys = [(col(1), "i")]
    return (_partial(_fact_scan("q65_fact"), keys, _aggs(("avg", col(4), "a"))),
            _partial(_fact_scan("q65_fact"), keys, _aggs(("max", col(4), "m"))))


def q65_reduce_tree(read_a, read_b):
    """final avg JOIN final max ON item, WHERE m > 2 a."""
    from auron_tpu_torch.exec.basic import FilterExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec

    keys = [(col(0), "i")]
    j = BroadcastHashJoinExec(_final(read_a, keys, _aggs(("avg", col(4), "a"))),
                              _final(read_b, keys, _aggs(("max", col(4), "m"))),
                              [col(0)], [col(0)], "inner", build_side="right")
    return FilterExec(j, [BinaryOp("gt", col(3), BinaryOp("mul", col(1), lit(2.0)))])


def run_q65_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                  work_dir: str | None = None, device="cuda", conf: dict | None = None,
                  ingested: dict | None = None, stats: dict | None = None) -> dict:
    """Items whose max price exceeds twice their average: per-item avg and
    max arrive over two separate shuffles into one join stage. Returns
    {i, a, m} sorted by i."""
    if ingested is None:
        ingested = {"fact": to_batches(data.store_sales, n_map, device=device)}
    n_map = len(ingested["fact"])
    resources = {"q65_fact": ingested["fact"]}
    pa_avg, pa_max = q65_map_trees()
    outs = _run_stages(
        [_shuffle_one(pa_avg, [0], n_map, "q65_exA"), _shuffle_one(pa_max, [0], n_map, "q65_exB")],
        q65_reduce_tree, resources, n_reduce, "q65", work_dir, Configuration(conf or {}), device,
        stats)
    got = _concat(outs, ["i", "a", "m"], [np.int64, np.float64, np.float64])
    return _sorted_by(got, ["i"])


def q65_class_oracle(data: TpcdsData) -> dict:
    ss = data.store_sales.columns
    items, inv = _group(ss["ss_item_sk"])
    price = ss["ss_ext_sales_price"]
    a = (np.bincount(inv, weights=price, minlength=len(items))
         / np.bincount(inv, minlength=len(items)))
    m = np.full(len(items), -np.inf)
    np.maximum.at(m, inv, price)
    keep = m > 2.0 * a
    return {"i": items[keep], "a": a[keep], "m": m[keep]}


# ---- q5-class: UNION of two separately shuffled streams, re-aggregated ---

_Q5_KEYS = [(col(1), "i")]


def _q5_aggs() -> list:
    return _aggs(("count_star", None, "c"), ("sum", col(4), "s"))


def q5_map_trees():
    """(partial count, sum(price) by item of the cheap rows, the same of
    the others): the partial aggregates sit below the exchanges."""
    from auron_tpu_torch.exec.basic import FilterExec

    cheap = FilterExec(_fact_scan("q5_fact"), [BinaryOp("lteq", col(4), lit(50.0))])
    pricey = FilterExec(_fact_scan("q5_fact"), [BinaryOp("gt", col(4), lit(50.0))])
    return _partial(cheap, _Q5_KEYS, _q5_aggs()), _partial(pricey, _Q5_KEYS, _q5_aggs())


def q5_reduce_tree(read_a, read_b):
    from auron_tpu_torch.exec.basic import UnionExec

    return _final(UnionExec([read_a, read_b]), _Q5_KEYS, _q5_aggs())


def run_q5_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                 work_dir: str | None = None, device="cuda", conf: dict | None = None,
                 ingested: dict | None = None, stats: dict | None = None) -> dict:
    """UNION ALL of cheap and expensive sales, each partially aggregated by
    item and shuffled through its own exchange, final-aggregated together.
    Returns {i, c, s} sorted by i."""
    if ingested is None:
        ingested = {"fact": to_batches(data.store_sales, n_map, device=device)}
    n_map = len(ingested["fact"])
    resources = {"q5_fact": ingested["fact"]}
    p_a, p_b = q5_map_trees()
    outs = _run_stages(
        [_shuffle_one(p_a, [0], n_map, "q5_exA"), _shuffle_one(p_b, [0], n_map, "q5_exB")],
        q5_reduce_tree, resources, n_reduce, "q5", work_dir, Configuration(conf or {}), device,
        stats)
    got = _concat(outs, ["i", "c", "s"], [np.int64, np.int64, np.float64])
    return _sorted_by(got, ["i"])


def q5_class_oracle(data: TpcdsData) -> dict:
    ss = data.store_sales.columns
    items, inv = _group(ss["ss_item_sk"])
    return {"i": items, "c": np.bincount(inv, minlength=len(items)).astype(np.int64),
            "s": np.bincount(inv, weights=ss["ss_ext_sales_price"], minlength=len(items))}


# ---------------------------------------------------------------------------
# sort-merge join stages through the planned-exchange driver
# ---------------------------------------------------------------------------


def _exchange(child, key_cols: list[int], n_parts: int, ex_id: str):
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.parallel.mesh_driver import MeshExchangeExec

    return MeshExchangeExec(child, HashPartitioning([col(c) for c in key_cols], n_parts), ex_id)


def q72_mesh_tree(n_parts: int = 4, mode: str = Q72_ELIDE_SORTS):
    """q72 as one plan: both facts through a mesh exchange on item into the
    SMJ stage, its partial aggregate through a third exchange on item, then
    the final aggregate."""
    join = q72_join_tree(_exchange(_fact_scan("q72_l"), [1], n_parts, "q72_ex_l"),
                         _exchange(_fact_scan("q72_r"), [1], n_parts, "q72_ex_r"), mode)
    return _final(_exchange(join, [0], n_parts, "q72_ex2"), [(col(0), "item")], _q72_aggs())


def run_q72_mesh(data: TpcdsData | None = None, n_parts: int = 4, device="cuda",
                 conf: dict | None = None, stats: dict | None = None,
                 ingested: dict | None = None) -> dict:
    """The q72-class query through the planned-exchange driver; returns
    {item, cnt, qty, p_avg} sorted by item, as ``run_q72_class``."""
    if ingested is None:
        ingested = ingest_q72(data, n_parts, device)
    resources = {"q72_l": ingested["fact"], "q72_r": ingested["fact2"]}
    outs = _run_mesh(q72_mesh_tree(n_parts, _elide_mode(conf)), resources, n_parts, device,
                     conf, stats)
    got = _concat([collect(o) for o in outs], ["item", "cnt", "qty", "p_avg"],
                  [np.int64, np.int64, np.int64, np.float64])
    return _sorted_by(got, ["item"])


SKEW_FACT_SCHEMA = _schema(("k", T.INT64), ("v", T.INT64))
SKEW_DIM_SCHEMA = _schema(("k2", T.INT64), ("w", T.INT64))
#: the skew plan's AQE settings: keep the full width (no coalescing),
#: split a partition past twice the median
SKEW_CONF = {"exchange.mode": "file", "exchange.coalesce.target.bytes": 1,
             "exchange.skew.join.factor": 2.0, "exchange.skew.join.min.bytes": 1}


def skew_data(n: int = 30000, hot_frac: float = 0.7) -> tuple[Table, Table]:
    """(fact, dim): ``n`` fact rows over 60 keys with ``hot_frac`` of them on
    key 7 (one hot partition), and a 60-row dimension."""
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 60, n)
    keys[: int(n * hot_frac)] = 7
    fact = Table(SKEW_FACT_SCHEMA, {"k": keys.astype(np.int64),
                                    "v": rng.integers(0, 5, n).astype(np.int64)}, {})
    dim = Table(SKEW_DIM_SCHEMA, {"k2": np.arange(60, dtype=np.int64),
                                  "w": rng.integers(1, 10, 60).astype(np.int64)}, {})
    return fact, dim


def skew_join_tree(n_parts: int = 4):
    """fact JOIN dim over two planned exchanges and sorts on the key, the
    partial count(*), sum(w) by key through a third exchange, then the
    final aggregate: the join stage is skew-splittable."""
    from auron_tpu_torch.exec.basic import ResourceScanExec
    from auron_tpu_torch.exec.joins.smj import SortMergeJoinExec
    from auron_tpu_torch.exec.sort_exec import SortExec

    def side(schema, rid, ex_id):
        ex = _exchange(ResourceScanExec(schema, rid), [0], n_parts, ex_id)
        return SortExec(ex, [col(0)], [SortSpec()])

    j = SortMergeJoinExec(side(SKEW_FACT_SCHEMA, "skew_l", "skew_ex_l"),
                          side(SKEW_DIM_SCHEMA, "skew_r", "skew_ex_r"), [col(0)], [col(0)],
                          "inner", projection=[0, 3])
    keys = [(col(0), "k")]
    aggs = _aggs(("count_star", None, "c"), ("sum", col(1), "w"))
    return _final(_exchange(_partial(j, keys, aggs), [0], n_parts, "skew_ex2"), keys, aggs)


def run_skew_join(fact: Table | None = None, dim: Table | None = None, n_parts: int = 4,
                  device="cuda", conf: dict | None = None, stats: dict | None = None,
                  ingested: dict | None = None) -> dict:
    """The skew plan through the planned-exchange driver under ``SKEW_CONF``
    (``conf`` entries override it); returns {k, c, w} sorted by k."""
    if ingested is None:
        per = max((len(fact) + n_parts - 1) // n_parts, 1)
        ingested = {"skew_l": to_batches(fact, n_parts, per, device),
                    "skew_r": to_batches(dim, n_parts, per, device)}
    outs = _run_mesh(skew_join_tree(n_parts), dict(ingested), n_parts, device,
                     {**SKEW_CONF, **(conf or {})}, stats)
    got = _concat([collect(o) for o in outs], ["k", "c", "w"], [np.int64, np.int64, np.int64])
    return _sorted_by(got, ["k"])


def skew_join_oracle(fact: Table, dim: Table) -> dict:
    k = fact.columns["k"]
    row, hit = _lookup(dim.columns["k2"], k)
    keys, inv = _group(k[hit])
    return {"k": keys, "c": np.bincount(inv, minlength=len(keys)).astype(np.int64),
            "w": np.bincount(inv, weights=dim.columns["w"][row[hit]],
                             minlength=len(keys)).astype(np.int64)}


# ---------------------------------------------------------------------------
# the expression-tail and join-tail classes: CASE, IN, LIKE, residual join
# conditions, SMJ chains, CTE reuse, set operations — each through the task
# runtime with the JAX function's partition and task counts, and a numpy
# oracle
# ---------------------------------------------------------------------------

#: the classes of this section, in the order chip_smoke.py runs them
TAIL_CLASSES = ("q17", "q16", "q41", "q48", "q99", "q37", "q6", "q85", "q1", "q88", "q14b",
                "q2", "q4", "q11", "q15", "q31", "q34", "q38", "q54", "q58", "q79", "q22")


def _scan(schema: T.Schema, rid: str):
    from auron_tpu_torch.exec.basic import ResourceScanExec

    return ResourceScanExec(schema, rid)


def _bhj(left, right, lkeys: list, rkeys: list, join_type: str = "inner", **kw):
    """A broadcast hash join with the build on the right."""
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec

    return BroadcastHashJoinExec(left, right, lkeys, rkeys, join_type, build_side="right", **kw)


def _filter(child, *predicates):
    from auron_tpu_torch.exec.basic import FilterExec

    return FilterExec(child, list(predicates))


def _project(child, *named):
    from auron_tpu_torch.exec.basic import ProjectExec

    return ProjectExec(child, [e for e, _ in named], [n for _, n in named])


def _agg2(child, keys: list, aggs: list, final_aggs: list | None = None):
    """Partial then final aggregate in one task (the JAX functions' hash_agg
    pair); ``final_aggs`` names the final side where it differs (a final
    ``count`` over a partial ``count_star``)."""
    return _final(_partial(child, keys, aggs), keys, final_aggs or aggs)


def _tasks(plan, resources: dict, n_tasks: int, conf, device, stats, stage_id: int = 0):
    """Run partitions 0..n_tasks-1 of ``plan``: every task's output batches
    in order; ``stats`` gets the metric trees' host timers and the memory
    manager's counters (``memory_scope``)."""
    from auron_tpu_torch.runtime.task import run_task

    out = []
    conf = conf if isinstance(conf, Configuration) else Configuration(conf or {})
    with memory_scope(conf, stats):
        for batches, metrics in run_tasks_parallel(
                [(lambda p=p: run_task(plan, resources, stage_id, p, conf, device))
                 for p in range(n_tasks)], device, _slots(conf)):
            out += batches
            if stats is not None:
                add_timers(stats, metrics)
    return out


def _answer(batches, names: list[str], dtypes: list) -> dict:
    return _concat([collect(batches)], names, dtypes)


def _tail_inputs(data, n: int, device, ingested) -> dict:
    """(fact in ``n`` partitions, dims broadcast to each) as resources."""
    ing = ingested if ingested is not None else ingest_q3(data, n, device)
    k = len(ing["fact"])
    return {"fact": ing["fact"], "dd": [ing["dd"]] * k, "item": [ing["item"]] * k}


def _materialize(plan, resources: dict, rid: str, conf, device, stats, n: int = 1) -> T.Schema:
    """Run ``plan`` (one task) and register its output batches as the
    ``n``-partition resource ``rid`` (a CTE or a broadcast subquery result,
    collected once and read by every later task); returns its schema."""
    resources[rid] = [_tasks(plan, resources, 1, conf, device, stats)] * n
    return plan.schema


def _fact():
    return _fact_scan("fact")


def _dd():
    return _scan(DATE_DIM_SCHEMA, "dd")


def _item():
    return _scan(ITEM_SCHEMA, "item")


def _year_is(y: int):
    return BinaryOp("eq", col(1), lit(y))


def _by(keys: np.ndarray, weights: np.ndarray | None = None):
    """(distinct int64 keys ascending, row count per key, weight sum per key)."""
    uniq, inv = _group(keys.astype(np.int64))
    n = np.bincount(inv, minlength=len(uniq)).astype(np.int64)
    s = None if weights is None else np.bincount(inv, weights=weights, minlength=len(uniq))
    return uniq, n, s


# ---- q17-class: three-way sort-merge join chain --------------------------


def q17_tree(mode: str = "build"):
    """fact SMJ item SMJ date_dim by (d_year, i_category), the pruned tree
    of the JAX plan: the probe sides sorted (the fact by item, the first
    join's output by date), the build sides' sorts elided under
    ``auron.smj.elide.sorts`` = build (the task default)."""
    from auron_tpu_torch.exec.joins.smj import SortMergeJoinExec

    fact = _project(_fact(), (col(0), "d"), (col(1), "i"), (col(4), "p"))
    item = _project(_item(), (col(0), "i_item_sk"), (col(3), "i_category"))
    dd = _project(_dd(), (col(0), "d_date_sk"), (col(1), "d_year"))
    j1 = SortMergeJoinExec(_smj_side(fact, [col(1)], mode, "left"),
                           _smj_side(item, [col(0)], mode, "right"), [col(1)], [col(0)],
                           "inner", projection=[0, 2, 4])
    j2 = SortMergeJoinExec(_smj_side(j1, [col(0)], mode, "left"),
                           _smj_side(dd, [col(0)], mode, "right"), [col(0)], [col(0)],
                           "inner", projection=[1, 2, 4])
    pr = _project(j2, (col(2), "y"), (col(1), "cat"), (col(0), "p"))
    return _agg2(pr, [(col(0), "y"), (col(1), "cat")], _aggs(("sum", col(2), "s")))


def run_q17_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """SELECT d_year y, i_category cat, sum(price) s FROM fact SMJ item SMJ
    date_dim GROUP BY y, cat (one task): {y, cat, s} sorted by (y, cat)."""
    from auron_tpu_torch.plan.optimizer import SMJ_ELIDE_SORTS_KEY

    res = _tail_inputs(data, 1, device, ingested)
    mode = (conf or {}).get(SMJ_ELIDE_SORTS_KEY, "build")
    out = _answer(_tasks(q17_tree(mode), res, 1, conf, device, stats), ["y", "cat", "s"],
                  [np.int32, object, np.float64])
    return _sorted_by(out, ["y", "cat"])


def q17_class_oracle(data: TpcdsData) -> dict:
    ss, dd, it = data.store_sales.columns, data.date_dim.columns, data.item.columns
    irow, ihit = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    drow, dhit = _lookup(dd["d_date_sk"], ss["ss_sold_date_sk"])
    hit = ihit & dhit
    cats, cat_code = np.unique(it["i_category"].astype(str), return_inverse=True)
    year = dd["d_year"][drow[hit]].astype(np.int64)
    code = cat_code.reshape(-1)[irow[hit]]
    keys, _, s = _by(year * 64 + code, ss["ss_ext_sales_price"][hit])
    return {"y": (keys // 64).astype(np.int32), "cat": cats[keys % 64].astype(object), "s": s}


# ---- q16-class: anti join after a shuffle on customer --------------------


def run_q16_class(data: TpcdsData | None = None, n_map: int = 2, n_reduce: int = 2,
                  work_dir: str | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Rows of customers with no purchase above 400 anywhere: the fact
    file-shuffled on the nullable INT64 customer (K1 on a card), then in
    each reduce task the shuffled rows LEFT ANTI JOIN the customers of
    their own high-value rows, counted. {c} (one row)."""
    from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec

    ing = ingested if ingested is not None else ingest_q3(data, n_map, device)
    resources = {"fact": ing["fact"]}

    def reduce_tree(read):
        high = _project(_filter(IpcReaderExec(read.schema, read.resource_id),
                                BinaryOp("gt", col(4), lit(400.0))), (col(2), "hc"))
        anti = _bhj(read, high, [col(2)], [col(0)], "left_anti")
        return _agg2(anti, [], _aggs(("count_star", None, "c")))

    outs = _run_stages([_shuffle_one(_fact(), [2], len(ing["fact"]), "q16_ex0")], reduce_tree,
                       resources, n_reduce, "q16", work_dir, Configuration(conf or {}), device,
                       stats)
    c = _concat(outs, ["c"], [np.int64])["c"]
    return {"c": np.array([c.sum()], dtype=np.int64)}


def q16_class_oracle(data: TpcdsData) -> dict:
    ss = data.store_sales
    cust, valid = ss.columns["ss_customer_sk"], ss.validity("ss_customer_sk")
    bad = np.unique(cust[valid & (ss.columns["ss_ext_sales_price"] > 400.0)])
    keep = ~(valid & np.isin(cust, bad))
    return {"c": np.array([keep.sum()], dtype=np.int64)}


# ---- q41-class: LIKE over a dictionary string, then DISTINCT -------------


def run_q41_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """SELECT DISTINCT i_category cat FROM item WHERE i_category LIKE '%o%':
    {cat} sorted."""
    res = _tail_inputs(data, 1, device, ingested)
    liked = _filter(_item(), Like(col(3), "%o%"))
    plan = _agg2(liked, [(col(3), "cat")], [])
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["cat"], [object])
    return _sorted_by(out, ["cat"])


def q41_class_oracle(data: TpcdsData) -> dict:
    cats = sorted({c for c in data.item.columns["i_category"] if "o" in c})
    return {"cat": np.array(cats, dtype=object)}


# ---- q48-class: CASE inside an aggregate --------------------------------


def run_q48_class(data: TpcdsData | None = None, n_map: int = 2, device="cuda",
                  conf: dict | None = None, stats: dict | None = None,
                  ingested: dict | None = None) -> dict:
    """sum(CASE WHEN quantity < 25 THEN price ELSE 0 END), sum(price) per
    year over a broadcast date join, ``n_map`` tasks merged on the driver:
    {y, cheap_s, all_s} sorted by y."""
    res = _tail_inputs(data, n_map, device, ingested)
    j = _bhj(_fact(), _dd(), [col(0)], [col(0)])
    cheap = Case(((BinaryOp("lt", col(3), lit(25)), col(4)),), lit(0.0))
    pr = _project(j, (col(6), "y"), (cheap, "cheap"), (col(4), "price"))
    plan = _agg2(pr, [(col(0), "y")], _aggs(("sum", col(1), "cheap_s"), ("sum", col(2), "all_s")))
    out = _answer(_tasks(plan, res, len(res["fact"]), conf, device, stats),
                  ["y", "cheap_s", "all_s"], [np.int32, np.float64, np.float64])
    y, inv = _group(out["y"])
    return {"y": y.astype(np.int32),
            "cheap_s": np.bincount(inv, weights=out["cheap_s"], minlength=len(y)),
            "all_s": np.bincount(inv, weights=out["all_s"], minlength=len(y))}


def _with_dates(data: TpcdsData):
    """(fact columns, the date row of each fact row, hit)."""
    ss, dd = data.store_sales.columns, data.date_dim.columns
    drow, dhit = _lookup(dd["d_date_sk"], ss["ss_sold_date_sk"])
    return ss, drow, dhit


def q48_class_oracle(data: TpcdsData) -> dict:
    ss, drow, hit = _with_dates(data)
    price = ss["ss_ext_sales_price"][hit]
    cheap = np.where(ss["ss_quantity"][hit] < 25, price, 0.0)
    y, _, all_s = _by(data.date_dim.columns["d_year"][drow[hit]], price)
    _, _, cheap_s = _by(data.date_dim.columns["d_year"][drow[hit]], cheap)
    return {"y": y.astype(np.int32), "cheap_s": cheap_s, "all_s": all_s}


# ---- q99-class: multi-branch CASE banding -------------------------------


def run_q99_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """count(*) per (year, price band), the band a four-way CASE: {y, band,
    n} sorted by (y, band)."""
    res = _tail_inputs(data, 1, device, ingested)
    j = _bhj(_fact(), _dd(), [col(0)], [col(0)])
    band = Case(((BinaryOp("lt", col(4), lit(20.0)), lit(0)), (BinaryOp("lt", col(4), lit(60.0)), lit(1)),
                 (BinaryOp("lt", col(4), lit(120.0)), lit(2))), lit(3))
    pr = _project(j, (col(6), "y"), (band, "band"))
    plan = _agg2(pr, [(col(0), "y"), (col(1), "band")], _aggs(("count_star", None, "n")),
                 _aggs(("count", col(2), "n")))
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["y", "band", "n"],
                  [np.int32, np.int32, np.int64])
    return _sorted_by(out, ["y", "band"])


def q99_class_oracle(data: TpcdsData) -> dict:
    ss, drow, hit = _with_dates(data)
    p = ss["ss_ext_sales_price"][hit]
    band = np.where(p < 20.0, 0, np.where(p < 60.0, 1, np.where(p < 120.0, 2, 3)))
    year = data.date_dim.columns["d_year"][drow[hit]].astype(np.int64)
    keys, n, _ = _by(year * 4 + band)
    return {"y": (keys // 4).astype(np.int32), "band": (keys % 4).astype(np.int32), "n": n}


# ---- q37-class: IN list, then a semi join --------------------------------


def run_q37_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """count(*), sum(price) of sales whose item's category IN (1, 2, 3): {c, s}."""
    res = _tail_inputs(data, 1, device, ingested)
    good = _filter(_item(), In(col(2), tuple(Literal(v, T.INT32) for v in (1, 2, 3))))
    semi = _bhj(_fact(), good, [col(1)], [col(0)], "left_semi")
    plan = _agg2(semi, [], _aggs(("count_star", None, "c"), ("sum", col(4), "s")))
    return _answer(_tasks(plan, res, 1, conf, device, stats), ["c", "s"], [np.int64, np.float64])


def q37_class_oracle(data: TpcdsData) -> dict:
    it, ss = data.item.columns, data.store_sales.columns
    keep = np.isin(ss["ss_item_sk"], it["i_item_sk"][np.isin(it["i_category_id"], (1, 2, 3))])
    return {"c": np.array([keep.sum()], dtype=np.int64),
            "s": np.array([ss["ss_ext_sales_price"][keep].sum()])}


# ---- q6-class: a computed aggregate broadcast into a conditional join ----


def run_q6_class(data: TpcdsData | None = None, n_partitions: int = 2, device="cuda",
                 conf: dict | None = None, stats: dict | None = None,
                 ingested: dict | None = None) -> dict:
    """count(*) per year of sales priced above 1.2x their category's
    average: stage A computes avg(price) by category (``n_partitions``
    partial tasks, one final task), collected and broadcast into stage B's
    join, whose residual condition is price > 1.2 * cat_avg. Cached builds
    as in the JAX function. {d_year, cnt} sorted by d_year."""
    res = _tail_inputs(data, n_partitions, device, ingested)
    n = len(res["fact"])
    pr = _project(_bhj(_fact(), _item(), [col(1)], [col(0)], cached_build_id="q6_itA_b"),
                  (col(7), "cat"), (col(4), "price"))
    keys, avg = [(col(0), "cat")], _aggs(("avg", col(1), "cat_avg"))
    part = _partial(pr, keys, avg)
    res["q6_inter"] = [_tasks(part, res, n, conf, device, stats)]
    ca = _materialize(_final(_scan(part.schema, "q6_inter"), keys, avg), res, "q6_catavg", conf,
                      device, stats, n)
    j1 = _bhj(_fact(), _dd(), [col(0)], [col(0)], cached_build_id="q6_dd_b")
    j2 = _bhj(j1, _item(), [col(1)], [col(0)], cached_build_id="q6_it_b")
    # fact(5) + date(3) + item(5): price 4, d_year 6, i_category_id 10, cat_avg 14
    j3 = _bhj(j2, _scan(ca, "q6_catavg"), [col(10)], [col(0)],
              condition=BinaryOp("gt", col(4), BinaryOp("mul", lit(1.2), col(14))),
              cached_build_id="q6_ca_b")
    plan = _agg2(_project(j3, (col(6), "d_year")), [(col(0), "d_year")],
                 _aggs(("count_star", None, "cnt")))
    out = _answer(_tasks(plan, res, n, conf, device, stats), ["d_year", "cnt"],
                  [np.int32, np.int64])
    y, inv = _group(out["d_year"])
    return {"d_year": y.astype(np.int32),
            "cnt": np.bincount(inv, weights=out["cnt"], minlength=len(y)).astype(np.int64)}


def _category_avg(ss: dict, it: dict):
    """(category id of each fact row, hit, per-row average price of its category)."""
    irow, ihit = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    cat = it["i_category_id"][irow].astype(np.int64)
    cats, n, s = _by(cat[ihit], ss["ss_ext_sales_price"][ihit])
    avg = np.zeros(int(cats.max(initial=0)) + 1)
    avg[cats] = s / n
    return cat, ihit, avg[np.where(ihit, cat, 0)]


def q6_class_oracle(data: TpcdsData) -> dict:
    ss, drow, dhit = _with_dates(data)
    cat, ihit, cat_avg = _category_avg(ss, data.item.columns)
    keep = dhit & ihit & (ss["ss_ext_sales_price"] > 1.2 * cat_avg)
    y, n, _ = _by(data.date_dim.columns["d_year"][drow[keep]])
    return {"d_year": y.astype(np.int32), "cnt": n}


# ---- q85-class: a residual non-equi condition with a cast ----------------


def run_q85_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """fact JOIN item ON item_sk AND price > CAST(quantity AS DOUBLE) * 1.5,
    counted per category id: {cat, n} sorted by cat."""
    res = _tail_inputs(data, 1, device, ingested)
    cond = BinaryOp("gt", col(4), BinaryOp("mul", Cast(col(3), T.FLOAT64), lit(1.5)))
    j = _bhj(_fact(), _item(), [col(1)], [col(0)], condition=cond)
    plan = _agg2(j, [(col(7), "cat")], _aggs(("count_star", None, "n")),
                 _aggs(("count", col(8), "n")))
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["cat", "n"], [np.int32, np.int64])
    return _sorted_by(out, ["cat"])


def q85_class_oracle(data: TpcdsData) -> dict:
    ss, it = data.store_sales.columns, data.item.columns
    irow, hit = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    keep = hit & (ss["ss_ext_sales_price"] > ss["ss_quantity"] * 1.5)
    cat, n, _ = _by(it["i_category_id"][irow[keep]])
    return {"cat": cat.astype(np.int32), "n": n}


# ---- q1-class: a filtered broadcast join, global aggregate ---------------

_Q1_AGGS = (("count_star", None, "cnt"), ("sum", col(0), "total"), ("avg", col(0), "mean"))


def run_q1_class(data: TpcdsData | None = None, n_partitions: int = 4, year: int = 2000,
                 device="cuda", conf: dict | None = None, stats: dict | None = None,
                 ingested: dict | None = None) -> dict:
    """count(*), sum(price), avg(price) of the sales of one year:
    ``n_partitions`` partial tasks, their states merged by one final task.
    {cnt, total, mean} (one row)."""
    res = _tail_inputs(data, n_partitions, device, ingested)
    j = _bhj(_fact(), _filter(_dd(), _year_is(year)), [col(0)], [col(0)],
             cached_build_id="q1_dd_build")
    part = _partial(_project(j, (col(4), "price")), [], _aggs(*_Q1_AGGS))
    res["q1_inter"] = [_tasks(part, res, len(res["fact"]), conf, device, stats)]
    plan = _final(_scan(part.schema, "q1_inter"), [], _aggs(*_Q1_AGGS))
    return _answer(_tasks(plan, res, 1, conf, device, stats), ["cnt", "total", "mean"],
                   [np.int64, np.float64, np.float64])


def q1_class_oracle(data: TpcdsData, year: int = 2000) -> dict:
    ss, drow, hit = _with_dates(data)
    keep = hit & (data.date_dim.columns["d_year"][drow] == year)
    p = ss["ss_ext_sales_price"][keep]
    return {"cnt": np.array([len(p)], dtype=np.int64), "total": np.array([p.sum()]),
            "mean": np.array([p.mean() if len(p) else np.nan])}


# ---- q88-class: UNION of filtered scans ----------------------------------

Q88_BANDS = ((0, 20), (20, 60), (60, 100))


def run_q88_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """count(*), sum(price) per quantity band [0, 20), [20, 60), [60, 100),
    a UNION ALL of three filtered scans: {band, c, s} sorted by band."""
    from auron_tpu_torch.exec.basic import UnionExec

    res = _tail_inputs(data, 1, device, ingested)
    branches = [_project(_filter(_fact(), BinaryOp("gteq", col(3), lit(lo)),
                                 BinaryOp("lt", col(3), lit(hi))), (lit(bi), "band"), (col(4), "price"))
                for bi, (lo, hi) in enumerate(Q88_BANDS)]
    plan = _agg2(UnionExec(branches), [(col(0), "band")],
                 _aggs(("count_star", None, "c"), ("sum", col(1), "s")))
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["band", "c", "s"],
                  [np.int32, np.int64, np.float64])
    return _sorted_by(out, ["band"])



def q88_class_oracle(data: TpcdsData) -> dict:
    ss = data.store_sales.columns
    q, p = ss["ss_quantity"], ss["ss_ext_sales_price"]
    keep = [(q >= lo) & (q < hi) for lo, hi in Q88_BANDS]
    return {"band": np.arange(3, dtype=np.int32),
            "c": np.array([k.sum() for k in keep], dtype=np.int64),
            "s": np.array([p[k].sum() for k in keep])}


# ---- q14b-class: INTERSECT / EXCEPT as semi and anti joins ---------------


def run_q14b_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                   stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Items sold in 1998 INTERSECT items sold in 1999 EXCEPT items sold in
    2000 (distinct sets through left-semi and left-anti joins), counted with
    their min and max: {c, lo, lo_valid, hi, hi_valid} (min and max are NULL
    when no item is left)."""
    res = _tail_inputs(data, 1, device, ingested)

    def distinct_items(year: int):
        j = _bhj(_fact(), _filter(_dd(), _year_is(year)), [col(0)], [col(0)],
                 cached_build_id=f"q14b_dd_{year}")
        return _agg2(_project(j, (col(1), "i")), [(col(0), "i")], [])

    d98, d99, d00 = (distinct_items(y) for y in (1998, 1999, 2000))
    exc = _bhj(_bhj(d98, d99, [col(0)], [col(0)], "left_semi"), d00, [col(0)], [col(0)],
               "left_anti")
    plan = _agg2(exc, [], _aggs(("count_star", None, "c"), ("min", col(0), "lo"),
                                ("max", col(0), "hi")))
    out = _concat([collect(_tasks(plan, res, 1, conf, device, stats), nulls=True)],
                  ["c", "lo", "lo_valid", "hi", "hi_valid"],
                  [np.int64, np.int64, bool, np.int64, bool])
    for k in ("lo", "hi"):  # NULL (no item left) reads 0
        out[k] = np.where(out[f"{k}_valid"], out[k], 0)
    return out


def _items_by_year(data: TpcdsData, year: int) -> np.ndarray:
    ss, drow, hit = _with_dates(data)
    yes = hit & (data.date_dim.columns["d_year"][drow] == year)
    return np.unique(ss["ss_item_sk"][yes])


def q14b_class_oracle(data: TpcdsData) -> dict:
    a, b, c = (_items_by_year(data, y) for y in (1998, 1999, 2000))
    keep = np.setdiff1d(np.intersect1d(a, b), c)
    some = np.array([len(keep) > 0])
    return {"c": np.array([len(keep)], dtype=np.int64),
            "lo": np.array([keep.min() if len(keep) else 0], dtype=np.int64), "lo_valid": some,
            "hi": np.array([keep.max() if len(keep) else 0], dtype=np.int64), "hi_valid": some}


# ---- q2-class: a CTE read twice, self-joined month on month ---------------


def run_q2_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                 stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Monthly revenue (a CTE materialized once) joined with itself shifted
    by one month: ratio = next month's revenue over this month's.
    {y, m, ratio} sorted by (y, m)."""
    res = _tail_inputs(data, 1, device, ingested)
    pr = _project(_bhj(_fact(), _dd(), [col(0)], [col(0)]), (col(6), "y"), (col(7), "m"),
                  (col(4), "p"))
    cte = _materialize(_agg2(pr, [(col(0), "y"), (col(1), "m")], _aggs(("sum", col(2), "rev"))),
                       res, "q2_cte", conf, device, stats)
    nxt = _project(_scan(cte, "q2_cte"), (col(0), "y"), (BinaryOp("sub", col(1), lit(1)), "m0"),
                   (col(2), "rev_next"))
    jj = _bhj(_scan(cte, "q2_cte"), nxt, [col(0), col(1)], [col(0), col(1)])
    plan = _project(jj, (col(0), "y"), (col(1), "m"), (BinaryOp("div", col(5), col(2)), "ratio"))
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["y", "m", "ratio"],
                  [np.int32, np.int32, np.float64])
    return _sorted_by(out, ["y", "m"])


def q2_class_oracle(data: TpcdsData) -> dict:
    ss, drow, hit = _with_dates(data)
    dd = data.date_dim.columns
    ym = dd["d_year"][drow[hit]].astype(np.int64) * 16 + dd["d_moy"][drow[hit]]
    keys, _, rev = _by(ym, ss["ss_ext_sales_price"][hit])
    pos, has_next = _lookup(keys, keys + 1)
    return {"y": (keys[has_next] // 16).astype(np.int32),
            "m": (keys[has_next] % 16).astype(np.int32),
            "ratio": rev[pos[has_next]] / rev[has_next]}


# ---- q4-class: a CTE chain: per-customer totals -> filter -> semi join ---


def run_q4_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                 stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Rows per item of the customers whose total spend exceeds 300 (the
    totals a CTE, the high spenders a filter over it, a semi join back to
    the fact): {i, n} sorted by i."""
    res = _tail_inputs(data, 1, device, ingested)
    cte = _materialize(_agg2(_fact(), [(col(2), "c")], _aggs(("sum", col(4), "s"))), res,
                       "q4_cte", conf, device, stats)
    high = _filter(_scan(cte, "q4_cte"), BinaryOp("gt", col(1), lit(300.0)))
    semi = _bhj(_fact(), high, [col(2)], [col(0)], "left_semi")
    plan = _agg2(semi, [(col(1), "i")], _aggs(("count_star", None, "n")),
                 _aggs(("count", col(2), "n")))
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["i", "n"], [np.int64, np.int64])
    return _sorted_by(out, ["i"])


def _valid_customers(data: TpcdsData):
    ss = data.store_sales
    return ss.columns, ss.columns["ss_customer_sk"], ss.validity("ss_customer_sk")


def q4_class_oracle(data: TpcdsData) -> dict:
    ss, cust, valid = _valid_customers(data)
    cs, _, tot = _by(cust[valid], ss["ss_ext_sales_price"][valid])
    keep = valid & np.isin(cust, cs[tot > 300.0])
    i, n, _ = _by(ss["ss_item_sk"][keep])
    return {"i": i, "n": n}


# ---- q11-class: year-over-year self-join of a CTE ------------------------


def run_q11_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Per-(customer, year) revenue (a CTE), 1999 joined with 1998 on
    customer where 1999 grew: {c, s99, s98} sorted by c."""
    res = _tail_inputs(data, 1, device, ingested)
    pr = _project(_bhj(_fact(), _dd(), [col(0)], [col(0)]), (col(2), "c"), (col(6), "y"),
                  (col(4), "p"))
    cte = _materialize(_agg2(pr, [(col(0), "c"), (col(1), "y")], _aggs(("sum", col(2), "s"))),
                       res, "q11_cte", conf, device, stats)
    y98 = _filter(_scan(cte, "q11_cte"), _year_is(1998))
    y99 = _filter(_scan(cte, "q11_cte"), _year_is(1999))
    growth = _filter(_bhj(y99, y98, [col(0)], [col(0)]), BinaryOp("gt", col(2), col(5)))
    plan = _project(growth, (col(0), "c"), (col(2), "s99"), (col(5), "s98"))
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["c", "s99", "s98"],
                  [np.int64, np.float64, np.float64])
    return _sorted_by(out, ["c"])


def q11_class_oracle(data: TpcdsData) -> dict:
    ss, drow, hit = _with_dates(data)
    valid = hit & data.store_sales.validity("ss_customer_sk")
    year = data.date_dim.columns["d_year"][drow]
    sums = []
    for y in (1999, 1998):
        k = valid & (year == y)
        sums.append(_by(ss["ss_customer_sk"][k], ss["ss_ext_sales_price"][k]))
    (c99, _, s99), (c98, _, s98) = sums
    pos, hit2 = _lookup(c98, c99)
    keep = hit2 & (s99 > s98[pos])
    return {"c": c99[keep], "s99": s99[keep], "s98": s98[pos[keep]]}


# ---- q15-class: EXISTS as a semi join under a filter ---------------------


def run_q15_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """count(*), sum(price) of sales above 50 whose item is in category 3:
    {n, s}."""
    res = _tail_inputs(data, 1, device, ingested)
    semi = _bhj(_filter(_fact(), BinaryOp("gt", col(4), lit(50.0))),
                _filter(_item(), BinaryOp("eq", col(2), lit(3))), [col(1)], [col(0)], "left_semi")
    plan = _agg2(semi, [], _aggs(("count_star", None, "n"), ("sum", col(4), "s")))
    return _answer(_tasks(plan, res, 1, conf, device, stats), ["n", "s"], [np.int64, np.float64])


def q15_class_oracle(data: TpcdsData) -> dict:
    it, ss = data.item.columns, data.store_sales.columns
    keep = (ss["ss_ext_sales_price"] > 50.0) & np.isin(
        ss["ss_item_sk"], it["i_item_sk"][it["i_category_id"] == 3])
    return {"n": np.array([keep.sum()], dtype=np.int64),
            "s": np.array([ss["ss_ext_sales_price"][keep].sum()])}


# ---- q31-class: a per-group average joined back ---------------------------


def run_q31_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Sales priced above twice their category's average, counted per
    category (the averages a broadcast subquery result): {cat, n} sorted."""
    res = _tail_inputs(data, 1, device, ingested)
    pr = _project(_bhj(_fact(), _item(), [col(1)], [col(0)]), (col(7), "cat"), (col(4), "p"))
    avg = _materialize(_agg2(pr, [(col(0), "cat")], _aggs(("avg", col(1), "a"))), res,
                       "q31_avg", conf, device, stats)
    j2 = _bhj(_bhj(_fact(), _item(), [col(1)], [col(0)]), _scan(avg, "q31_avg"), [col(7)],
              [col(0)])
    hot = _filter(j2, BinaryOp("gt", col(4), BinaryOp("mul", lit(2.0), col(11))))
    plan = _agg2(hot, [(col(7), "cat")], _aggs(("count_star", None, "n")),
                 _aggs(("count", col(8), "n")))
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["cat", "n"], [np.int32, np.int64])
    return _sorted_by(out, ["cat"])


def q31_class_oracle(data: TpcdsData) -> dict:
    ss = data.store_sales.columns
    cat, ihit, cat_avg = _category_avg(ss, data.item.columns)
    keep = ihit & (ss["ss_ext_sales_price"] > 2.0 * cat_avg)
    c, n, _ = _by(cat[keep])
    return {"cat": c.astype(np.int32), "n": n}


# ---- q34-class: GROUP BY ... HAVING count BETWEEN 3 AND 5 ----------------


def run_q34_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Customers with 3 to 5 sales: {c, n} sorted by c."""
    res = _tail_inputs(data, 1, device, ingested)
    f = _agg2(_fact(), [(col(2), "c")], _aggs(("count_star", None, "n")),
              _aggs(("count", col(3), "n")))
    plan = _filter(f, BinaryOp("and", BinaryOp("gteq", col(1), lit(3)), BinaryOp("lteq", col(1), lit(5))))
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["c", "n"], [np.int64, np.int64])
    return _sorted_by(out, ["c"])


def q34_class_oracle(data: TpcdsData) -> dict:
    _, cust, valid = _valid_customers(data)
    c, n, _ = _by(cust[valid])
    keep = (n >= 3) & (n <= 5)
    return {"c": c[keep], "n": n[keep]}


# ---- q38-class: three-way INTERSECT ---------------------------------------


def run_q38_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Customers active in 1998, 1999 and 2000 (distinct customer sets
    chained through two semi joins), counted: {n}."""
    res = _tail_inputs(data, 1, device, ingested)

    def customers_of(year: int):
        j = _bhj(_fact(), _filter(_dd(), _year_is(year)), [col(0)], [col(0)], "left_semi")
        return _agg2(j, [(col(2), "c")], [])

    inter = _bhj(_bhj(customers_of(1998), customers_of(1999), [col(0)], [col(0)], "left_semi"),
                 customers_of(2000), [col(0)], [col(0)], "left_semi")
    plan = _agg2(inter, [], _aggs(("count", col(0), "n")))
    return _answer(_tasks(plan, res, 1, conf, device, stats), ["n"], [np.int64])


def q38_class_oracle(data: TpcdsData) -> dict:
    ss, drow, hit = _with_dates(data)
    valid = hit & data.store_sales.validity("ss_customer_sk")
    year = data.date_dim.columns["d_year"][drow]
    sets = [np.unique(ss["ss_customer_sk"][valid & (year == y)]) for y in (1998, 1999, 2000)]
    both = np.intersect1d(np.intersect1d(sets[0], sets[1]), sets[2])
    return {"n": np.array([len(both)], dtype=np.int64)}


# ---- q54-class: BETWEEN date-range join, global aggregate ----------------

Q54_RANGE = (2_450_900, 2_451_300)


def run_q54_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """count(*), avg(price) of the sales on dates BETWEEN two date keys: {n, a}."""
    res = _tail_inputs(data, 1, device, ingested)
    lo, hi = Q54_RANGE
    rng = _filter(_dd(), BinaryOp("and", BinaryOp("gteq", col(0), lit(lo)), BinaryOp("lteq", col(0), lit(hi))))
    plan = _agg2(_bhj(_fact(), rng, [col(0)], [col(0)]), [],
                 _aggs(("count_star", None, "n"), ("avg", col(4), "a")))
    return _answer(_tasks(plan, res, 1, conf, device, stats), ["n", "a"], [np.int64, np.float64])


def q54_class_oracle(data: TpcdsData) -> dict:
    ss = data.store_sales.columns
    d = ss["ss_sold_date_sk"]
    keep = (d >= Q54_RANGE[0]) & (d <= Q54_RANGE[1])
    return {"n": np.array([keep.sum()], dtype=np.int64),
            "a": np.array([ss["ss_ext_sales_price"][keep].mean()])}


# ---- q58-class: UNION of three year branches, re-aggregated --------------


def run_q58_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """sum(price) per item over the sales of 1998, 1999 and 2000, each year
    a semi-join branch of a UNION ALL: {i, s} sorted by i."""
    from auron_tpu_torch.exec.basic import UnionExec

    res = _tail_inputs(data, 1, device, ingested)
    branches = [_project(_bhj(_fact(), _filter(_dd(), _year_is(y)), [col(0)], [col(0)],
                              "left_semi"), (col(1), "i"), (col(4), "p"))
                for y in (1998, 1999, 2000)]
    plan = _agg2(UnionExec(branches), [(col(0), "i")], _aggs(("sum", col(1), "s")))
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["i", "s"], [np.int64, np.float64])
    return _sorted_by(out, ["i"])


def q58_class_oracle(data: TpcdsData) -> dict:
    ss, drow, hit = _with_dates(data)
    keep = hit & np.isin(data.date_dim.columns["d_year"][drow], (1998, 1999, 2000))
    i, _, s = _by(ss["ss_item_sk"][keep], ss["ss_ext_sales_price"][keep])
    return {"i": i, "s": s}


# ---- q79-class: group-wise argmax joined back -----------------------------


def run_q79_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Each customer's sales at their own maximum price, counted (the maxima
    a broadcast subquery result): {c, n} sorted by c."""
    res = _tail_inputs(data, 1, device, ingested)
    mx = _materialize(_agg2(_fact(), [(col(2), "c")], _aggs(("max", col(4), "mx"))), res,
                      "q79_max", conf, device, stats)
    hit = _filter(_bhj(_fact(), _scan(mx, "q79_max"), [col(2)], [col(0)]),
                  BinaryOp("eq", col(4), col(6)))
    plan = _agg2(hit, [(col(2), "c")], _aggs(("count_star", None, "n")),
                 _aggs(("count", col(3), "n")))
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["c", "n"], [np.int64, np.int64])
    return _sorted_by(out, ["c"])


def q79_class_oracle(data: TpcdsData) -> dict:
    ss, cust, valid = _valid_customers(data)
    c, inv = _group(cust[valid])
    price = ss["ss_ext_sales_price"][valid]
    mx = np.full(len(c), -np.inf)
    np.maximum.at(mx, inv, price)
    keys, n, _ = _by(c[inv[price == mx[inv]]])
    return {"c": keys, "n": n}


# ---- q22-class: NOT IN as an anti join ------------------------------------


def run_q22_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Items never sold below price 5 (item LEFT ANTI JOIN the cheap sales),
    counted per category id: {cat, n} sorted by cat."""
    res = _tail_inputs(data, 1, device, ingested)
    cheap = _project(_filter(_fact(), BinaryOp("lt", col(4), lit(5.0))), (col(1), "i"))
    anti = _bhj(_item(), cheap, [col(0)], [col(0)], "left_anti")
    plan = _agg2(anti, [(col(2), "cat")], _aggs(("count_star", None, "n")),
                 _aggs(("count", col(3), "n")))
    out = _answer(_tasks(plan, res, 1, conf, device, stats), ["cat", "n"], [np.int32, np.int64])
    return _sorted_by(out, ["cat"])


def q22_class_oracle(data: TpcdsData) -> dict:
    it, ss = data.item.columns, data.store_sales.columns
    cheap = ss["ss_item_sk"][ss["ss_ext_sales_price"] < 5.0]
    keep = ~np.isin(it["i_item_sk"], cheap)
    cat, n, _ = _by(it["i_category_id"][keep])
    return {"cat": cat.astype(np.int32), "n": n}


# ---------------------------------------------------------------------------
# the join-tail classes: full, right and existence joins through the task
# runtime with the JAX function's operator tree and task count
# ---------------------------------------------------------------------------

#: the classes of this section, in the order chip_smoke.py runs them
JOIN_TAIL_CLASSES = ("q33",)


def q33_tree():
    """Two aggregate branches of the fact (quantity below 50, and 50 or
    more: sum of the price by item) FULL OUTER joined on the item, with the
    key coalesced from both sides (reference ``tpcds.py:2275-2298``)."""
    from auron_tpu_torch.exprs.ir import Coalesce

    def branch(pred, name):
        return _agg2(_filter(_fact(), pred), [(col(1), "i")], _aggs(("sum", col(4), name)))

    lo = branch(BinaryOp("lt", col(3), lit(50)), "lo")
    hi = branch(BinaryOp("gteq", col(3), lit(50)), "hi")
    full = _bhj(lo, hi, [col(0)], [col(0)], "full")
    return _project(full, (Coalesce((col(0), col(2))), "i"), (col(1), "lo"), (col(3), "hi"))


def run_q33_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Per item, the price sum of its low-quantity and of its high-quantity
    sales, an item sold only one way keeping a NULL on the other:
    {i, lo, lo_valid, hi, hi_valid} sorted by i (a NULL sum reads 0)."""
    res = _tail_inputs(data, 1, device, ingested)
    got = _concat([collect(_tasks(q33_tree(), res, 1, conf, device, stats), nulls=True)],
                  ["i", "lo", "lo_valid", "hi", "hi_valid"],
                  [np.int64, np.float64, bool, np.float64, bool])
    for k in ("lo", "hi"):
        got[k] = np.where(got[f"{k}_valid"], got[k], 0.0)
    return _sorted_by(got, ["i"])


def q33_class_oracle(data: TpcdsData) -> dict:
    ss = data.store_sales.columns
    item, price, qty = ss["ss_item_sk"], ss["ss_ext_sales_price"], ss["ss_quantity"]
    items = np.unique(item.astype(np.int64))
    out = {"i": items}
    for k, rows in (("lo", qty < 50), ("hi", qty >= 50)):
        keys, _, sums = _by(item[rows], price[rows])
        at = np.searchsorted(items, keys)
        out[k] = np.zeros(len(items))
        out[k][at] = sums
        out[f"{k}_valid"] = np.zeros(len(items), bool)
        out[f"{k}_valid"][at] = True
    return out


# ---------------------------------------------------------------------------
# the window, expand and scalar-subquery classes: each through the task
# runtime with the JAX function's operator tree and task count, over the
# whole fact table unless ``rows`` takes the JAX function's prefix
# ---------------------------------------------------------------------------

#: the classes of this section, in the order chip_smoke.py runs them
WINDOW_CLASSES = ("windowed", "windowed2", "q51", "q23", "q46", "q67", "q67b", "q9")
#: the fact prefix each JAX function takes (``store_sales.iloc[:n]``); the
#: port's functions take it as ``rows`` (None: the whole table)
WINDOW_PREFIX = {"windowed": 5000, "windowed2": 4000, "q51": 6000, "q67": 3000, "q67b": 2500}


def _prefixed(data: TpcdsData, rows: int | None) -> TpcdsData:
    if rows is None:
        return data
    ss = data.store_sales
    return TpcdsData(Table(ss.schema, {k: v[:rows] for k, v in ss.columns.items()},
                           {k: v[:rows] for k, v in ss.valid.items()}), data.date_dim, data.item)


def _window_inputs(data, n: int, device, ingested, rows) -> dict:
    """(fact in ``n`` partitions, dims) as resources, the fact cut to
    ``rows`` where no ingested input is given."""
    if ingested is None:
        ingested = ingest_q3(_prefixed(data, rows), n, device)
    return _tail_inputs(None, n, device, ingested)


def _ordered(batches: list, keys: list[str], keep=None) -> list:
    """The output batches as one batch whose live rows are ordered by the
    integer columns ``keys`` (ascending, a NULL first), sorted with the
    library sort where they live: the JAX functions' host ``sort_values``,
    and their host row filters as the ``keep(batch)`` mask."""
    import torch

    from auron_tpu_torch.columnar.batch import DeviceBatch, device_concat, device_take
    from auron_tpu_torch.ops.bitonic import lexsort

    if not batches:
        return []
    big = device_concat(batches)
    dev = big.device
    sel = dev.sel if keep is None else dev.sel & keep(big)
    ops = []
    for k in keys:
        i = big.schema.names.index(k)
        m = dev.validity[i]
        ops += [m.to(torch.int64), torch.where(m, dev.values[i], 0).to(torch.int64)]
    perm = lexsort(tuple(ops), kinds=("i64",) * len(ops))
    return [big.with_device(device_take(DeviceBatch(sel, dev.values, dev.validity), perm))]


def _window(child, partition_by: list, order_by: list, funcs: list):
    """WindowExec; ``funcs`` as (kind, agg, expr, offset, frame_whole, name)."""
    from auron_tpu_torch.exec.window_exec import WindowExec, WindowFunc

    return WindowExec(child, partition_by, order_by,
                      [(WindowFunc(k, agg=a, expr=e, offset=o or 1, frame_whole=w), name)
                       for k, a, e, o, w, name in funcs])


def _cents(price: np.ndarray) -> np.ndarray:
    """Prices are rounded to cents: their exact integer cents."""
    return np.rint(price * 100).astype(np.int64)


def _seg_starts(part: np.ndarray) -> np.ndarray:
    """First index of each row's run of equal ``part`` values (sorted)."""
    first = np.ones(len(part), bool)
    first[1:] = part[1:] != part[:-1]
    return np.maximum.accumulate(np.where(first, np.arange(len(part)), 0))


def _running_cents(part: np.ndarray, cents: np.ndarray) -> np.ndarray:
    """Exact running sum within each run of equal ``part`` values, in cents."""
    cum = np.cumsum(cents)
    start = _seg_starts(part)
    return cum - np.where(start > 0, cum[start - 1], 0)


def running_sum_bound(part: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Allowed |got - want| of a running float sum (non-negative inputs)
    whose rows are sorted by the partition key ``part``: 1e-9 |want| +
    16 eps G, G the global prefix sum up to the row, since the window
    computes a global cumsum rebased at the partition start."""
    start = _seg_starts(part)
    last = np.ones(len(part), bool)
    last[:-1] = part[1:] != part[:-1]
    totals = np.where(last, want, 0.0)
    before = np.cumsum(totals) - totals  # the totals of earlier partitions
    g = want + before[start]
    return 1e-9 * np.abs(want) + 16 * np.finfo(np.float64).eps * g


def _rank_min(part: np.ndarray, key: np.ndarray) -> np.ndarray:
    """rank() of rows sorted by (part, key DESC): 1 + the rows of the
    partition before the row's peer group."""
    n = len(part)
    new_peer = np.ones(n, bool)
    new_peer[1:] = (part[1:] != part[:-1]) | (key[1:] != key[:-1])
    peer_start = np.maximum.accumulate(np.where(new_peer, np.arange(n), 0))
    return (peer_start - _seg_starts(part) + 1).astype(np.int32)


# ---- windowed: rank by revenue within a date --------------------------------


def run_windowed_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                       stats: dict | None = None, ingested: dict | None = None,
                       rows: int | None = None, money: bool = False) -> dict:
    """Revenue per (date, item) (partial + final aggregate), rank() by
    revenue DESC within the date (WindowExec, one task over the fact's two
    partitions), then rank <= 2 kept on the host: {d, item, rev, rk} sorted
    by (d, rk, item). With ``money`` the revenue is sum(Cast(price AS
    decimal(7,2))), a decimal(17,2) in int64 cents: exact, so ties rank
    alike."""
    res = _window_inputs(data, 2, device, ingested, rows)
    res["fact"] = [[b for part in res["fact"] for b in part]]
    price = Cast(col(4), MONEY) if money else col(4)
    agg = _agg2(_fact(), [(col(0), "d"), (col(1), "item")], _aggs(("sum", price, "rev")))
    plan = _window(agg, [col(0)], [(col(2), SortSpec(asc=False))],
                   [("rank", None, None, 1, False, "rk")])
    batches = _ordered(_tasks(plan, res, 1, conf, device, stats), ["d", "rk", "item"],
                       keep=lambda b: b.col_values(3) <= 2)
    return _answer(batches, ["d", "item", "rev", "rk"],
                   [np.int64, np.int64, np.int64 if money else np.float64, np.int32])


def windowed_ranks(data: TpcdsData, rows: int | None = None, money: bool = False) -> dict:
    """Every (date, item) group with its exact revenue in cents and the
    ranks its revenue can take: ``lo`` = 1 + the groups of the date with
    more revenue, ``hi`` = ``lo`` + the other groups with the same revenue
    (a tie the engine's float sums may split). ``money``: the cents of the
    decimal(7,2) cast (``money_cents``)."""
    ss = _prefixed(data, rows).store_sales.columns
    d, item = ss["ss_sold_date_sk"], ss["ss_item_sk"]
    ni = int(item.max()) + 1
    keys, inv = _group(d * ni + item)
    price = ss["ss_ext_sales_price"]
    cents = int_sums(inv, money_cents(price) if money else _cents(price), len(keys))
    gd, gi = keys // ni, keys % ni
    order = _lex_order([gd, -cents, gi])
    gd, gi, cents = gd[order], gi[order], cents[order]
    lo = _rank_min(gd, cents)
    n = len(gd)
    last = np.ones(n, bool)
    last[:-1] = (gd[1:] != gd[:-1]) | (cents[1:] != cents[:-1])
    peer_last = np.minimum.accumulate(np.where(last, np.arange(n), n)[::-1])[::-1]
    hi = (peer_last - _seg_starts(gd) + 1).astype(np.int32)  # my peer group's last position
    return {"d": gd, "item": gi, "cents": cents, "lo": lo, "hi": hi}


def windowed_class_oracle(data: TpcdsData, rows: int | None = None,
                          money: bool = False) -> dict:
    """The groups of rank() <= 2 over exact revenues (ties share the lower
    rank), sorted by (d, rk, item); ``money``: revenues in int64 cents."""
    g = windowed_ranks(data, rows, money)
    keep = g["lo"] <= 2
    rev = g["cents"][keep]
    out = {"d": g["d"][keep], "item": g["item"][keep], "rev": rev if money else rev / 100.0,
           "rk": g["lo"][keep]}
    return _sorted_by(out, ["d", "rk", "item"])


def windowed_mismatch(got: dict, ranks: dict) -> str | None:
    """None when ``got`` is a right answer of the windowed class under the
    tie rule, given its groups' ``windowed_ranks``: each kept group's rank
    lies in its [lo, hi] span and is <= 2, its revenue is its exact revenue
    at rel 1e-9, every group with hi <= 2 is kept, no group is kept twice,
    and the rows are sorted by (d, rk, item). Without ties in cents this is
    equality with the oracle."""
    g = ranks
    gk = g["d"] * (1 << 32) + g["item"]
    order = np.argsort(gk)
    k = got["d"].astype(np.int64) * (1 << 32) + got["item"]
    pos = np.clip(np.searchsorted(gk[order], k), 0, len(gk) - 1)
    row = order[pos]
    if not np.array_equal(gk[row], k):
        return "a kept (d, item) group does not exist"
    if len(np.unique(k)) != len(k):
        return "a group kept twice"
    rk = got["rk"]
    if not ((g["lo"][row] <= rk) & (rk <= g["hi"][row]) & (rk <= 2)).all():
        return "a rank outside its tie span"
    want = g["cents"][row] / 100.0
    if not (np.abs(got["rev"] - want) <= 1e-9 * np.abs(want)).all():
        return "a revenue off by more than rel 1e-9"
    if not np.isin(gk[g["hi"] <= 2], k).all():
        return "a group ranked <= 2 under every tie order is missing"
    if not np.array_equal(_lex_order([got["d"], rk, got["item"]]), np.arange(len(k))):
        return "rows not sorted by (d, rk, item)"
    return None


# ---- windowed2: lag and a running sum by item over date ---------------------


def windowed2_fact(data: TpcdsData, rows: int | None = None) -> Table:
    """The fact de-duplicated on (item, date), the first occurrence kept in
    row order (the JAX function's ``drop_duplicates``)."""
    ss = _prefixed(data, rows).store_sales
    c = ss.columns
    _, first = np.unique(c["ss_item_sk"] * (1 << 32) + c["ss_sold_date_sk"], return_index=True)
    keep = np.sort(first)
    return Table(ss.schema, {k: v[keep] for k, v in c.items()},
                 {k: v[keep] for k, v in ss.valid.items()})


def ingest_windowed2(data: TpcdsData, device="cuda", rows: int | None = None) -> dict:
    return {"fact": to_batches(windowed2_fact(data, rows), 1, device=device)}


def run_windowed2_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                        stats: dict | None = None, ingested: dict | None = None,
                        rows: int | None = None) -> dict:
    """lag(price) and the running sum(price) per item ordered by date over
    the de-duplicated fact (one task): {ss_item_sk, ss_sold_date_sk,
    prev_price (+ prev_price_valid), run_sum} sorted by (item, date)."""
    if ingested is None:
        ingested = ingest_windowed2(data, device, rows)
    plan = _window(_fact(), [col(1)], [(col(0), SortSpec())],
                   [("lag", None, col(4), 1, False, "prev_price"),
                    ("agg", "sum", col(4), 1, False, "run_sum")])
    batches = _tasks(plan, {"fact": ingested["fact"]}, 1, conf, device, stats)
    out = collect(_ordered(batches, ["ss_item_sk", "ss_sold_date_sk"]), nulls=True)
    return {"ss_item_sk": out["ss_item_sk"], "ss_sold_date_sk": out["ss_sold_date_sk"],
            "prev_price": np.where(out["prev_price_valid"], out["prev_price"], 0.0),
            "prev_price_valid": out["prev_price_valid"], "run_sum": out["run_sum"]}


def windowed2_class_oracle(data: TpcdsData, rows: int | None = None) -> dict:
    c = _prefixed(data, rows).store_sales.columns
    keys, first = np.unique(c["ss_item_sk"] * (1 << 32) + c["ss_sold_date_sk"],
                            return_index=True)  # sorted by (item, date)
    item, date = keys >> 32, keys & 0xFFFFFFFF  # date_sk < 2^32
    price = c["ss_ext_sales_price"][first]
    first = _seg_starts(item) == np.arange(len(item))
    prev = np.where(first, 0.0, np.roll(price, 1))
    return {"ss_item_sk": item, "ss_sold_date_sk": date, "prev_price": prev,
            "prev_price_valid": ~first, "run_sum": _running_cents(item, _cents(price)) / 100.0}


# ---- q51: a running total over a join's aggregate --------------------------


def run_q51_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None,
                  rows: int | None = None) -> dict:
    """fact JOIN date_dim, revenue per (item, year), then the running sum
    per item ordered by year (one task): {item, y, rev, run_rev} sorted by
    (item, y)."""
    res = _window_inputs(data, 1, device, ingested, rows)
    pr = _project(_bhj(_fact(), _dd(), [col(0)], [col(0)]),
                  (col(1), "item"), (col(6), "y"), (col(4), "price"))
    agg = _agg2(pr, [(col(0), "item"), (col(1), "y")], _aggs(("sum", col(2), "rev")))
    plan = _window(agg, [col(0)], [(col(1), SortSpec())],
                   [("agg", "sum", col(2), 1, False, "run_rev")])
    return _answer(_ordered(_tasks(plan, res, 1, conf, device, stats), ["item", "y"]),
                   ["item", "y", "rev", "run_rev"], [np.int64, np.int32, np.float64, np.float64])


def _item_year_cents(data: TpcdsData, rows: int | None = None):
    """(item, year, exact revenue in cents) per group, sorted by (item, year)."""
    ss, dd = _prefixed(data, rows).store_sales.columns, data.date_dim.columns
    drow, hit = _lookup(dd["d_date_sk"], ss["ss_sold_date_sk"])
    year = dd["d_year"][drow[hit]].astype(np.int64)
    keys, inv = _group(ss["ss_item_sk"][hit] * 4096 + year)
    cents = np.bincount(inv, weights=_cents(ss["ss_ext_sales_price"][hit]),
                        minlength=len(keys)).astype(np.int64)
    return keys // 4096, (keys % 4096).astype(np.int32), cents


def q51_class_oracle(data: TpcdsData, rows: int | None = None) -> dict:
    item, y, cents = _item_year_cents(data, rows)
    return {"item": item, "y": y, "rev": cents / 100.0,
            "run_rev": _running_cents(item, cents) / 100.0}


# ---- q23: the top three brands by revenue within a category -----------------


def run_q23_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None,
                  rows: int | None = None) -> dict:
    """fact JOIN item, revenue per (category id, brand), rank() by
    (revenue DESC, brand) within the category, rank <= 3 kept on the host:
    {cat, brand, rev, rk} sorted by (cat, rk, brand)."""
    res = _window_inputs(data, 1, device, ingested, rows)
    pr = _project(_bhj(_fact(), _item(), [col(1)], [col(0)]),
                  (col(7), "cat"), (col(6), "brand"), (col(4), "price"))
    agg = _agg2(pr, [(col(0), "cat"), (col(1), "brand")], _aggs(("sum", col(2), "rev")))
    plan = _window(agg, [col(0)], [(col(2), SortSpec(asc=False)), (col(1), SortSpec())],
                   [("rank", None, None, 1, False, "rk")])
    batches = _ordered(_tasks(plan, res, 1, conf, device, stats), ["cat", "rk", "brand"],
                       keep=lambda b: b.col_values(3) <= 3)
    return _answer(batches, ["cat", "brand", "rev", "rk"],
                   [np.int32, np.int32, np.float64, np.int32])


def _top_by_revenue(part: np.ndarray, key: np.ndarray, cents: np.ndarray, k: int):
    """Rows ranked by (cents DESC, key) within ``part``, rank <= k kept:
    (part, key, cents, rank) sorted by (part, rank)."""
    order = _lex_order([part, -cents, key])
    part, key, cents = part[order], key[order], cents[order]
    rk = (np.arange(len(part)) - _seg_starts(part) + 1).astype(np.int32)
    keep = rk <= k
    return part[keep], key[keep], cents[keep], rk[keep]


def q23_class_oracle(data: TpcdsData, rows: int | None = None) -> dict:
    ss, it = _prefixed(data, rows).store_sales.columns, data.item.columns
    irow, hit = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    cat = it["i_category_id"][irow[hit]].astype(np.int64)
    brand = it["i_brand_id"][irow[hit]].astype(np.int64)
    nb = int(brand.max()) + 1
    keys, inv = _group(cat * nb + brand)
    cents = np.bincount(inv, weights=_cents(ss["ss_ext_sales_price"][hit]),
                        minlength=len(keys)).astype(np.int64)
    c, b, s, rk = _top_by_revenue(keys // nb, keys % nb, cents, 3)
    return {"cat": c.astype(np.int32), "brand": b.astype(np.int32), "rev": s / 100.0, "rk": rk}


# ---- q46: rank items by revenue within a year, a plan filter rk <= 3 -------


def run_q46_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None,
                  rows: int | None = None) -> dict:
    """fact JOIN date_dim, revenue per (year, item), rank() by (revenue
    DESC, item) within the year, FilterExec rk <= 3 (one task): {y, i, rev,
    rk} sorted by (y, rk, i)."""
    res = _window_inputs(data, 1, device, ingested, rows)
    pr = _project(_bhj(_fact(), _dd(), [col(0)], [col(0)]),
                  (col(6), "y"), (col(1), "i"), (col(4), "p"))
    agg = _agg2(pr, [(col(0), "y"), (col(1), "i")], _aggs(("sum", col(2), "rev")))
    w = _window(agg, [col(0)], [(col(2), SortSpec(asc=False)), (col(1), SortSpec())],
                [("rank", None, None, 0, False, "rk")])
    plan = _filter(w, BinaryOp("lteq", col(3), lit(3)))
    return _answer(_ordered(_tasks(plan, res, 1, conf, device, stats), ["y", "rk", "i"]),
                   ["y", "i", "rev", "rk"], [np.int32, np.int64, np.float64, np.int32])


def q46_class_oracle(data: TpcdsData, rows: int | None = None) -> dict:
    item, y, cents = _item_year_cents(data, rows)
    yy, i, s, rk = _top_by_revenue(y.astype(np.int64), item, cents, 3)
    return {"y": yy.astype(np.int32), "i": i, "rev": s / 100.0, "rk": rk}


# ---- q67 / q67b: ROLLUP and CUBE through one ExpandExec --------------------

#: (gid, keeps date, keeps item) of each grouping set
_ROLLUP = ((0, True, True), (1, True, False), (3, False, False))
_CUBE = ((0, True, True), (1, True, False), (2, False, True), (3, False, False))


def _expand_tree(sets, aggs):
    from auron_tpu_torch.exec.basic import ExpandExec

    null = Literal(None, T.INT64)
    ex = ExpandExec(_fact(), [[col(0) if d else null, col(1) if i else null, col(4), lit(gid)]
                              for gid, d, i in sets], ["d", "i", "price", "gid"])
    keys = [(col(0), "d"), (col(1), "i"), (col(3), "gid")]
    return _agg2(ex, keys, aggs)


def _grouping_sets_answer(batches, with_count: bool) -> dict:
    out = collect(_ordered(batches, ["gid", "d", "i"]), nulls=True)
    got = {"d": np.where(out["d_valid"], out["d"], 0), "d_valid": out["d_valid"],
           "i": np.where(out["i_valid"], out["i"], 0), "i_valid": out["i_valid"],
           "gid": out["gid"], "s": out["s"]}
    if with_count:
        got["c"] = out["c"]
    return got


def run_q67_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None,
                  rows: int | None = None) -> dict:
    """GROUP BY ROLLUP(date, item): ExpandExec emits the three grouping
    sets with a grouping id, one partial + final aggregate over the
    expanded stream (one task): {d, i (+ _valid), gid, s} sorted by (gid,
    d, i), NULLs first."""
    res = _window_inputs(data, 1, device, ingested, rows)
    plan = _expand_tree(_ROLLUP, _aggs(("sum", col(2), "s")))
    return _grouping_sets_answer(_tasks(plan, res, 1, conf, device, stats), False)


def run_q67b_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                   stats: dict | None = None, ingested: dict | None = None,
                   rows: int | None = None) -> dict:
    """GROUP BY CUBE(date, item): the four grouping sets through one
    ExpandExec, sum and count(*) (one task): {d, i (+ _valid), gid, s, c}."""
    res = _window_inputs(data, 1, device, ingested, rows)
    plan = _expand_tree(_CUBE, _aggs(("sum", col(2), "s"), ("count_star", None, "c")))
    return _grouping_sets_answer(_tasks(plan, res, 1, conf, device, stats), True)


def _grouping_sets_oracle(data: TpcdsData, rows, sets, with_count: bool) -> dict:
    ss = _prefixed(data, rows).store_sales.columns
    d, item, price = ss["ss_sold_date_sk"], ss["ss_item_sk"], ss["ss_ext_sales_price"]
    ni = int(item.max()) + 1
    parts = []
    for gid, keep_d, keep_i in sets:
        kd, ki = (d if keep_d else np.zeros_like(d)), (item if keep_i else np.zeros_like(item))
        keys, n, s = _by(kd * ni + ki, price)
        m = len(keys)
        parts.append({"d": keys // ni if keep_d else np.zeros(m, np.int64),
                      "d_valid": np.full(m, keep_d), "i": keys % ni if keep_i
                      else np.zeros(m, np.int64), "i_valid": np.full(m, keep_i),
                      "gid": np.full(m, gid, np.int32), "s": s, "c": n})
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    if not with_count:
        del out["c"]
    return _sorted_by(out, ["gid", "d_valid", "d", "i_valid", "i"])


def q67_class_oracle(data: TpcdsData, rows: int | None = None) -> dict:
    return _grouping_sets_oracle(data, rows, _ROLLUP, False)


def q67b_class_oracle(data: TpcdsData, rows: int | None = None) -> dict:
    return _grouping_sets_oracle(data, rows, _CUBE, True)


# ---- q9: a scalar subquery in a filter -------------------------------------


def run_q9_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                 stats: dict | None = None, ingested: dict | None = None,
                 rows: int | None = None) -> dict:
    """Task 1: the global avg(price), read on the host; task 2: the rows
    priced above ScalarSubquery("q9_avg"), counted and summed: {c, s}."""
    from auron_tpu_torch.exprs.ir import ScalarSubquery

    res = _window_inputs(data, 1, device, ingested, rows)
    sub = _agg2(_fact(), [], _aggs(("avg", col(4), "a")))
    res["q9_avg"] = float(_answer(_tasks(sub, res, 1, conf, device, stats), ["a"],
                                  [np.float64])["a"][0])
    flt = _filter(_fact(), BinaryOp("gt", col(4), ScalarSubquery("q9_avg", T.FLOAT64)))
    plan = _agg2(flt, [], _aggs(("count_star", None, "c"), ("sum", col(4), "s")))
    return _answer(_tasks(plan, res, 1, conf, device, stats), ["c", "s"], [np.int64, np.float64])


def q9_class_oracle(data: TpcdsData, rows: int | None = None) -> dict:
    price = _prefixed(data, rows).store_sales.columns["ss_ext_sales_price"]
    keep = price[price > price.mean()]
    return {"c": np.array([len(keep)], np.int64), "s": np.array([keep.sum()])}


# ---------------------------------------------------------------------------
# decimal paths: the wide-decimal q9b class, and q3, q42 and windowed with
# TPC-DS's money type decimal(7,2)
# ---------------------------------------------------------------------------

#: the classes of this section, in the order chip_smoke.py runs them
DECIMAL_CLASSES = ("q9b", "q3_decimal", "q42_decimal", "windowed_decimal")
#: TPC-DS's type of every money column
MONEY = T.decimal(7, 2)
Q9B_SCHEMA = T.Schema((T.Field("g", T.INT64, False), T.Field("amount", T.decimal(38, 4), True)))


def money_cents(price: np.ndarray) -> np.ndarray:
    """The int64 cents of ``Cast(price AS decimal(7,2))``: HALF_UP of
    ``price * 100.0``, as the cast computes it (prices are >= 0)."""
    return np.floor(price * 100.0 + 0.5).astype(np.int64)


def int_sums(inv: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """Exact int64 sums of ``vals`` by group index ``inv`` (0..n-1): a
    float64 ``bincount`` where every partial sum stays an integer below
    2^52 (exact then), else a sort and ``np.add.reduceat``."""
    vals = vals.astype(np.int64)
    if np.abs(vals).sum(dtype=np.float64) < 2.0**52:
        return np.bincount(inv, weights=vals, minlength=n).astype(np.int64)
    out = np.zeros(n, np.int64)
    if len(inv):
        order = np.argsort(inv, kind="stable")
        g = inv[order]
        starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
        out[g[starts]] = np.add.reduceat(vals[order], starts)
    return out


def q9b_amounts(n: int):
    """The reference's ``_q9b_amounts``: group ids and decimal(38,4)
    amounts (~1e30-1e31). Groups 0-6 mix signs (a third negative) so their
    sums stay inside 38 digits; group 7 is all positive near the top
    (9.9e30 each), so any 1,011 rows or more overflow."""
    import decimal as pydec

    rng = np.random.default_rng(99)
    g = rng.integers(0, 8, n)
    digits = rng.integers(10**14, 10**15, n)
    amounts = []
    for i in range(n):
        base = 990_000_000_000_000 if g[i] == 7 else int(digits[i]) * (-1 if i % 3 == 0 else 1)
        amounts.append(pydec.Decimal(base).scaleb(16))
    return g, amounts


def ingest_q9b(data: TpcdsData, device="cuda") -> dict:
    """The q9b fact (min(fact rows, 20,000) amounts) as one batch."""
    n = min(len(data.store_sales), 20_000)
    g, amounts = q9b_amounts(n)
    col_a = np.empty(n, dtype=object)
    col_a[:] = amounts
    return {"q9b_fact": [[Batch.from_numpy([g.astype(np.int64), col_a], Q9B_SCHEMA,
                                           device=device)]]}


def q9b_tree():
    aggs = _aggs(("sum", col(1), "s"), ("min", col(1), "mn"), ("max", col(1), "mx"),
                 ("count", col(1), "c"))
    return _agg2(_scan(Q9B_SCHEMA, "q9b_fact"), [(col(0), "g")], aggs)


def run_q9b_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, ingested: dict | None = None) -> dict:
    """Partial and final sum/min/max/count of decimal(38,4) amounts by group
    in one task: {g, s, mn, mx, c} by g, the decimals as ``Decimal`` (the
    overflowing group's ``s`` None)."""
    res = dict(ingested) if ingested is not None else ingest_q9b(data, device)
    out = collect(_tasks(q9b_tree(), res, 1, conf, device, stats))
    order = np.argsort(out["g"], kind="stable")
    return {k: out[k][order] for k in ("g", "s", "mn", "mx", "c")}


def q9b_class_oracle(data: TpcdsData) -> dict:
    """Exact Python-decimal sums (None past 38 digits), min, max, count."""
    import decimal as pydec

    n = min(len(data.store_sales), 20_000)
    g, amounts = q9b_amounts(n)
    acc: dict = {}
    limit = pydec.Decimal(10) ** 34  # 38 digits at scale 4
    with pydec.localcontext() as hp:
        hp.prec = 80
        for gi, a in zip(g.tolist(), amounts):
            s, mn, mx, c = acc.get(gi, (pydec.Decimal(0), a, a, 0))
            acc[gi] = (s + a, min(mn, a), max(mx, a), c + 1)
    keys = sorted(acc)

    def obj(vals):
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return out

    return {"g": np.array(keys, np.int64),
            "s": obj([acc[k][0] if abs(acc[k][0]) < limit else None for k in keys]),
            "mn": obj([acc[k][1] for k in keys]), "mx": obj([acc[k][2] for k in keys]),
            "c": np.array([acc[k][3] for k in keys], np.int64)}


def run_q3_decimal_class(data: TpcdsData | None = None, **kw) -> dict:
    """q3 with the money type: ``run_q3_class(..., money=True)``."""
    return run_q3_class(data, money=True, **kw)


def q3_decimal_class_oracle(data: TpcdsData, moy: int = 11, category_id: int = 1,
                            limit: int = 100) -> dict:
    """q3 over ``money_cents``: exact int64 sums (decimal(17,2) in cents)."""
    year, brand, hit = _q3_rows(data, moy, category_id)
    uniq, inv = np.unique(np.stack([year, brand], 1), axis=0, return_inverse=True)
    s = int_sums(inv.reshape(-1), money_cents(data.store_sales.columns["ss_ext_sales_price"][hit]),
                 len(uniq))
    return _top_k(uniq[:, 0], uniq[:, 1], s, limit)


def q42_decimal_exec_tree():
    """q42's tree with SELECT i_brand_id brand, sum(price * ss_quantity)
    rev, avg(price) avg_price, price = Cast(ss_ext_sales_price AS
    decimal(7,2)): the product is decimal(18,2), its sum decimal(28,2)
    (base-1e9 limbs), the avg decimal(11,6); ORDER BY rev DESC, brand
    LIMIT 10 sorts the wide result by its vocabulary's rank (one K3
    launch)."""
    from auron_tpu_torch.exec.agg_exec import AggExpr, HashAggExec
    from auron_tpu_torch.exec.basic import ProjectExec, ResourceScanExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec
    from auron_tpu_torch.exec.sort_exec import SortExec

    fact = ResourceScanExec(STORE_SALES_SCHEMA, "q42_fact")
    item = ResourceScanExec(ITEM_SCHEMA, "q42_item")
    j = BroadcastHashJoinExec(fact, item, [col(1)], [col(0)], "inner",
                              build_side="right", projection=[3, 4, 6])
    pr = ProjectExec(j, [col(2), Cast(col(1), MONEY), col(0)], ["brand", "p", "q"])
    aggs = [(AggExpr("sum", BinaryOp("mul", col(1), col(2))), "rev"),
            (AggExpr("avg", col(1)), "avg_price")]
    p = HashAggExec(pr, [(col(0), "brand")], aggs, "partial")
    f = HashAggExec(p, [(col(0), "brand")], [(AggExpr("sum", col(1)), "rev"),
                                             (AggExpr("avg", col(1)), "avg_price")], "final")
    return SortExec(f, [col(1), col(0)], [SortSpec(asc=False), SortSpec()], fetch=10)


def run_q42_decimal_class(data: TpcdsData | None = None, device="cuda",
                          conf: dict | None = None, ingested: dict | None = None,
                          stats: dict | None = None) -> dict:
    """The decimal q42 through the task runtime: {brand, rev (int64 cents),
    avg_price (int64 millionths)}."""
    from auron_tpu_torch.runtime.task import TaskRuntime

    if ingested is None:
        ingested = ingest_q42(data, device)
    rt = TaskRuntime(q42_decimal_exec_tree(), resources=dict(ingested),
                     conf=Configuration(conf or {}), device=device)
    try:
        out = collect(list(rt))
    finally:
        snapshot = rt.finalize()
    if stats is not None:
        add_timers(stats, snapshot)
    rev = np.array([T.unscaled_int(x, 2) for x in out["rev"]], dtype=np.int64)
    return {"brand": out["brand"], "rev": rev, "avg_price": out["avg_price"]}


def q42_decimal_class_oracle(data: TpcdsData) -> dict:
    """int64 cents: rev = sum(cents * quantity), avg_price = HALF_UP of
    sum(cents) * 10^4 / count (decimal(11,6))."""
    ss, it = data.store_sales.columns, data.item.columns
    row, hit = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    brand = it["i_brand_id"][row[hit]].astype(np.int64)
    cents = money_cents(ss["ss_ext_sales_price"][hit])
    uniq, inv = _group(brand)
    rev = int_sums(inv, cents * ss["ss_quantity"][hit].astype(np.int64), len(uniq))
    tot = int_sums(inv, cents, len(uniq))
    cnt = np.bincount(inv, minlength=len(uniq)).astype(np.int64)
    q, r = np.divmod(tot * 10_000, cnt)
    avg = q + (2 * r >= cnt)
    top = np.lexsort((uniq, -rev))[:10]
    return {"brand": uniq[top].astype(np.int32), "rev": rev[top], "avg_price": avg[top]}


def run_windowed_decimal_class(data: TpcdsData | None = None, **kw) -> dict:
    """The windowed class over money revenues (``money=True``)."""
    return run_windowed_class(data, money=True, **kw)


def windowed_decimal_class_oracle(data: TpcdsData, rows: int | None = None) -> dict:
    return windowed_class_oracle(data, rows, money=True)


# ---------------------------------------------------------------------------
# the probe class: a generic aggregate whose keys repeat across batches
# ---------------------------------------------------------------------------


def probe_agg_exec_tree():
    """SELECT ss_item_sk, ss_sold_date_sk, sum(ss_ext_sales_price),
    count(ss_customer_sk), min(ss_quantity), max(ss_quantity),
    first(ss_quantity) FROM store_sales GROUP BY ss_item_sk,
    ss_sold_date_sk: 18,000 items x 1,825 dates = 32.85 M slots at SF >= 0.1,
    beyond the dense table's 2^21 (``agg_exec._DenseAggState.LIMIT``), so
    the generic path runs, and a key of a later batch has often been seen
    before: the sorted-state probe's workload
    (``exec.agg.incremental.probe``)."""
    from auron_tpu_torch.exec.agg_exec import AggExpr, HashAggExec
    from auron_tpu_torch.exec.basic import ResourceScanExec

    keys = [(col(1), "item"), (col(0), "date")]
    p = HashAggExec(ResourceScanExec(STORE_SALES_SCHEMA, "probe_fact"), keys,
                    [(AggExpr("sum", col(4)), "s"), (AggExpr("count", col(2)), "c"),
                     (AggExpr("min", col(3)), "lo"), (AggExpr("max", col(3)), "hi"),
                     (AggExpr("first", col(3)), "f")], "partial")
    return HashAggExec(p, [(col(0), "item"), (col(1), "date")],
                       [(AggExpr("sum", col(2)), "s"), (AggExpr("count", col(3)), "c"),
                        (AggExpr("min", col(4)), "lo"), (AggExpr("max", col(5)), "hi"),
                        (AggExpr("first", col(6)), "f")], "final")


def run_probe_agg_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                        ingested: dict | None = None, stats: dict | None = None) -> dict:
    """The probe class through the task runtime, sorted by (item, date);
    ``ingested`` = {"probe_fact": partitions} (default: the fact in
    ``1 << 20``-row batches)."""
    from auron_tpu_torch.runtime.task import TaskRuntime

    if ingested is None:
        ingested = {"probe_fact": to_batches(data.store_sales, 1, device=device)}
    rt = TaskRuntime(probe_agg_exec_tree(), resources=dict(ingested),
                     conf=Configuration(conf or {}), device=device)
    try:
        out = collect(list(rt))
    finally:
        snapshot = rt.finalize()
    if stats is not None:
        add_timers(stats, snapshot)
    order = np.lexsort((out["date"], out["item"]))
    return {k: v[order] for k, v in out.items()}


def probe_agg_class_oracle(data: TpcdsData) -> dict:
    """The same groups in numpy: ``first`` is each group's first row in
    stream order (the fact's row order)."""
    ss = data.store_sales.columns
    item, date = ss["ss_item_sk"], ss["ss_sold_date_sk"]
    order = np.argsort(item * 4096 + (date - date.min()), kind="stable")
    key = (item * 4096 + (date - date.min()))[order]
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    first = order[starts]  # stable: each group's first row in stream order
    q = ss["ss_quantity"][order]
    valid = data.store_sales.validity("ss_customer_sk")[order]
    return {"item": item[first], "date": date[first],
            "s": np.add.reduceat(ss["ss_ext_sales_price"][order], starts),
            "c": np.add.reduceat(valid.astype(np.int64), starts),
            "lo": np.minimum.reduceat(q, starts), "hi": np.maximum.reduceat(q, starts),
            "f": ss["ss_quantity"][first]}


# ---------------------------------------------------------------------------
# the generate classes: split + explode + aggregate (reference
# ``models/tpcds.py:805-830``), and the same operators over the whole fact
# ---------------------------------------------------------------------------

#: the classes of this section, in the order chip_smoke.py runs them
GENERATE_CLASSES = ("generate", "tag_revenue")


def _split_tags(i_tags_col: int):
    from auron_tpu_torch.exprs.ir import ScalarFunc

    return ScalarFunc("split", (col(i_tags_col), lit(",")))


def generate_exec_tree():
    """SELECT tag, count(*) FROM item LATERAL VIEW explode(split(i_tags, ','))
    GROUP BY tag: the tree ``task_from_proto`` builds from the reference's
    ``run_generate_class`` plan (a barrier for column pruning)."""
    from auron_tpu_torch.exec.generate_exec import GenerateExec

    gen = GenerateExec(_scan(ITEM_SCHEMA, "qg_item"), "explode", _split_tags(4), [0],
                       elem_name="tag")
    return _agg2(gen, [(col(1), "tag")], _aggs(("count_star", None, "cnt")))


def run_generate_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                       stats: dict | None = None, ingested: dict | None = None) -> dict:
    """The 42nd class: {tag, cnt} sorted by tag; ``ingested`` = {"qg_item":
    partitions} (default: the item table as one batch)."""
    res = dict(ingested) if ingested is not None else {
        "qg_item": to_batches(data.item, 1, device=device)}
    out = collect(_tasks(generate_exec_tree(), res, 1, conf, device, stats))
    order = np.argsort(out["tag"].astype(str), kind="stable")
    return {"tag": out["tag"][order], "cnt": out["cnt"][order]}


def _item_tags(data: TpcdsData) -> tuple[np.ndarray, np.ndarray]:
    """(the distinct tags ascending, an [items, tags] membership matrix)."""
    lists = [s.split(",") for s in data.item.columns["i_tags"]]
    tags = np.array(sorted({t for ts in lists for t in ts}), dtype=object)
    pos = {t: i for i, t in enumerate(tags)}
    member = np.zeros((len(lists), len(tags)), dtype=np.int64)
    for r, ts in enumerate(lists):
        for t in ts:
            member[r, pos[t]] += 1
    return tags, member


def generate_class_oracle(data: TpcdsData) -> dict:
    tags, member = _item_tags(data)
    return {"tag": tags, "cnt": member.sum(axis=0)}


def tag_revenue_exec_tree():
    """SELECT tag, count(*), sum(ss_ext_sales_price) FROM store_sales JOIN
    item ON ss_item_sk = i_item_sk LATERAL VIEW explode(split(i_tags, ','))
    GROUP BY tag: a broadcast hash join of the fact with item, the explode
    of each joined row's tags (keeping the price), and partial and final
    aggregates by tag. The generate is a pruning barrier, so the join keeps
    all ten columns (i_tags at 9)."""
    from auron_tpu_torch.exec.generate_exec import GenerateExec

    j = _bhj(_fact(), _item(), [col(1)], [col(0)])
    gen = GenerateExec(j, "explode", _split_tags(9), [4], elem_name="tag")
    return _agg2(gen, [(col(1), "tag")],
                 _aggs(("count_star", None, "cnt"), ("sum", col(0), "rev")))


def run_tag_revenue_class(data: TpcdsData | None = None, device="cuda",
                          conf: dict | None = None, stats: dict | None = None,
                          ingested: dict | None = None) -> dict:
    """The explode over the whole fact: {tag, cnt, rev} sorted by tag;
    ``ingested`` as ``ingest_q3(data, 1)`` gives it (the fact in ``1 << 20``-row
    batches)."""
    res = _tail_inputs(data, 1, device, ingested)
    out = collect(_tasks(tag_revenue_exec_tree(), res, 1, conf, device, stats))
    order = np.argsort(out["tag"].astype(str), kind="stable")
    return {k: out[k][order] for k in ("tag", "cnt", "rev")}


def tag_revenue_class_oracle(data: TpcdsData) -> dict:
    """Each fact row counts once for each of its item's tags."""
    tags, member = _item_tags(data)
    ss, it = data.store_sales.columns, data.item.columns
    order = np.argsort(it["i_item_sk"], kind="stable")
    keys = it["i_item_sk"][order]
    pos = np.clip(np.searchsorted(keys, ss["ss_item_sk"]), 0, len(keys) - 1)
    hit = keys[pos] == ss["ss_item_sk"]
    rows = order[pos[hit]]
    price = ss["ss_ext_sales_price"][hit]
    per_item_n = np.bincount(rows, minlength=len(order))
    per_item_rev = np.bincount(rows, weights=price, minlength=len(order))
    return {"tag": tags, "cnt": per_item_n @ member, "rev": per_item_rev @ member}


def exploded_rows(data: TpcdsData) -> dict:
    """The rows each generate class's explode emits, from the data: the
    item's tag count, and each fact row's item's tag count summed."""
    lists = [len(s.split(",")) for s in data.item.columns["i_tags"]]
    n_tags = np.array(lists, dtype=np.int64)
    ss_item = data.store_sales.columns["ss_item_sk"]
    order = np.argsort(data.item.columns["i_item_sk"], kind="stable")
    keys = data.item.columns["i_item_sk"][order]
    pos = np.clip(np.searchsorted(keys, ss_item), 0, len(keys) - 1)
    hit = keys[pos] == ss_item
    return {"generate": int(n_tags.sum()), "tag_revenue": int(n_tags[order[pos[hit]]].sum())}


# ---------------------------------------------------------------------------
# converted host plans: the host-plan JSON a Spark shim sends
# (HostPlanSerializer), converted by bridge.api.convert_plan_json and run as
# the response's stages, as the JVM's NativeSegmentExec runs them
# ---------------------------------------------------------------------------


def _hattr(i: int, name: str = "") -> dict:
    return {"kind": "attr", "index": i, "name": name}


def _hlit(value, type_name: str) -> dict:
    return {"kind": "lit", "value": value, "type": type_name}


def _hcall(name: str, *children, **extra) -> dict:
    return {"kind": "call", "name": name, "children": list(children), **extra}


def _hschema(schema: T.Schema) -> list:
    from auron_tpu_torch.convert.service import _type_name

    return [[f.name, _type_name(f.dtype), f.nullable] for f in schema]


def _hnode(op: str, schema, args: dict | None = None, *children) -> dict:
    if isinstance(schema, T.Schema):
        schema = _hschema(schema)
    return {"op": op, "schema": schema, "args": args or {}, "children": list(children)}


def _hscan(schema: T.Schema, rid: str) -> dict:
    return _hnode("LocalTableScanExec", schema, {"resource_id": rid})


def _hbroadcast(child: dict) -> dict:
    return _hnode("BroadcastExchangeExec", child["schema"], {}, child)


def _hbhj(left: dict, right: dict, lkey: int, rkey: int, join_type: str = "inner") -> dict:
    """A broadcast hash join with the build on the right, as the serializer
    writes it (``joinArgs``)."""
    return _hnode("BroadcastHashJoinExec", left["schema"] + right["schema"],
                  {"left_keys": [_hattr(lkey)], "right_keys": [_hattr(rkey)],
                   "join_type": join_type, "condition": None, "build_side": "right"},
                  left, _hbroadcast(right))


def _hagg(child: dict, mode: str, schema: list, groupings: list, aggs: list) -> dict:
    """A HashAggregateExec: ``groupings`` (expr, name) pairs, ``aggs``
    (fn, expr or None, name) triples."""
    return _hnode("HashAggregateExec", schema,
                  {"mode": mode, "groupings": [{"expr": e, "name": n} for e, n in groupings],
                   "aggs": [{"fn": f, "expr": e, "name": n} for f, e, n in aggs]}, child)


def _hexchange(child: dict, partitioning: dict) -> dict:
    return _hnode("ShuffleExchangeExec", child["schema"], {"partitioning": partitioning}, child)


def _horder(*fields) -> list:
    """Sort fields from (column, ascending, nulls first) triples."""
    return [{"expr": _hattr(c), "asc": asc, "nulls_first": nf} for c, asc, nf in fields]


def _leaf(scans: dict | None, schema: T.Schema, rid: str) -> dict:
    """The host plan's leaf for ``rid``: ``scans[rid]`` (e.g. a
    ``FileSourceScanExec``, ``file_scan``) where given, else the in-memory
    ``LocalTableScanExec`` of that resource."""
    return scans[rid] if scans and rid in scans else _hscan(schema, rid)


def q42_host_plan(scans: dict | None = None) -> dict:
    """q42-class as a Spark shim serializes it: TakeOrderedAndProject(10,
    rev DESC, brand) <- final <- partial HashAggregate(brand, sum(price)) <-
    Project <- BroadcastHashJoin(fact, BroadcastExchange(item)). ``scans``
    replaces leaves by resource id (``_leaf``)."""
    j = _hbhj(_leaf(scans, STORE_SALES_SCHEMA, "q42_fact"),
              _leaf(scans, ITEM_SCHEMA, "q42_item"), 1, 0)
    pr = _hnode("ProjectExec", [["brand", "int", True], ["p", "double", True]],
                {"projections": [_hattr(6, "i_brand_id"), _hattr(4, "ss_ext_sales_price")]}, j)
    out = [["brand", "int", True], ["rev", "double", True]]
    p = _hagg(pr, "partial", out, [(_hattr(0), "brand")], [("sum", _hattr(1), "rev")])
    f = _hagg(p, "final", out, [(_hattr(0), "brand")], [("sum", _hattr(1), "rev")])
    return _hnode("TakeOrderedAndProjectExec", out,
                  {"limit": 10, "order": _horder((1, False, False), (0, True, True)),
                   "projections": [_hattr(0, "brand"), _hattr(1, "rev")]}, f)


def q93_host_plan(n_reduce: int = 4, scans: dict | None = None) -> dict:
    """q93-class: final <- partial HashAggregate(k IS NULL) <- left
    BroadcastHashJoin(customer) <- ShuffleExchange(hash k, n_reduce) <-
    Project(CASE WHEN ss_quantity < 85 THEN NULL ELSE ss_customer_sk END k,
    price) <- the fact. ``scans`` as in ``q42_host_plan``."""
    key = _hcall("if", _hcall("lessthan", _hattr(3), _hlit(85, "int")), _hlit(None, "long"),
                 _hattr(2, "ss_customer_sk"))
    pr = _hnode("ProjectExec", Q93_INTER_SCHEMA,
                {"projections": [key, _hattr(4, "ss_ext_sales_price")]},
                _leaf(scans, STORE_SALES_SCHEMA, "q93_fact"))
    ex = _hexchange(pr, {"kind": "hash", "num_partitions": n_reduce, "exprs": [_hattr(0, "k")]})
    j = _hbhj(ex, _leaf(scans, CUSTOMER_SCHEMA, "q93_cust"), 0, 0, "left")
    out = [["k_null", "boolean", False], ["rows", "long", False], ["matched", "long", False],
           ["s", "double", True]]
    p = _hagg(j, "partial", out, [(_hcall("isnull", _hattr(0)), "k_null")],
              [("count_star", None, "rows"), ("count", _hattr(2), "matched"),
               ("sum", _hattr(1), "s")])
    return _hagg(p, "final", out, [(_hattr(0), "k_null")],
                 [("count_star", None, "rows"), ("count", _hattr(1), "matched"),
                  ("sum", _hattr(2), "s")])


def q3_host_plan(n_reduce: int = 4, moy: int = 11, category_id: int = 1,
                 scans: dict | None = None) -> dict:
    """q3-class: final HashAggregate(d_year, i_brand_id) <- ShuffleExchange
    (hash, n_reduce) <- partial <- Project <- the fact joined with the
    filtered date_dim and item (the top-k is taken on the host). ``scans``
    as in ``q42_host_plan``; the fact's leaf may hold any of its columns that
    include date, item and price (the sorted files' four)."""
    dd = _hnode("FilterExec", DATE_DIM_SCHEMA,
                {"predicates": [_hcall("equalto", _hattr(2), _hlit(moy, "int"))]},
                _leaf(scans, DATE_DIM_SCHEMA, "q3_dd"))
    it = _hnode("FilterExec", ITEM_SCHEMA,
                {"predicates": [_hcall("equalto", _hattr(2), _hlit(category_id, "int"))]},
                _leaf(scans, ITEM_SCHEMA, "q3_item"))
    fact = _leaf(scans, STORE_SALES_SCHEMA, "q3_fact")
    names = [f[0] for f in fact["schema"]]
    w = len(names)
    j2 = _hbhj(_hbhj(fact, dd, names.index("ss_sold_date_sk"), 0), it,
               names.index("ss_item_sk"), 0)
    pr = _hnode("ProjectExec", [["d_year", "int", True], ["i_brand_id", "int", True],
                                ["price", "double", True]],
                {"projections": [_hattr(w + 1, "d_year"), _hattr(w + 4, "i_brand_id"),
                                 _hattr(names.index("ss_ext_sales_price"),
                                        "ss_ext_sales_price")]}, j2)
    out = [["d_year", "int", True], ["i_brand_id", "int", True], ["s", "double", True]]
    keys = [(_hattr(0), "d_year"), (_hattr(1), "i_brand_id")]
    p = _hagg(pr, "partial", out, keys, [("sum", _hattr(2), "s")])
    ex = _hexchange(p, {"kind": "hash", "num_partitions": n_reduce,
                        "exprs": [_hattr(0), _hattr(1)]})
    return _hagg(ex, "final", out, keys, [("sum", _hattr(2), "s")])


#: the range sort's projection of the fact and its ORDER BY: ss_sold_date_sk
#: ascending with NULLs first, then ss_item_sk descending with NULLs last
RANGE_SORT_COLUMNS = ("ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_ext_sales_price")
RANGE_SORT_ORDER = ((0, True, True), (1, False, False))


def range_sort_bounds(data: TpcdsData, n_reduce: int = 4) -> list[tuple[int, int]]:
    """The range exchange's bounds as the shim's ``RangeBoundsSampler``
    makes them: max(100, 20 n) rows of the fact's prefix (random, as the
    generator is), sorted by the ordering; bound i is the row at
    min(len - 1, i * len / n)."""
    m = min(max(100, 20 * n_reduce), len(data.store_sales))
    date = data.store_sales.columns["ss_sold_date_sk"][:m]
    item = data.store_sales.columns["ss_item_sk"][:m]
    order = np.lexsort((-item, date))
    return [(int(date[order[r]]), int(item[order[r]]))
            for r in (min(m - 1, i * m // n_reduce) for i in range(1, n_reduce))]


def range_sort_host_plan(data: TpcdsData, n_reduce: int = 4) -> dict:
    """A global ORDER BY without a limit (``df.orderBy(...).write``):
    SortExec(global) <- ShuffleExchange(range, n_reduce, sampled bounds) <-
    Project(the four columns) <- the fact."""
    cols = [STORE_SALES_SCHEMA.names.index(c) for c in RANGE_SORT_COLUMNS]
    fact = _hschema(STORE_SALES_SCHEMA)
    pr = _hnode("ProjectExec", [fact[i] for i in cols],
                {"projections": [_hattr(i, fact[i][0]) for i in cols]},
                _hscan(STORE_SALES_SCHEMA, "rs_fact"))
    order = _horder(*RANGE_SORT_ORDER)
    # the shim's typed literal rows: {"value": v, "type": t} per sort key
    bounds = [[{"value": d, "type": "long"}, {"value": i, "type": "long"}]
              for d, i in range_sort_bounds(data, n_reduce)]
    ex = _hexchange(pr, {"kind": "range", "num_partitions": n_reduce, "order": order,
                         "bounds": bounds})
    return _hnode("SortExec", pr["schema"], {"order": order, "global": True}, ex)


def convert_host_plan(host_plan: dict, stats: dict | None = None) -> dict:
    """The segmentation response of ``bridge.api.convert_plan_json`` for a
    host plan; ``stats`` gets ``convert_s`` and ``response_bytes``. Raises
    unless the whole plan converted into one native segment."""
    import json

    from auron_tpu_torch.bridge import api

    payload = json.dumps(host_plan).encode()
    t0 = time.perf_counter()
    raw = api.convert_plan_json(payload)
    convert_s = time.perf_counter() - t0
    resp = json.loads(raw)
    if stats is not None:
        stats["convert_s"] = stats.get("convert_s", 0.0) + convert_s
        stats["response_bytes"] = len(raw)
    root = resp.get("root") or {}
    if not resp.get("converted") or root.get("kind") != "segment" or root.get("inputs"):
        raise ValueError(f"the host plan did not convert whole: {resp.get('error')} "
                         f"{resp.get('tags')}")
    return resp


def namespace_free(raw: bytes) -> dict:
    """A segmentation response with its stage namespace (the converting
    process's pid and conversion counter, ``convert/service._namespace``)
    replaced by ``cNS_``, in the JSON and inside the plans (shuffle-writer
    paths, ipc_reader resource ids): two conversions of one host plan,
    in two processes, compare equal."""
    import base64
    import json
    import re

    from auron_tpu_torch.plan.protowalk import child_nodes

    ns = re.compile(r"c\d+_\d+_")

    def fix(node):
        which = node.WhichOneof("plan")
        if which == "shuffle_writer":
            w = node.shuffle_writer
            w.output_data_file = ns.sub("cNS_", w.output_data_file)
            w.output_index_file = ns.sub("cNS_", w.output_index_file)
        elif which == "ipc_reader":
            node.ipc_reader.resource_id = ns.sub("cNS_", node.ipc_reader.resource_id)
        for c in child_nodes(node):
            fix(c)

    def walk(v):
        if isinstance(v, dict):
            out = {}
            for k, x in v.items():
                if k == "plan_b64":
                    node = _plan_of(x)
                    fix(node)
                    x = base64.b64encode(node.SerializeToString()).decode()
                out[k] = walk(x)
            return out
        if isinstance(v, list):
            return [walk(x) for x in v]
        return ns.sub("cNS_", v) if isinstance(v, str) else v

    return walk(json.loads(raw))


def _plan_of(b64: str):
    import base64

    from auron_tpu_torch import proto as pb

    return pb.PhysicalPlanNode.FromString(base64.b64decode(b64))


def _host_columns(batches: list) -> dict:
    """Host Arrow batches (``arrow_c.HostBatch``) as numpy columns; {} when
    they hold no row."""
    cols: dict = {}
    for hb in batches:
        for name, vals in hb.to_pydict().items():
            cols.setdefault(name, []).extend(vals)
    return {k: np.array(v) for k, v in cols.items()} if any(cols.values()) else {}


def run_converted(host_plan: dict, resources: dict, n_map: int, device="cuda",
                  conf: dict | None = None, stats: dict | None = None,
                  work_dir: str | None = None, nulls: bool = False,
                  response: dict | None = None, via: str = "bridge") -> list[dict]:
    """Run a host plan as the JVM runs a segmentation response: convert it
    (``convert_host_plan``, or take ``response``), then take each stage in
    order; each task partition's ``TaskDefinition`` (``stage_task``) runs
    from its bytes. A stage fed by no exchange runs as many tasks as the
    response pins (``task_partitions``: a file scan's groups), else
    ``n_map``; one fed by exchanges runs their reduce width. Map outputs
    are committed to a ``ShuffleManager`` and handed over as manifests (``put_resource_shuffle``
    under the exchange id, which the next stage's ``ipc_reader`` names).
    ``via`` "bridge": tasks through ``bridge.api`` in this process, with
    ``resources`` overlaid per task; "library": through ``libauron_bridge``
    loaded into this process (``bridge/host.CLibrary``: tasks, manifests and
    answers cross the C ABI; ``resources`` go into the process's map for
    the run; no ``nulls``). Returns the final stage's tasks' answers as host
    columns. ``stats`` gets ``convert_s``, ``response_bytes``, ``stages``,
    each task's ``decode_s``/``plan_s``/wall (``tasks``), the stage walls
    (``stage_s``), ``shuffle_bytes``, the final answers' host read
    (``collect_s``), the rows per final partition (``partition_rows``)
    and the metric trees' timers (``add_timers``)."""
    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.convert.stages import ShuffleManager, StageSpec, stage_task

    if via not in ("bridge", "library") or (via == "library" and nulls):
        raise ValueError(f"via must be bridge or library (without nulls), not {via!r}")
    stats = stats if stats is not None else {}
    resp = response if response is not None else convert_host_plan(host_plan, stats)
    specs = [StageSpec(i, _plan_of(s["plan_b64"]), s["exchange_id"],
                       s["num_output_partitions"], list(s["input_exchange_ids"]))
             for i, s in enumerate(resp["root"]["stages"])]
    # a stage over host-decided file groups runs exactly that many tasks
    pinned = [s.get("task_partitions") for s in resp["root"]["stages"]]
    stats["stages"] = len(specs)
    conf = dict(conf or {})
    work = work_dir or tempfile.mkdtemp(prefix="auron_converted_")
    os.makedirs(work, exist_ok=True)
    shuffle, width, keys = ShuffleManager(), {}, []
    stage_s, tasks = stats.setdefault("stage_s", []), stats.setdefault("tasks", [])
    if via == "library":
        from auron_tpu_torch.bridge.host import CLibrary

        lib = CLibrary(device)
        for k, v in resources.items():
            api.put_resource(k, v)
            keys.append(k)
    try:
        with memory_scope(Configuration(conf), stats):
            for spec in specs:
                t0 = time.perf_counter()
                n_tasks = (width[spec.input_exchange_ids[0]] if spec.input_exchange_ids
                           else pinned[spec.stage_id] or n_map)
                outs = []
                for p in range(n_tasks):
                    task = stage_task(spec, p, work, conf).SerializeToString()
                    t1 = time.perf_counter()
                    if via == "library":
                        batches, metrics = lib.run(task)
                    else:
                        batches, metrics = run_task_bytes(task, resources, device)
                    if spec.is_final:
                        t2 = time.perf_counter()
                        outs.append(_host_columns(batches) if via == "library"
                                    else collect(batches, nulls))
                        stats["collect_s"] = stats.get("collect_s", 0.0) + \
                            time.perf_counter() - t2
                    else:
                        stats["shuffle_bytes"] = stats.get("shuffle_bytes", 0) + \
                            metrics["values"]["data_size"]
                        shuffle.register_map_output(
                            spec.exchange_id, p,
                            spec.data_template.format(work_dir=work, partition=p),
                            spec.index_template.format(work_dir=work, partition=p))
                    tasks.append({"stage": spec.stage_id, "partition": p,
                                  "wall_s": time.perf_counter() - t1, **metrics["task"]})
                    add_timers(stats, metrics)
                if not spec.is_final:
                    width[spec.exchange_id] = spec.num_output_partitions
                    hand_over = lib.put_resource_shuffle if via == "library" else \
                        api.put_resource_shuffle
                    hand_over(spec.exchange_id, shuffle.manifest(spec.exchange_id))
                    keys.append(spec.exchange_id)
                _sync(device)
                stage_s.append(time.perf_counter() - t0)
        stats["partition_rows"] = [len(next(iter(o.values()))) if o else 0 for o in outs]
        return outs
    finally:
        for k in keys:
            api.remove_resource(k)
        if work_dir is None:
            shutil.rmtree(work, ignore_errors=True)


def run_converted_mesh(host_plan: dict, resources: dict, n_parts: int = 4, device="cuda",
                       conf: dict | None = None, stats: dict | None = None) -> list:
    """The converted segment's plan (its ``mesh_exchange`` nodes inside) as
    one plan through the planned-exchange driver at P = ``n_parts``;
    returns each partition's output batches. ``stats`` gets ``convert_s``,
    ``response_bytes`` and what ``_run_mesh`` adds."""
    resp = convert_host_plan(host_plan, stats)
    return _run_mesh(_plan_of(resp["root"]["plan_b64"]), resources, n_parts, device, conf, stats)


def run_q42_converted(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                      ingested: dict | None = None, stats: dict | None = None) -> dict:
    """q42-class from its host plan through the conversion; {brand, rev}."""
    if ingested is None:
        ingested = ingest_q42(data, device)
    (out,) = run_converted(q42_host_plan(), dict(ingested), 1, device, conf, stats)
    return {"brand": out["brand"], "rev": out["rev"]}


def _q93_resources(ingested: dict, n_reduce: int) -> dict:
    return {"q93_fact": ingested["fact"], "q93_cust": [ingested["cust"]] * n_reduce}


def run_q93_converted(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                      device="cuda", conf: dict | None = None, ingested: dict | None = None,
                      stats: dict | None = None, work_dir: str | None = None,
                      response: dict | None = None, via: str = "bridge") -> dict:
    """q93-class from its host plan through the conversion (or from a
    ``response`` of it made elsewhere, e.g. by ``bridge_harness --convert``),
    as ``run_q93_class`` answers it; ``via`` as in ``run_converted``.
    ``stats["partition_rows"]`` counts the fact rows each reduce partition
    aggregated."""
    if ingested is None:
        ingested = ingest_q93(data, n_map, device)
    stats = stats if stats is not None else {}
    outs = run_converted(q93_host_plan(n_reduce), _q93_resources(ingested, n_reduce),
                         len(ingested["fact"]), device, conf, stats, work_dir,
                         response=response, via=via)
    stats["partition_rows"] = [int(o["rows"].sum()) if o else 0 for o in outs]
    return _q93_by_key(outs)


def run_q93_converted_mesh(data: TpcdsData | None = None, n_parts: int = 4, device="cuda",
                           conf: dict | None = None, ingested: dict | None = None,
                           stats: dict | None = None) -> dict:
    """The converted q93 segment as one plan under ``MeshQueryDriver``."""
    if ingested is None:
        ingested = ingest_q93(data, n_parts, device)
    outs = run_converted_mesh(q93_host_plan(n_parts), _q93_resources(ingested, n_parts),
                              n_parts, device, conf, stats)
    return _q93_by_key([collect(o) for o in outs])


def run_q3_converted(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                     device="cuda", conf: dict | None = None, ingested: dict | None = None,
                     stats: dict | None = None, limit: int = 100) -> dict:
    """q3-class from its host plan through the conversion; the driver takes
    the top-k, as in ``run_q3_class``."""
    if ingested is None:
        ingested = ingest_q3(data, n_map, device)
    n_map = len(ingested["fact"])
    resources = {"q3_fact": ingested["fact"], "q3_dd": [ingested["dd"]] * n_map,
                 "q3_item": [ingested["item"]] * n_map}
    outs = run_converted(q3_host_plan(n_reduce), resources, n_map, device, conf, stats)
    got = _concat(outs, ["d_year", "i_brand_id", "s"], [np.int32, np.int32, np.float64])
    return _top_k(got["d_year"], got["i_brand_id"], got["s"], limit)


def ingest_range_sort(data: TpcdsData, n_map: int, device="cuda", fact=None) -> dict:
    return {"rs_fact": fact if fact is not None else to_batches(data.store_sales, n_map,
                                                                 device=device)}


def run_range_sort_converted(data: TpcdsData, n_map: int = 4, n_reduce: int = 4,
                             device="cuda", conf: dict | None = None,
                             ingested: dict | None = None, stats: dict | None = None,
                             work_dir: str | None = None) -> list[dict]:
    """The range-partitioned global sort from its host plan: map tasks
    route the projected fact by the sampled bounds, each reduce task sorts
    its partition. Returns the reduce partitions in order, each the four
    columns and their ``<name>_valid`` masks."""
    if ingested is None:
        ingested = ingest_range_sort(data, n_map, device)
    return run_converted(range_sort_host_plan(data, n_reduce), dict(ingested),
                         len(ingested["rs_fact"]), device, conf, stats, work_dir, nulls=True)


def _range_key(date: np.ndarray, item: np.ndarray) -> np.ndarray:
    """One int64 per row whose order is the range sort's: date ascending,
    then item descending (both non-negative and below 2^31 here)."""
    return (date.astype(np.int64) << 32) - item.astype(np.int64)


#: the full lexsort of the range sort's rows, most significant first
_RANGE_ROW_ORDER = ("ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_customer_sk_valid",
                    "ss_ext_sales_price")


def _lexsorted(cols: dict, keys: tuple, device) -> dict:
    """``cols`` in the lexicographic order of ``keys`` (most significant
    first): stable library sorts from the least significant key up, on
    ``device`` (a check of the answer, independent of the port's sorts)."""
    import torch

    from auron_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    n = len(cols[keys[0]])
    order = torch.arange(n, device=dev)
    for k in reversed(keys):
        t = torch.from_numpy(np.ascontiguousarray(cols[k])).to(dev)[order]
        order = order[torch.sort(t.to(torch.int8) if t.dtype == torch.bool else t,
                                 stable=True).indices]
    order = order.cpu().numpy()
    return {k: v[order] for k, v in cols.items()}


def range_sort_oracle(data: TpcdsData, n_reduce: int = 4, device="cpu") -> dict:
    """What the range sort must give: its bounds (as order keys) and the
    fact's four columns (with validity) in a full lexsort of all four."""
    ss = data.store_sales
    cols = {c: ss.columns[c] for c in RANGE_SORT_COLUMNS}
    cols["ss_customer_sk_valid"] = ss.validity("ss_customer_sk")
    bounds = range_sort_bounds(data, n_reduce)
    return {"bounds": np.array([_range_key(np.array([d]), np.array([i]))[0]
                                for d, i in bounds], np.int64),
            "rows": _lexsorted(cols, _RANGE_ROW_ORDER, device)}


def range_sort_mismatch(parts: list[dict], want: dict, device="cpu") -> str | None:
    """None when the reduce partitions are a right range sort: each ordered
    by (date asc, item desc), every row of partition i above bound i-1 and
    at or below bound i (Spark's rule: the number of bounds strictly below
    the row), and all of them together exactly the fact's rows (both sides
    in a full lexsort of the four columns, on ``device``); else what is
    wrong."""
    bounds = want["bounds"]
    if len(parts) != len(bounds) + 1:
        return f"{len(parts)} partitions for {len(bounds)} bounds"
    for i, p in enumerate(parts):
        if not p:
            continue
        if not (p["ss_sold_date_sk_valid"].all() and p["ss_item_sk_valid"].all()):
            return f"partition {i}: a NULL sort key"
        key = _range_key(p["ss_sold_date_sk"], p["ss_item_sk"])
        if np.any(np.diff(key) < 0):
            return f"partition {i} is not ordered"
        if i > 0 and key.min() <= bounds[i - 1]:
            return f"partition {i} holds a row at or below bound {i - 1}"
        if i < len(bounds) and key.max() > bounds[i]:
            return f"partition {i} holds a row above bound {i}"
    got = {c: np.concatenate([p[c] for p in parts if p]) for c in _RANGE_ROW_ORDER}
    got["ss_customer_sk"] = np.where(got["ss_customer_sk_valid"], got["ss_customer_sk"], 0)
    rows = want["rows"]
    if len(got["ss_item_sk"]) != len(rows["ss_item_sk"]):
        return f"{len(got['ss_item_sk'])} rows, the fact has {len(rows['ss_item_sk'])}"
    got = _lexsorted(got, _RANGE_ROW_ORDER, device)
    for c, v in rows.items():
        if not np.array_equal(got[c], v):
            return f"column {c} differs from the fact's rows"
    return None


# ---------------------------------------------------------------------------
# file-backed host plans: the tables written by converted
# DataWritingCommandExec plans, read back through FileSourceScanExec leaves
# ---------------------------------------------------------------------------

#: the file paths' task conf: a scan cuts its row groups into batches of
#: 1 << 20 rows, as ``to_batches`` cuts the in-memory tables
FILE_CONF = {"batch.size": str(1 << 20)}
#: the columns of the range sort's output, and so of the sorted files
RANGE_SORT_SCHEMA = T.Schema(tuple(STORE_SALES_SCHEMA[STORE_SALES_SCHEMA.names.index(c)]
                                   for c in RANGE_SORT_COLUMNS))


def file_scan(schema, files: list[str], fmt: str = "parquet",
              groups: list[list[str]] | None = None, filters: list | None = None) -> dict:
    """A ``FileSourceScanExec`` host node over ``files``; ``groups`` holds
    one file group per task (the response then pins the task count),
    ``filters`` the pushed filters (host expressions)."""
    args: dict = {"format": fmt, "files": list(files)}
    if groups is not None:
        args["partitions"] = [list(g) for g in groups]
    if filters:
        args["filters"] = list(filters)
    return _hnode("FileSourceScanExec", schema, args)


def write_host_plan(child: dict, path: str, fmt: str = "parquet",
                    partition_by: list[str] | None = None) -> dict:
    """``df.write.format(fmt).partitionBy(...).save(path)`` as the shim
    serializes it: a ``DataWritingCommandExec`` over ``child``."""
    return _hnode("DataWritingCommandExec", [],
                  {"format": fmt, "path": path, "partition_by": list(partition_by or []),
                   "props": {}}, child)


def part_files(path: str, fmt: str = "parquet") -> list[str]:
    """The part files a sink wrote directly under ``path``, in task order."""
    return sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith("." + fmt))


def dir_bytes(path: str) -> int:
    """Bytes of every file under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def file_tables(data: TpcdsData) -> dict:
    """The tables the file paths read, by name: the fact, item, date_dim and
    q93's customer."""
    return {"store_sales": data.store_sales, "item": data.item, "date_dim": data.date_dim,
            "customer": customer_table()}


def write_table(table: Table, path: str, device="cuda", fmt: str = "parquet",
                partition_by: list[str] | None = None, batches: list | None = None,
                n_parts: int = 1, conf: dict | None = None, stats: dict | None = None) -> str:
    """Write ``table`` under ``path`` through its converted
    ``DataWritingCommandExec`` plan over an in-memory scan: one task per
    partition of ``batches`` (default: the table in ``n_parts`` partitions
    on ``device``), each writing ``part-<task>.<fmt>`` (Hive directories
    with ``partition_by``). ``stats`` gets what ``run_converted`` adds;
    returns ``path``."""
    if batches is None:
        batches = to_batches(table, n_parts, device=device)
    plan = write_host_plan(_hscan(table.schema, "w_table"), path, fmt, partition_by)
    run_converted(plan, {"w_table": batches}, len(batches), device, conf, stats)
    return path


def write_tables(data: TpcdsData, root: str, device="cuda", fact: list | None = None,
                 conf: dict | None = None, stats: dict | None = None) -> dict:
    """``file_tables`` as Parquet under ``root``: the fact from 4 map tasks
    (4 part files; ``fact``: its partitions on the card), each dimension
    from one. Returns {name: directory}; ``stats[name]`` gets the write's
    ``wall_s``, ``bytes`` and ``run_converted``'s stats."""
    paths = {}
    for name, table in file_tables(data).items():
        st: dict = {}
        t0 = time.perf_counter()
        paths[name] = write_table(table, os.path.join(root, name), device,
                                  batches=fact if name == "store_sales" else None,
                                  n_parts=4 if name == "store_sales" else 1, conf=conf, stats=st)
        st["wall_s"] = time.perf_counter() - t0
        st["bytes"] = dir_bytes(paths[name])
        if stats is not None:
            stats[name] = st
    return paths


def run_sorted_write(data: TpcdsData, path: str, n_map: int = 4, n_reduce: int = 4,
                     device="cuda", conf: dict | None = None, ingested: dict | None = None,
                     stats: dict | None = None, work_dir: str | None = None) -> list[str]:
    """``df.orderBy(date, item).write.parquet(path)``: the range sort's host
    plan under a ``DataWritingCommandExec``; each reduce task sorts its
    range and writes one date-ordered part file. Returns the files."""
    if ingested is None:
        ingested = ingest_range_sort(data, n_map, device)
    run_converted(write_host_plan(range_sort_host_plan(data, n_reduce), path), dict(ingested),
                  len(ingested["rs_fact"]), device, {**FILE_CONF, **(conf or {})}, stats,
                  work_dir)
    return part_files(path)


def _fact_files_scan(schema: T.Schema, path: str, n_groups: int, fmt: str = "parquet",
               filters: list | None = None) -> dict:
    """The fact's scan over its part files in ``n_groups`` contiguous file
    groups, one a task."""
    files = part_files(path, fmt)
    per = -(-len(files) // n_groups)
    return file_scan(schema, files, fmt, [files[i:i + per] for i in range(0, len(files), per)],
                     filters)


def run_q42_files(paths: dict, device="cuda", conf: dict | None = None,
                  stats: dict | None = None, fact_fmt: str = "parquet") -> dict:
    """q42-class from files (``paths``: directories by table name, the fact
    in ``fact_fmt``): one task reads every fact file; {brand, rev}."""
    scans = {"q42_fact": _fact_files_scan(STORE_SALES_SCHEMA, paths["store_sales"], 1,
                                          fact_fmt),
             "q42_item": file_scan(ITEM_SCHEMA, part_files(paths["item"]))}
    (out,) = run_converted(q42_host_plan(scans), {}, 1, device,
                           {**FILE_CONF, **(conf or {})}, stats)
    return {"brand": out["brand"], "rev": out["rev"]}


def run_q93_files(paths: dict, n_map: int = 4, n_reduce: int = 4, device="cuda",
                  conf: dict | None = None, stats: dict | None = None,
                  work_dir: str | None = None) -> dict:
    """q93-class from Parquet files: a map task per fact file group, each
    reduce task reads the customer file for its broadcast."""
    stats = stats if stats is not None else {}
    scans = {"q93_fact": _fact_files_scan(STORE_SALES_SCHEMA, paths["store_sales"], n_map),
             "q93_cust": file_scan(CUSTOMER_SCHEMA, part_files(paths["customer"]))}
    outs = run_converted(q93_host_plan(n_reduce, scans), {}, n_map, device,
                         {**FILE_CONF, **(conf or {})}, stats, work_dir)
    stats["partition_rows"] = [int(o["rows"].sum()) if o else 0 for o in outs]
    return _q93_by_key(outs)


def month_filter(data: TpcdsData, moy: int = 11) -> dict:
    """A pushed filter on ``ss_sold_date_sk`` (column 0 of the sorted files)
    that holds exactly the dates of month ``moy``: an OR of one closed
    date_sk range per year."""
    dd = data.date_dim.columns
    ranges = []
    for year in np.unique(dd["d_year"]):
        sk = dd["d_date_sk"][(dd["d_year"] == year) & (dd["d_moy"] == moy)]
        if len(sk):
            assert sk.max() - sk.min() + 1 == len(sk), "the month's dates are not contiguous"
            ranges.append(_hcall("and",
                                 _hcall("greaterthanorequal", _hattr(0, "ss_sold_date_sk"),
                                        _hlit(int(sk.min()), "long")),
                                 _hcall("lessthanorequal", _hattr(0, "ss_sold_date_sk"),
                                        _hlit(int(sk.max()), "long"))))
    out = ranges[0]
    for r in ranges[1:]:
        out = _hcall("or", out, r)
    return out


def run_q3_files(paths: dict, n_map: int = 4, n_reduce: int = 4, device="cuda",
                 conf: dict | None = None, stats: dict | None = None, limit: int = 100,
                 fact_schema: T.Schema = STORE_SALES_SCHEMA,
                 fact_filters: list | None = None) -> dict:
    """q3-class from Parquet files, as ``run_q3_converted`` answers it; the
    fact's files may hold any columns of it with date, item and price (the
    sorted files: ``RANGE_SORT_SCHEMA``), under ``fact_filters``."""
    scans = {"q3_fact": _fact_files_scan(fact_schema, paths["store_sales"], n_map,
                                   filters=fact_filters),
             "q3_dd": file_scan(DATE_DIM_SCHEMA, part_files(paths["date_dim"])),
             "q3_item": file_scan(ITEM_SCHEMA, part_files(paths["item"]))}
    outs = run_converted(q3_host_plan(n_reduce, scans=scans), {}, n_map, device,
                         {**FILE_CONF, **(conf or {})}, stats)
    got = _concat(outs, ["d_year", "i_brand_id", "s"], [np.int32, np.int32, np.float64])
    return _top_k(got["d_year"], got["i_brand_id"], got["s"], limit)


def table_mismatch(got, table: Table, drop: tuple = ()) -> str | None:
    """None when the pyarrow table ``got`` holds ``table``'s rows in order
    (its columns but ``drop``; NULLs where ``table`` has them), else what
    differs."""
    names = [n for n in table.schema.names if n not in drop]
    if got.column_names != names:
        return f"columns {got.column_names}, want {names}"
    if got.num_rows != len(table):
        return f"{got.num_rows} rows, want {len(table)}"
    for n in names:
        c = got.column(n)
        valid = table.validity(n)
        if not np.array_equal(c.is_valid().to_numpy(zero_copy_only=False), valid):
            return f"column {n}: NULLs differ"
        v = c.to_numpy(zero_copy_only=False)
        if not np.array_equal(v[valid], np.asarray(table.columns[n])[valid]):
            return f"column {n}: values differ"
    return None


# ---------------------------------------------------------------------------
# the customer-basket class: collect_set / collect_list, STRUCT and MAP
# ---------------------------------------------------------------------------

_LIST_I32 = T.DataType(T.TypeKind.LIST, inner=(T.INT32,))
#: named_struct('years', years, 'cats', cats)
BASKET_PROFILE = T.DataType(T.TypeKind.STRUCT, inner=(_LIST_I32, _LIST_I32),
                            struct_names=("years", "cats"))
_BASKET_AGGS = (("collect_set", "years"), ("collect_set", "cats"), ("collect_list", "singles"))
#: the dimension builds ``basket_map_plan``'s joins cache in the bridge's map
_BASKET_BUILDS = ("basket_dd_build", "basket_it_build")


def _fn(name: str, *args, out_dtype=None) -> ScalarFunc:
    return ScalarFunc(name, tuple(args), out_dtype)


def basket_map_plan():
    """Spark's profile-per-user pattern over the star schema, map side:
    store_sales JOIN date_dim JOIN item, partial collect_set(d_year) years,
    collect_set(i_category_id) cats, collect_list(CASE WHEN ss_quantity = 1
    THEN ss_item_sk END) singles by ss_customer_sk (the NULL customer one
    group), the dimension builds cached per executor."""
    scan = B.memory_scan(STORE_SALES_SCHEMA, "basket_fact")
    j1 = B.hash_join(scan, B.memory_scan(DATE_DIM_SCHEMA, "basket_dd"), [col(0)], [col(0)],
                     "inner", build_side="right", cached_build_id="basket_dd_build")
    # fact (5 columns) + date_dim (3): d_year at 6; + item (5): i_category_id at 10
    j2 = B.hash_join(j1, B.memory_scan(ITEM_SCHEMA, "basket_item"), [col(1)], [col(0)],
                     "inner", build_side="right", cached_build_id="basket_it_build")
    single = Case(((BinaryOp("eq", col(3), lit(1)), col(1)),), None)
    proj = B.project(j2, [(col(2), "ss_customer_sk"), (col(6), "d_year"),
                          (col(10), "i_category_id"), (single, "single")])
    return B.hash_agg(proj, [(col(0), "ss_customer_sk")],
                      [(f, col(i + 1), n) for i, (f, n) in enumerate(_BASKET_AGGS)], "partial")


def _basket_order():
    """ORDER BY element_at(sizes, 'singles') DESC, ss_customer_sk (NULL
    first), over the projected columns (key, profile, sizes, singles)."""
    return [(_fn("element_at", col(2), lit("singles")), SortSpec(asc=False)), (col(0), SortSpec())]


def basket_reduce_plan(read, limit: int = 100):
    """The final collects by ss_customer_sk over ``read``, then
    named_struct('years', years, 'cats', cats) profile,
    map_from_arrays(make_array('years', 'cats', 'singles'),
    make_array(array_size(years), array_size(cats), array_size(singles)))
    sizes and singles, each reduce task's top ``limit`` by ``_basket_order``
    (a SortExec with fetch)."""
    f = B.hash_agg(read, [(col(0), "ss_customer_sk")],
                   [(fn, col(i + 1), n) for i, (fn, n) in enumerate(_BASKET_AGGS)], "final")
    profile = _fn("named_struct", lit("years"), col(1), lit("cats"), col(2),
                  out_dtype=BASKET_PROFILE)
    sizes = _fn("map_from_arrays", _fn("make_array", lit("years"), lit("cats"), lit("singles")),
                _fn("make_array", *(_fn("array_size", col(i)) for i in (1, 2, 3))))
    proj = B.project(f, [(col(0), "ss_customer_sk"), (profile, "profile"), (sizes, "sizes"),
                         (col(3), "singles")])
    return B.sort(proj, _basket_order(), fetch=limit)


def basket_top_plan(schema: T.Schema, limit: int = 100):
    """The final merge of the reduce tasks' tops: one task, a SortExec with
    fetch over their batches (resource ``basket_top``)."""
    return B.sort(B.memory_scan(schema, "basket_top"), _basket_order(), fetch=limit)


def run_basket_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                     limit: int = 100, work_dir: str | None = None, device="cuda",
                     conf: dict | None = None, ingested: dict | None = None,
                     stats: dict | None = None):
    """The customer-basket class in two stages (``basket_map_plan`` over a
    file hash shuffle on ss_customer_sk, ``basket_reduce_plan`` per
    partition), then ``basket_top_plan`` over the reduce tasks' batches,
    every task from its ``TaskDefinition`` bytes. Returns the answer as a
    host Arrow batch (``Batch.to_host_arrow``: the C data interface's
    layout, STRUCT, MAP and LIST columns as ``+s``, ``+m``, ``+l``; its
    ``to_pydict()`` the rows). ``stats`` gets map_s, reduce_s, top_s,
    egress_s, shuffle_bytes and the tasks' timers (``add_timers``)."""
    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.columnar.batch import device_concat

    if ingested is None:
        ingested = ingest_q3(data, n_map, device)
    n_map = len(ingested["fact"])
    resources = {"basket_fact": ingested["fact"], "basket_dd": [ingested["dd"]] * n_map,
                 "basket_item": [ingested["item"]] * n_map}
    cfg = Configuration(conf or {})
    stats = stats if stats is not None else {}
    work = work_dir or tempfile.mkdtemp(prefix="auron_basket_")
    os.makedirs(work, exist_ok=True)
    try:
        with memory_scope(cfg, stats):
            t0 = time.perf_counter()
            m = basket_map_plan()
            read = _shuffle_stage(m, tree_from_plan(m).schema, [0], n_map, n_reduce, work,
                                  "basket_ex0", resources, 1, cfg, device, stats)
            _sync(device)
            t1 = time.perf_counter()
            reduce_plan = basket_reduce_plan(read, limit)
            tops = []
            for r in range(n_reduce):
                task = B.task(reduce_plan, 2, r, dict(cfg.items()))
                batches, metrics = run_task_bytes(task.SerializeToString(), resources, device)
                tops += batches
                add_timers(stats, metrics)
            _sync(device)
            t2 = time.perf_counter()
            schema = tree_from_plan(reduce_plan).schema
            task = B.task(basket_top_plan(schema, limit), 3, 0, dict(cfg.items()))
            out, metrics = run_task_bytes(task.SerializeToString(), {"basket_top": [tops]},
                                          device)
            add_timers(stats, metrics)
            t3 = time.perf_counter()
            answer = device_concat(out).to_host_arrow() if out else None
            t4 = time.perf_counter()
    finally:
        resources.pop("basket_ex0", None)
        for k in _BASKET_BUILDS:  # the bridge's map caches them for the run's tasks
            api.remove_resource(k)
        if work_dir is None:
            shutil.rmtree(work, ignore_errors=True)
    stats.update(map_s=t1 - t0, reduce_s=t2 - t1, top_s=t3 - t2, egress_s=t4 - t3)
    return answer


def basket_class_oracle(data: TpcdsData, limit: int = 100) -> dict:
    """The basket class's answer in numpy on the host: groups by customer
    slot (key + 1; slot 0 the NULL customer), each set as the (customer,
    value) pairs present, ordered by the text of the values as the
    reference orders a collect_set, each list in input order, the top
    ``limit`` by (singles DESC, customer NULL first). {column: list}."""
    ss, dd, it = data.store_sales.columns, data.date_dim.columns, data.item.columns
    drow, dhit = _lookup(dd["d_date_sk"], ss["ss_sold_date_sk"])
    irow, ihit = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    hit = dhit & ihit
    valid = data.store_sales.validity("ss_customer_sk")[hit]
    slot = np.where(valid, ss["ss_customer_sk"][hit] + 1, 0)
    n_slots = int(slot.max()) + 1 if len(slot) else 1
    present = np.bincount(slot, minlength=n_slots) > 0

    def presence(values):
        uniq, idx = np.unique(values, return_inverse=True)
        pres = np.zeros((n_slots, len(uniq)), dtype=bool)
        pres[slot, idx.reshape(-1)] = True
        return uniq, pres

    years, pres_y = presence(dd["d_year"][drow[hit]])
    cats, pres_c = presence(it["i_category_id"][irow[hit]])
    one = ss["ss_quantity"][hit] == 1
    s_slot, s_item = slot[one], ss["ss_item_sk"][hit][one]
    n_singles = np.bincount(s_slot, minlength=n_slots)
    groups = np.flatnonzero(present)
    top = groups[np.lexsort((groups, -n_singles[groups]))][:limit]
    by_slot = np.argsort(s_slot, kind="stable")
    starts = np.searchsorted(s_slot[by_slot], top)
    out: dict = {"ss_customer_sk": [], "profile": [], "sizes": [], "singles": []}
    for s, a in zip(top.tolist(), starts.tolist()):
        ys = sorted(years[pres_y[s]].tolist(), key=str)
        cs = sorted(cats[pres_c[s]].tolist(), key=str)
        singles = s_item[by_slot[a: a + n_singles[s]]].tolist()
        out["ss_customer_sk"].append(s - 1 if s else None)
        out["profile"].append({"years": ys, "cats": cs})
        out["sizes"].append([("years", len(ys)), ("cats", len(cs)), ("singles", len(singles))])
        out["singles"].append(singles)
    return out


def basket_mismatch(got: dict, want: dict) -> str | None:
    """None when the basket answer ``got`` ({column: rows}) equals the
    oracle's: keys, struct fields, map entries and every collect_set
    exactly, in order; every collect_list as a multiset (the reference
    pins no order across a shuffle); else what differs."""
    if list(got) != list(want):
        return f"columns {list(got)}, want {list(want)}"
    for name in ("ss_customer_sk", "profile", "sizes"):
        if got[name] != want[name]:
            bad = next(i for i, (g, w) in enumerate(zip(got[name], want[name])) if g != w) \
                if len(got[name]) == len(want[name]) else None
            return f"{name} differs (row {bad}, {len(got[name])} rows, want {len(want[name])})"
    for i, (g, w) in enumerate(zip(got["singles"], want["singles"])):
        if sorted(g) != sorted(w):
            return f"singles of row {i} differ as multisets"
    return None


# ---------------------------------------------------------------------------
# the host-callback class: Spark plans with UDF, UDAF and UDTF fallbacks
# ---------------------------------------------------------------------------

#: the names ``run_udf_class`` registers with the bridge (``bridge/udf.py``)
UDF_NET = "udf_class_net_price"  # scalar UDF: 0.9 x price, through pyarrow.compute
UDF_GEO = "udf_class_geomean"  # UDAF accumulator: the geometric mean
UDF_NGRAMS = "udf_class_brand_ngrams"  # UDTF: the digit bigrams of a brand id
#: the Hive UDF's serialized function: the brand's thousands ("brand-1003")
HIVE_BLOB = b"brand-thousands"
UDF_MOY = 11  # q42's month filter


def _net_price(args, n):
    import pyarrow.compute as pc

    return pc.multiply(args[0], 0.9)


def _geo_init():
    return (0.0, 0)


def _geo_update(st, v):
    import math

    return (st[0] + math.log(v), st[1] + 1)


def _geo_merge(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _geo_finish(st):
    import math

    return math.exp(st[0] / st[1]) if st[1] else None


def _bigrams(v):
    s = str(v)
    return [(s[i:i + 2],) for i in range(len(s) - 1)]


def register_udf_class() -> None:
    """Register the class's UDF, UDAF and UDTF with the port's bridge."""
    from auron_tpu_torch.bridge import udf

    udf.register_udf(UDF_NET, _net_price)
    udf.register_udaf_accumulator(UDF_GEO, init=_geo_init, update=_geo_update,
                                  merge=_geo_merge, finish=_geo_finish, out_dtype=T.FLOAT64)
    udf.register_udtf(UDF_NGRAMS, _bigrams, T.Schema((T.Field("gram", T.STRING, True),)))


_HIVE_KEEP: dict = {}  # the evaluator and its last result stay alive for the C caller


def hive_evaluator():
    """The host's Hive-UDF evaluator, an ``auron_udf_eval_fn`` (a ctypes
    callback): it reads the argument columns and writes the result column
    with the port's own Arrow IPC (no pyarrow), evaluating the blob's
    function, ``brand-<id // 1000>`` of an int brand id."""
    import ctypes

    from auron_tpu_torch.bridge.udf import _EVAL_FN
    from auron_tpu_torch.columnar import arrow_ipc
    from auron_tpu_torch.columnar.arrow_c import HostBatch, array_from_pylist

    if "fn" in _HIVE_KEEP:
        return _HIVE_KEEP["fn"]

    def evaluate(blob_ptr, blob_len, args_ptr, args_len, out_ptr, out_len):
        if ctypes.string_at(blob_ptr, blob_len) != HIVE_BLOB:
            return 2
        (hb,) = arrow_ipc.read_stream(ctypes.string_at(args_ptr, args_len))
        vals = [None if v is None else f"brand-{v // 1000}" for v in hb.columns[0].to_pylist()]
        out = arrow_ipc.write_stream([HostBatch(T.Schema((T.Field("r", T.STRING, True),)),
                                                len(vals), (array_from_pylist(vals, T.STRING),))])
        buf = (ctypes.c_uint8 * len(out)).from_buffer_copy(out)
        _HIVE_KEEP["buf"] = buf
        out_ptr[0] = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
        out_len[0] = len(out)
        return 0

    _HIVE_KEEP["fn"] = _EVAL_FN(evaluate)
    return _HIVE_KEEP["fn"]


def install_hive_evaluator(device="cuda", via: str = "library") -> int:
    """Install ``hive_evaluator`` as the host's UDF callback: through the
    port's C library (``auron_register_udf_callback``, which answers 0) or
    straight through ``bridge.api``. Returns the C entry's answer (0)."""
    import ctypes

    ptr = ctypes.cast(hive_evaluator(), ctypes.c_void_p).value
    if via == "library":
        from auron_tpu_torch.bridge.host import CLibrary

        lib = CLibrary(device)._lib
        lib.auron_register_udf_callback.argtypes = [ctypes.c_void_p]
        rc = lib.auron_register_udf_callback(ptr)
        if rc != 0:
            raise RuntimeError(f"auron_register_udf_callback answered {rc}")
        return rc
    from auron_tpu_torch.bridge import api

    api.install_udf_callback(ptr)
    return 0


def udf_q42_host_plan() -> dict:
    """q42's host plan with its price column through the registered Python
    UDF (``UDF_NET``): the converter wraps the call as ``host_udf``."""
    j = _hbhj(_hscan(STORE_SALES_SCHEMA, "q42_fact"), _hscan(ITEM_SCHEMA, "q42_item"), 1, 0)
    pr = _hnode("ProjectExec", [["brand", "int", True], ["p", "double", True]],
                {"projections": [_hattr(6, "i_brand_id"),
                                 _hcall(UDF_NET, _hattr(4, "ss_ext_sales_price"),
                                        type="double")]}, j)
    out = [["brand", "int", True], ["rev", "double", True]]
    p = _hagg(pr, "partial", out, [(_hattr(0), "brand")], [("sum", _hattr(1), "rev")])
    f = _hagg(p, "final", out, [(_hattr(0), "brand")], [("sum", _hattr(1), "rev")])
    return _hnode("TakeOrderedAndProjectExec", out,
                  {"limit": 10, "order": _horder((1, False, False), (0, True, True)),
                   "projections": [_hattr(0, "brand"), _hattr(1, "rev")]}, f)


def hive_brand_host_plan() -> dict:
    """SELECT hive_brand(i_brand_id) label, count(*) n FROM item GROUP BY
    label: a Hive UDF (``__hive_udf__``, its function serialized in the
    plan) the converter wraps as ``host_udf``."""
    import base64

    pr = _hnode("ProjectExec", [["label", "string", True]],
                {"projections": [_hcall("__hive_udf__", _hattr(1, "i_brand_id"), type="string",
                                        udf_blob=base64.b64encode(HIVE_BLOB).decode())]},
                _hscan(ITEM_SCHEMA, "udf_item"))
    out = [["label", "string", True], ["n", "long", False]]
    p = _hagg(pr, "partial", out, [(_hattr(0), "label")], [("count_star", None, "n")])
    return _hagg(p, "final", out, [(_hattr(0), "label")], [("count_star", None, "n")])


def udf_geo_map_tree():
    """fact JOIN date_dim (d_moy = 11) JOIN item, the partial geometric-mean
    UDAF of the price by i_category (pickled accumulator states)."""
    from auron_tpu_torch.exec.agg_exec import AggExpr

    dd = _filter(_dd(), BinaryOp("eq", col(2), lit(UDF_MOY)))
    j = _bhj(_bhj(_fact(), dd, [col(0)], [col(0)]), _item(), [col(1)], [col(0)])
    pr = _project(j, (col(11), "i_category"), (col(4), "price"))
    return _partial(pr, [(col(0), "i_category")],
                    [(AggExpr("host_udaf", col(1), udaf=UDF_GEO), "g")])


def udf_ngram_tree():
    """The bigram UDTF over item's brand ids, counted by gram."""
    from auron_tpu_torch.exec.generate_exec import GenerateExec

    g = GenerateExec(_scan(ITEM_SCHEMA, "udf_item"), "host_udtf", col(1), [], udtf=UDF_NGRAMS)
    return _agg2(g, [(col(0), "gram")], _aggs(("count_star", None, "n")))


def run_udf_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                  device="cuda", conf: dict | None = None, ingested: dict | None = None,
                  stats: dict | None = None, install: str = "library",
                  work_dir: str | None = None) -> dict:
    """The four host-callback paths, each from the entry points a Spark host
    uses: ``net_q42`` (q42's converted host plan with ``UDF_NET`` in its
    projection: {brand, rev}); ``hive`` (a Hive UDF over the brand ids
    through the C callback, ``install_hive_evaluator(device, install)``:
    {label, n}); ``geo`` (the geometric-mean UDAF by i_category over q42's
    month, ``n_map`` x ``n_reduce`` over the file shuffle of its pickled
    states: {i_category, g}); ``ngrams`` (the bigram UDTF over the brand
    ids: {gram, n}). ``stats`` gets each path's wall (``walls``), the host
    callbacks' calls, rows and seconds (``udf``), the C entry's answer
    (``register_rc``), and under each path's name its runner's stats (the
    timers and counters of ``add_timers``)."""
    from auron_tpu_torch.bridge import udf

    register_udf_class()
    stats = stats if stats is not None else {}
    conf = dict(conf or {})
    if ingested is None:
        ingested = ingest_q3(data, n_map, device)
    before = udf.stats()
    walls = stats.setdefault("walls", {})
    out = {}

    t0 = time.perf_counter()
    from auron_tpu_torch.convert.converters import convert_plan
    from auron_tpu_torch.convert.service import _response

    resp = _response(convert_plan(udf_q42_host_plan(), udf_registry={UDF_NET: _net_price}))
    (q42,) = run_converted(None, {"q42_fact": [sum(ingested["fact"], [])],
                                  "q42_item": [ingested["item"]]}, 1, device, conf,
                           stats.setdefault("net_q42", {}), response=resp)
    out["net_q42"] = {"brand": q42["brand"], "rev": q42["rev"]}
    walls["net_q42"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stats["register_rc"] = install_hive_evaluator(device, install)
    (hive,) = run_converted(hive_brand_host_plan(), {"udf_item": [ingested["item"]]}, 1,
                            device, conf, stats.setdefault("hive", {}))
    out["hive"] = _sorted_by({"label": np.asarray(hive["label"]).astype(str), "n": hive["n"]},
                             ["label"])
    walls["hive"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    k = len(ingested["fact"])
    resources = {"fact": ingested["fact"], "dd": [ingested["dd"]] * k,
                 "item": [ingested["item"]] * k}
    tree = udf_geo_map_tree()
    keys = [(col(0), "i_category")]
    from auron_tpu_torch.exec.agg_exec import AggExpr

    outs = _run_stages([_shuffle_one(tree, [0], k, "udf_geo")],
                       lambda r: _final(r, keys, [(AggExpr("host_udaf", col(1), udaf=UDF_GEO),
                                                   "g")]),
                       resources, n_reduce, "udf_geo", work_dir, Configuration(conf), device,
                       stats.setdefault("geo", {}))
    geo = _concat(outs, ["i_category", "g"], [object, np.float64])
    geo["i_category"] = geo["i_category"].astype(str)
    out["geo"] = _sorted_by(geo, ["i_category"])
    walls["geo"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ng = _answer(_tasks(udf_ngram_tree(), {"udf_item": [ingested["item"]]}, 1, conf, device,
                        stats.setdefault("ngrams", {})), ["gram", "n"], [object, np.int64])
    ng["gram"] = ng["gram"].astype(str)
    out["ngrams"] = _sorted_by(ng, ["gram"])
    walls["ngrams"] = time.perf_counter() - t0

    after = udf.stats()
    stats["udf"] = {k_: after[k_] - before[k_] for k_ in after}
    return out


def udf_class_oracle(data: TpcdsData) -> dict:
    """The four answers of ``run_udf_class`` in numpy."""
    ss, it, dd = data.store_sales.columns, data.item.columns, data.date_dim.columns
    row, hit = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    brand = it["i_brand_id"][row[hit]]
    uniq, inv = np.unique(brand, return_inverse=True)
    rev = np.bincount(inv.reshape(-1), weights=ss["ss_ext_sales_price"][hit] * 0.9,
                      minlength=len(uniq))
    top = np.lexsort((uniq, -rev))[:10]
    labels = np.array([f"brand-{b // 1000}" for b in it["i_brand_id"].tolist()], dtype=object)
    lu, ln = np.unique(labels, return_counts=True)
    drow, dhit = _lookup(dd["d_date_sk"], ss["ss_sold_date_sk"])
    sel = hit & dhit
    sel[sel] = dd["d_moy"][drow[sel]] == UDF_MOY
    cats = it["i_category"][row[sel]]
    logs = np.log(ss["ss_ext_sales_price"][sel])
    cu, cinv = np.unique(cats.astype(str), return_inverse=True)
    g = np.exp(np.bincount(cinv, weights=logs, minlength=len(cu))
               / np.bincount(cinv, minlength=len(cu)))
    grams = [s[i:i + 2] for s in map(str, it["i_brand_id"].tolist()) for i in range(len(s) - 1)]
    gu, gn = np.unique(np.array(grams, dtype=str), return_counts=True)
    return {"net_q42": {"brand": uniq[top].astype(np.int32), "rev": rev[top]},
            "hive": {"label": lu.astype(str), "n": ln.astype(np.int64)},
            "geo": {"i_category": cu.astype(str), "g": g},
            "ngrams": {"gram": gu.astype(str), "n": gn.astype(np.int64)}}


def udf_mismatch(got: dict, want: dict) -> str | None:
    """None when ``run_udf_class``'s answers equal the oracle's: keys and
    counts exact, revenues and geometric means at rel 1e-9."""
    for part, cols in want.items():
        for name, w in cols.items():
            g = np.asarray(got[part][name])
            if len(g) != len(w):
                return f"{part}.{name}: {len(g)} rows, want {len(w)}"
            if w.dtype.kind == "f":
                if not np.allclose(g.astype(np.float64), w, rtol=1e-9, atol=0):
                    return f"{part}.{name} differs beyond rel 1e-9"
            elif g.tolist() != w.tolist():
                return f"{part}.{name} differs"
    return None
