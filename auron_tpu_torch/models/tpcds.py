"""TPC-DS-class data and query pipelines (port of the parts of
``auron_tpu/models/tpcds.py`` the ported slices need).

- ``generate(sf, seed)``: the synthetic star schema as numpy columns,
  bit-identical to ``auron_tpu.models.tpcds.generate`` for the same
  ``sf``/``seed`` (same ``numpy.random.default_rng`` call sequence; no
  pandas);
- ``to_batches``: per-partition device batch lists (``1 << 20`` rows per
  batch by default, as in the JAX package);
- ``q42_exec_tree``: the operator tree ``planner.task_from_proto`` builds
  for the q42-class plan after column pruning, built without protobuf;
- ``run_q42_class``: star join + group-by + ORDER BY revenue DESC LIMIT 10
  (TakeOrdered), through the task runtime;
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
  single-task collect stage (``SortExec`` fetch 100 -> ``LimitExec``).

Map tasks run one after another (the JAX package runs them on threads).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exprs.ir import col, lit
from auron_tpu_torch.ops.sortkeys import SortSpec
from auron_tpu_torch.utils.config import Configuration


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


def q42_exec_tree():
    """SELECT i_brand_id brand, sum(ss_ext_sales_price) rev FROM store_sales
    JOIN item ON ss_item_sk = i_item_sk GROUP BY brand ORDER BY rev DESC,
    brand LIMIT 10 — the tree the planner builds from the q42-class plan
    proto after column pruning (join projection [price, brand])."""
    from auron_tpu_torch.exec.agg_exec import AggExpr, HashAggExec
    from auron_tpu_torch.exec.basic import ProjectExec, ResourceScanExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec
    from auron_tpu_torch.exec.sort_exec import SortExec

    fact = ResourceScanExec(STORE_SALES_SCHEMA, "q42_fact")
    item = ResourceScanExec(ITEM_SCHEMA, "q42_item")
    j = BroadcastHashJoinExec(fact, item, [col(1)], [col(0)], "inner",
                              build_side="right", projection=[4, 6])
    pr = ProjectExec(j, [col(1), col(0)], ["brand", "p"])
    agg = [(AggExpr("sum", col(1)), "rev")]
    p = HashAggExec(pr, [(col(0), "brand")], agg, "partial")
    f = HashAggExec(p, [(col(0), "brand")], agg, "final")
    return SortExec(f, [col(1), col(0)], [SortSpec(asc=False), SortSpec()], fetch=10)


def ingest_q42(data: TpcdsData, device="cuda", batch_rows: int = 1 << 20) -> dict:
    """Device-resident inputs of the q42 task (resource id -> partitions)."""
    return {
        "q42_fact": to_batches(data.store_sales, 1, batch_rows, device),
        "q42_item": to_batches(data.item, 1, batch_rows, device),
    }


def collect(batches: list[Batch]) -> dict[str, np.ndarray]:
    """Live rows of output batches as host columns (NULLs -> validity)."""
    cols: dict[str, list] = {}
    for b in batches:
        for name, (v, _m) in b.to_numpy().items():
            cols.setdefault(name, []).append(v)
    return {k: np.concatenate(v) for k, v in cols.items()}


def run_q42_class(data: TpcdsData | None = None, device="cuda", conf: dict | None = None,
                  ingested: dict | None = None, stats: dict | None = None) -> dict[str, np.ndarray]:
    """The q42-class query through the task runtime; returns {brand, rev}.
    ``stats`` gets the metric tree's host timers (``add_timers``)."""
    from auron_tpu_torch.runtime.task import TaskRuntime

    if ingested is None:
        ingested = ingest_q42(data, device)
    rt = TaskRuntime(q42_exec_tree(), resources=dict(ingested),
                     conf=Configuration(conf or {}), device=device)
    try:
        out = collect(list(rt))
    finally:
        snapshot = rt.finalize()
    if stats is not None:
        add_timers(stats, snapshot)
    return {"brand": out["brand"], "rev": out["rev"]}


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


def _shuffle_stage(plan, out_schema: T.Schema, key_cols: list[int], n_map: int, n_reduce: int,
                   work: str, rid: str, resources: dict, stage_id: int = 1,
                   conf: Configuration | None = None, device="cuda", stats: dict | None = None):
    """Run ``plan`` as ``n_map`` map tasks hash-shuffled on ``key_cols``
    into files under ``work``; registers the exchange's block provider as
    ``resources[rid]`` and returns the reduce side's reader node."""
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.exec.shuffle.reader import IpcReaderExec, MultiMapBlockProvider
    from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec
    from auron_tpu_torch.runtime.task import run_task

    part = HashPartitioning([col(c) for c in key_cols], n_reduce)
    pairs = []
    for p in range(n_map):
        d, i = os.path.join(work, f"{rid}_m{p}.data"), os.path.join(work, f"{rid}_m{p}.index")
        _, metrics = run_task(ShuffleWriterExec(plan, part, d, i), resources, stage_id, p,
                              conf, device)
        if stats is not None:
            stats["shuffle_bytes"] = stats.get("shuffle_bytes", 0) + metrics["values"]["data_size"]
            add_timers(stats, metrics)
        pairs.append((d, i))
    resources[rid] = MultiMapBlockProvider(pairs)
    return IpcReaderExec(out_schema, rid)


def add_timers(stats: dict, snapshot: dict) -> None:
    """Sum the metric tree's host timers (seconds) into ``stats["timers"]``,
    keyed operator.timer; timers nest (a parent's span covers the
    children it pulls from)."""
    timers = stats.setdefault("timers", {})
    op = snapshot["name"].split(".")[0]
    for k, v in snapshot["values"].items():
        if k.endswith(("_time", "elapsed_compute")):
            timers[f"{op}.{k}"] = timers.get(f"{op}.{k}", 0.0) + v / 1e9
    for c in snapshot["children"]:
        add_timers(stats, c)


def _run_two_stage(map_plan, out_schema, key_cols, reduce_plan_of, resources, n_map, n_reduce,
                   rid, work_dir, conf, device, stats) -> list[dict]:
    """Map stage, then one reduce task per partition; returns the reduce
    tasks' outputs as host columns. ``stats`` gets the stage walls."""
    from auron_tpu_torch.runtime.task import run_task

    work = work_dir or tempfile.mkdtemp(prefix=f"auron_{rid}_")
    os.makedirs(work, exist_ok=True)
    stats = stats if stats is not None else {}
    try:
        t0 = time.perf_counter()
        read = _shuffle_stage(map_plan, out_schema, key_cols, n_map, n_reduce, work, rid,
                              resources, 1, conf, device, stats)
        _sync(device)
        t1 = time.perf_counter()
        reduce_plan = reduce_plan_of(read)
        outs = []
        for r in range(n_reduce):
            batches, metrics = run_task(reduce_plan, resources, 2, r, conf, device)
            outs.append(collect(batches))
            add_timers(stats, metrics)
        _sync(device)
        stats["map_s"], stats["reduce_s"] = t1 - t0, time.perf_counter() - t1
        return outs
    finally:
        resources.pop(rid, None)
        if work_dir is None:
            shutil.rmtree(work, ignore_errors=True)


def _concat(outs: list[dict], names: list[str], dtypes: list) -> dict[str, np.ndarray]:
    return {n: np.concatenate([o[n] for o in outs if o] or [np.empty(0, dt)])
            for n, dt in zip(names, dtypes)}


# ---------------------------------------------------------------------------
# q93-class: null-skew left join across a hash shuffle
# ---------------------------------------------------------------------------

CUSTOMER_SCHEMA = _schema(("c_customer_sk", T.INT64), ("c_band", T.INT64))
Q93_INTER_SCHEMA = _schema(("k", T.INT64), ("price", T.FLOAT64))


def ingest_q93(data: TpcdsData, n_map: int, device="cuda", fact=None) -> dict:
    """Device-resident inputs: the fact table in ``n_map`` partitions and
    the 5,000-row customer dimension."""
    sk = np.arange(1, 5001, dtype=np.int64)
    cust = Table(CUSTOMER_SCHEMA, {"c_customer_sk": sk, "c_band": sk % 5}, {})
    return {"fact": fact if fact is not None else to_batches(data.store_sales, n_map,
                                                              device=device),
            "cust": to_batches(cust, 1, device=device)[0]}


def q93_map_tree():
    """SELECT CASE WHEN ss_quantity < 85 THEN NULL ELSE ss_customer_sk END k,
    ss_ext_sales_price price FROM store_sales: ~85 % of the keys are NULL."""
    from auron_tpu_torch.exec.basic import ProjectExec, ResourceScanExec
    from auron_tpu_torch.exprs.ir import BinaryOp, If, Literal

    key = If(BinaryOp("lt", col(3), Literal(85, T.INT32)), Literal(None, T.INT64), col(2))
    return ProjectExec(ResourceScanExec(STORE_SALES_SCHEMA, "q93_fact"), [key, col(4)],
                       ["k", "price"])


def q93_reduce_tree(read):
    """read LEFT JOIN customer ON k = c_customer_sk, grouped by k IS NULL:
    count(*) rows, count(c_customer_sk) matched, sum(price) s."""
    from auron_tpu_torch.exec.agg_exec import AggExpr, HashAggExec
    from auron_tpu_torch.exec.basic import ResourceScanExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec
    from auron_tpu_torch.exprs.ir import IsNull

    j = BroadcastHashJoinExec(read, ResourceScanExec(CUSTOMER_SCHEMA, "q93_cust"), [col(0)],
                              [col(0)], "left", build_side="right", projection=[0, 1, 2])
    p = HashAggExec(j, [(IsNull(col(0)), "k_null")],
                    [(AggExpr("count_star"), "rows"), (AggExpr("count", col(2)), "matched"),
                     (AggExpr("sum", col(1)), "s")], "partial")
    return HashAggExec(p, [(col(0), "k_null")],
                       [(AggExpr("count_star"), "rows"), (AggExpr("count", col(1)), "matched"),
                        (AggExpr("sum", col(2)), "s")], "final")


def run_q93_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                  work_dir: str | None = None, device="cuda", conf: dict | None = None,
                  ingested: dict | None = None, stats: dict | None = None) -> dict:
    """The q93-class query in two stages; returns {k_null, rows, matched, s}
    sorted by k_null. ``stats`` (optional) gets map_s, reduce_s,
    shuffle_bytes, the NULL keys' partition and rows per reduce partition."""
    if ingested is None:
        ingested = ingest_q93(data, n_map, device)
    n_map = len(ingested["fact"])
    resources = {"q93_fact": ingested["fact"], "q93_cust": [ingested["cust"]] * n_reduce}
    stats = stats if stats is not None else {}
    outs = _run_two_stage(q93_map_tree(), Q93_INTER_SCHEMA, [0], q93_reduce_tree, resources,
                          n_map, n_reduce, "q93_ex0", work_dir, Configuration(conf or {}),
                          device, stats)
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
# q3-class: the flagship join + shuffle + agg + top-k pipeline
# ---------------------------------------------------------------------------


def ingest_q3(data: TpcdsData, n_map: int, device="cuda", fact=None) -> dict:
    """Device-resident inputs: the fact table in ``n_map`` partitions and
    one batch per dimension."""
    return {"fact": fact if fact is not None else to_batches(data.store_sales, n_map,
                                                              device=device),
            "dd": to_batches(data.date_dim, 1, device=device)[0],
            "item": to_batches(data.item, 1, device=device)[0]}


def q3_map_tree(moy: int = 11, category_id: int = 1):
    """store_sales JOIN date_dim (d_moy = moy) JOIN item (i_category_id =
    cat), partial sum(price) by (d_year, i_brand_id): the tree the planner
    builds from the pruned q3 map plan (the joins' projections keep
    (ss_item_sk, price, d_year), then (price, d_year, i_brand_id), and the
    plan's projection reorders them)."""
    from auron_tpu_torch.exec.agg_exec import AggExpr, HashAggExec
    from auron_tpu_torch.exec.basic import FilterExec, ProjectExec, ResourceScanExec
    from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec
    from auron_tpu_torch.exprs.ir import BinaryOp

    scan = ResourceScanExec(STORE_SALES_SCHEMA, "q3_fact")
    dscan = FilterExec(ResourceScanExec(DATE_DIM_SCHEMA, "q3_dd"),
                       [BinaryOp("eq", col(2), lit(moy))])
    iscan = FilterExec(ResourceScanExec(ITEM_SCHEMA, "q3_item"),
                       [BinaryOp("eq", col(2), lit(category_id))])
    j1 = BroadcastHashJoinExec(scan, dscan, [col(0)], [col(0)], "inner", build_side="right",
                               cached_build_id="q3_dd_build", projection=[1, 4, 6])
    j2 = BroadcastHashJoinExec(j1, iscan, [col(0)], [col(0)], "inner", build_side="right",
                               cached_build_id="q3_it_build", projection=[1, 2, 4])
    proj = ProjectExec(j2, [col(1), col(2), col(0)], ["d_year", "i_brand_id", "price"])
    return HashAggExec(proj, [(col(0), "d_year"), (col(1), "i_brand_id")],
                       [(AggExpr("sum", col(2)), "s")], "partial")


def q3_reduce_tree(read):
    from auron_tpu_torch.exec.agg_exec import AggExpr, HashAggExec

    return HashAggExec(read, [(col(0), "d_year"), (col(1), "i_brand_id")],
                       [(AggExpr("sum", col(2)), "s")], "final")


def _top_k(d_year, brand, s, limit: int) -> dict[str, np.ndarray]:
    """ORDER BY d_year, s DESC LIMIT k (ties by brand), the driver's
    takeOrdered."""
    top = np.lexsort((brand, -s, d_year))[:limit]
    return {"d_year": d_year[top].astype(np.int32), "i_brand_id": brand[top].astype(np.int32),
            "s": s[top]}


def run_q3_class(data: TpcdsData | None = None, n_map: int = 4, n_reduce: int = 4,
                 moy: int = 11, category_id: int = 1, limit: int = 100,
                 work_dir: str | None = None, device="cuda", conf: dict | None = None,
                 ingested: dict | None = None, stats: dict | None = None) -> dict:
    """SELECT d_year, i_brand_id, sum(ss_ext_sales_price) s FROM store_sales
    JOIN date_dim ON ss_sold_date_sk = d_date_sk JOIN item ON ss_item_sk =
    i_item_sk WHERE d_moy = <moy> AND i_category_id = <cat> GROUP BY d_year,
    i_brand_id ORDER BY d_year, s DESC LIMIT <k>, in two stages."""
    if ingested is None:
        ingested = ingest_q3(data, n_map, device)
    n_map = len(ingested["fact"])
    resources = {"q3_fact": ingested["fact"], "q3_dd": [ingested["dd"]] * n_map,
                 "q3_item": [ingested["item"]] * n_map}
    partial = q3_map_tree(moy, category_id)
    outs = _run_two_stage(partial, partial.schema, [0, 1], q3_reduce_tree, resources, n_map,
                          n_reduce, "q3_blocks", work_dir, Configuration(conf or {}), device,
                          stats)
    got = _concat(outs, ["d_year", "i_brand_id", "s"], [np.int32, np.int32, np.float64])
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
    ss, dd, it = data.store_sales.columns, data.date_dim.columns, data.item.columns
    dm = dd["d_moy"] == moy
    im = it["i_category_id"] == category_id
    drow, dhit = _lookup(dd["d_date_sk"][dm], ss["ss_sold_date_sk"])
    irow, ihit = _lookup(it["i_item_sk"][im], ss["ss_item_sk"])
    hit = dhit & ihit
    year = dd["d_year"][dm][drow[hit]].astype(np.int64)
    brand = it["i_brand_id"][im][irow[hit]].astype(np.int64)
    uniq, inv = np.unique(np.stack([year, brand], 1), axis=0, return_inverse=True)
    s = np.bincount(inv.reshape(-1), weights=ss["ss_ext_sales_price"][hit],
                    minlength=len(uniq))
    return _top_k(uniq[:, 0], uniq[:, 1], s, limit)


# ---------------------------------------------------------------------------
# the same queries through the planned-exchange driver (one plan, P logical
# partitions on one device)
# ---------------------------------------------------------------------------


def q93_mesh_tree(n_parts: int = 4):
    """q93's map tree -> mesh exchange hashed on k -> q93's reduce tree: the
    tree ``plan_from_proto(prune_columns(proto))`` builds from the q93 plan
    with a ``mesh_exchange`` node."""
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.parallel.mesh_driver import MeshExchangeExec

    ex = MeshExchangeExec(q93_map_tree(), HashPartitioning([col(0)], n_parts), "q93_ex0")
    return q93_reduce_tree(ex)


def q3_mesh_tree(n_parts: int = 4, moy: int = 11, category_id: int = 1):
    """q3's partial aggregate -> mesh exchange hashed on (d_year,
    i_brand_id) -> final aggregate."""
    from auron_tpu_torch.exec.shuffle.partitioning import HashPartitioning
    from auron_tpu_torch.parallel.mesh_driver import MeshExchangeExec

    ex = MeshExchangeExec(q3_map_tree(moy, category_id),
                          HashPartitioning([col(0), col(1)], n_parts), "q3_ex0")
    return q3_reduce_tree(ex)


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
        (ex,) = driver.stats
        stats.update({
            "mode": ex.mode, "routing": ex.rows.tolist(), "slot_cap": ex.slot_cap,
            "est_bytes_per_shard": ex.est_bytes_per_shard,
            "coalesced_groups": ex.coalesced_groups,
            "map_s": driver.walls[f"{ex.exchange_id}.map_s"],
            "exchange_s": driver.walls[f"{ex.exchange_id}.exchange_s"],
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
