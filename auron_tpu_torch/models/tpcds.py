"""TPC-DS-class data and the q42-class pipeline (port of the parts of
``auron_tpu/models/tpcds.py`` this slice needs).

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
- ``q42_class_oracle``: the same answer in plain numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exprs.ir import col
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
                  ingested: dict | None = None) -> dict[str, np.ndarray]:
    """The q42-class query through the task runtime; returns {brand, rev}."""
    from auron_tpu_torch.runtime.task import TaskRuntime

    if ingested is None:
        ingested = ingest_q42(data, device)
    rt = TaskRuntime(q42_exec_tree(), resources=dict(ingested),
                     conf=Configuration(conf or {}), device=device)
    try:
        out = collect(list(rt))
    finally:
        rt.finalize()
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
