"""TPC-DS catalog for the SQL frontend.

The synthetic star schema the plan-builder classes use (models/tpcds.py)
carries only the columns those hand-built pipelines touch. Real TPC-DS
query TEXTS reference the benchmark's real column names — so the SQL
gate binds against a WIDENED catalog: the same generated fact/dim rows
(same seed, same row counts — oracles stay consistent), enriched with
deterministically derived TPC-DS columns and a few small real dimensions
(store, customer, household_demographics, customer_demographics,
time_dim, promotion).

The enrichment never mutates ``TpcdsData``'s tables (hand-built
pipelines index those positionally); it builds copies. Column dtypes are
declared HERE (``TABLES``) and the tables are materialized to match, so
the binder's schema (incl. true nullability — ``ss_customer_sk`` is the
one nullable key) and the engine's scan schema cannot drift.

Port of ``auron_tpu/sql/catalog.py``. ``build_tables`` takes the port's
``TpcdsData`` and returns the port's ``Table``s (numpy columns plus
validity; a DATE32 column is int32 days since 1970-01-01) instead of
pandas frames, from the same rng calls, so every row equals the
reference's; ``ss_customer_sk``'s NULLs are in its validity where the
reference has ``pd.NA``. ``frames_of`` gives the reference's pandas frames
of them (pandas is imported there only).
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass

import numpy as np

from auron_tpu_torch import types as T
from auron_tpu_torch.models.tpcds import Table, TpcdsData

_EPOCH = _dt.date(1970, 1, 1)
_BASE_DATE = _dt.date(1998, 1, 1)

#: (name, dtype, nullable) per table — THE schema contract of the SQL
#: surface. Order matters: it is the scan column order.
TABLES: dict[str, tuple[tuple[str, T.DataType, bool], ...]] = {
    "store_sales": (
        ("ss_sold_date_sk", T.INT64, False),
        ("ss_item_sk", T.INT64, False),
        ("ss_customer_sk", T.INT64, True),
        ("ss_quantity", T.INT32, False),
        ("ss_ext_sales_price", T.FLOAT64, False),
        ("ss_store_sk", T.INT64, False),
        ("ss_sold_time_sk", T.INT64, False),
        ("ss_hdemo_sk", T.INT64, False),
        ("ss_cdemo_sk", T.INT64, False),
        ("ss_promo_sk", T.INT64, False),
        ("ss_ticket_number", T.INT64, False),
        ("ss_sales_price", T.FLOAT64, False),
        ("ss_list_price", T.FLOAT64, False),
        ("ss_coupon_amt", T.FLOAT64, False),
        ("ss_wholesale_cost", T.FLOAT64, False),
        ("ss_net_profit", T.FLOAT64, False),
        ("ss_addr_sk", T.INT64, False),
        ("ss_ext_list_price", T.FLOAT64, False),
        ("ss_ext_tax", T.FLOAT64, False),
    ),
    "date_dim": (
        ("d_date_sk", T.INT64, False),
        ("d_year", T.INT32, False),
        ("d_moy", T.INT32, False),
        ("d_date", T.DATE32, False),
        ("d_dom", T.INT32, False),
        ("d_qoy", T.INT32, False),
        ("d_day_name", T.STRING, False),
        ("d_month_seq", T.INT32, False),
        ("d_week_seq", T.INT32, False),
        ("d_dow", T.INT32, False),
    ),
    "item": (
        ("i_item_sk", T.INT64, False),
        ("i_brand_id", T.INT32, False),
        ("i_category_id", T.INT32, False),
        ("i_category", T.STRING, False),
        ("i_tags", T.STRING, False),
        ("i_item_id", T.STRING, False),
        ("i_item_desc", T.STRING, False),
        ("i_brand", T.STRING, False),
        ("i_class_id", T.INT32, False),
        ("i_class", T.STRING, False),
        ("i_manufact_id", T.INT32, False),
        ("i_manufact", T.STRING, False),
        ("i_manager_id", T.INT32, False),
        ("i_current_price", T.FLOAT64, False),
        ("i_wholesale_cost", T.FLOAT64, False),
    ),
    "store": (
        ("s_store_sk", T.INT64, False),
        ("s_store_id", T.STRING, False),
        ("s_store_name", T.STRING, False),
        ("s_number_employees", T.INT32, False),
        ("s_state", T.STRING, False),
        ("s_county", T.STRING, False),
        ("s_gmt_offset", T.FLOAT64, False),
        ("s_city", T.STRING, False),
        ("s_zip", T.STRING, False),
    ),
    "customer": (
        ("c_customer_sk", T.INT64, False),
        ("c_customer_id", T.STRING, False),
        ("c_salutation", T.STRING, False),
        ("c_first_name", T.STRING, False),
        ("c_last_name", T.STRING, False),
        ("c_preferred_cust_flag", T.STRING, False),
        ("c_birth_year", T.INT32, False),
        ("c_current_addr_sk", T.INT64, False),
    ),
    "household_demographics": (
        ("hd_demo_sk", T.INT64, False),
        ("hd_buy_potential", T.STRING, False),
        ("hd_dep_count", T.INT32, False),
        ("hd_vehicle_count", T.INT32, False),
    ),
    "customer_demographics": (
        ("cd_demo_sk", T.INT64, False),
        ("cd_gender", T.STRING, False),
        ("cd_marital_status", T.STRING, False),
        ("cd_education_status", T.STRING, False),
        ("cd_dep_count", T.INT32, False),
    ),
    "time_dim": (
        ("t_time_sk", T.INT64, False),
        ("t_hour", T.INT32, False),
        ("t_minute", T.INT32, False),
        ("t_meal_time", T.STRING, False),
    ),
    "promotion": (
        ("p_promo_sk", T.INT64, False),
        ("p_channel_email", T.STRING, False),
        ("p_channel_event", T.STRING, False),
    ),
    "customer_address": (
        ("ca_address_sk", T.INT64, False),
        ("ca_city", T.STRING, False),
        ("ca_county", T.STRING, False),
        ("ca_state", T.STRING, False),
        ("ca_zip", T.STRING, False),
        ("ca_country", T.STRING, False),
        ("ca_gmt_offset", T.FLOAT64, False),
    ),
}

N_HD = 720
N_CD = 1921
N_TIME = 86400
N_PROMO = 30
N_CUSTOMER = 100_000  # matches the generator's ss_customer_sk range
N_CA = 25_000
#: d_week_seq of the first generated day (1998-01-01); the real generator
#: counts weeks from 1900, which puts early 1998 at ~5112
WEEK_SEQ_BASE = 5112


def schema_of(table: str) -> T.Schema:
    return T.Schema(tuple(T.Field(n, d, nl) for n, d, nl in TABLES[table]))


@dataclass(frozen=True)
class Catalog:
    """Binder-side view: table -> schema + row-count estimate (the
    estimate only drives hash-join build-side selection)."""

    schemas: dict[str, T.Schema]
    row_counts: dict[str, int]

    def schema(self, name: str) -> T.Schema | None:
        return self.schemas.get(name.lower())

    def rows(self, name: str) -> int:
        return self.row_counts.get(name.lower(), 1000)


def tpcds_catalog(n_fact: int = 1 << 20) -> Catalog:
    """Catalog without data (binding / plan goldens): schemas are static,
    row estimates scale from the fact row count."""
    n_stores = _n_stores(n_fact / 2_880_000)
    counts = {
        "store_sales": n_fact,
        "date_dim": 365 * 5,
        "item": 18_000,
        "store": n_stores,
        "customer": N_CUSTOMER,
        "household_demographics": N_HD,
        "customer_demographics": N_CD,
        "time_dim": N_TIME,
        "promotion": N_PROMO,
        "customer_address": N_CA,
    }
    return Catalog({t: schema_of(t) for t in TABLES}, counts)


def _n_stores(sf: float) -> int:
    return max(3, int(12 * min(sf, 1.0)) or 3)


# ---------------------------------------------------------------------------
# table materialization
# ---------------------------------------------------------------------------


def build_tables(data: TpcdsData, seed: int = 42) -> dict[str, Table]:
    """Widened tables for the SQL gate, derived deterministically from the
    generated star schema + (seed, table) — the oracle and the engine read
    the SAME rows, so enrichment randomness cancels out of the diff."""
    sf = data.fact_rows() / 2_880_000
    cols: dict[str, tuple[dict, dict]] = {}
    cols["store_sales"] = _enrich_store_sales(data, seed, sf)
    cols["date_dim"] = _enrich_date_dim(data), {}
    cols["item"] = _enrich_item(data, seed), {}
    cols["store"] = _build_store(seed, sf), {}
    cols["customer"] = _build_customer(seed), {}
    cols["household_demographics"] = _build_hd(seed), {}
    cols["customer_demographics"] = _build_cd(seed), {}
    cols["time_dim"] = _build_time_dim(), {}
    cols["promotion"] = _build_promotion(seed), {}
    cols["customer_address"] = _build_customer_address(seed), {}
    out: dict[str, Table] = {}
    for name, (columns, valid) in cols.items():
        want = [n for n, _, _ in TABLES[name]]
        assert list(columns) == want, (name, list(columns))
        out[name] = Table(schema_of(name), columns, valid)
    return out


def frames_of(tables: dict[str, Table]) -> dict:
    """The reference's pandas frames of ``build_tables``' tables (what
    ``auron_tpu.sql.catalog.build_tables`` returns): strings as objects,
    DATE32 as ``datetime.date``, a column with NULLs as ``Int64`` with
    ``pd.NA``."""
    import pandas as pd

    out = {}
    for name, t in tables.items():
        cols = {}
        for f in t.schema:
            v = t.columns[f.name]
            if f.dtype.kind == T.TypeKind.DATE32:
                v = np.array([_EPOCH + _dt.timedelta(days=int(k)) for k in v], dtype=object)
            elif f.dtype.kind == T.TypeKind.STRING:
                v = v.astype(object)
            if f.name in t.valid:
                s = pd.Series(v, dtype="Int64")
                s[~t.valid[f.name]] = pd.NA
                v = s
            cols[f.name] = v
        out[name] = pd.DataFrame(cols)
    return out


def _rng(seed: int, table: str) -> np.random.Generator:
    # zlib.crc32, not hash(): the builtin is salted per process and would
    # make "deterministic enrichment" a lie across runs
    import zlib

    return np.random.default_rng([seed, zlib.crc32(table.encode())])


def _enrich_store_sales(data: TpcdsData, seed: int, sf: float) -> tuple[dict, dict]:
    rng = _rng(seed, "store_sales")
    ss = data.store_sales.columns
    n = len(data.store_sales)
    qty = ss["ss_quantity"].astype(np.int64)
    ext = ss["ss_ext_sales_price"].astype(np.float64)
    sales_price = np.round(ext / np.maximum(qty, 1), 2)
    # Ticket (basket) structure like the real generator: variable-size
    # baskets of 1..7 rows sharing customer/date/store/hdemo/addr — the
    # per-ticket count queries (q34/q73/q79-class) are vacuous without
    # real baskets. This intentionally REPLACES the per-row
    # ss_customer_sk/ss_sold_date_sk of the seed table inside the widened
    # copy (same null fraction, same date pool); the SQL gate's oracles
    # read the same widened rows, so the diff is unaffected.
    tsize = (np.arange(n, dtype=np.int64) * 2654435761 % 7) + 1
    tid = np.repeat(np.arange(n, dtype=np.int64), tsize)[:n]
    n_t = int(tid[-1]) + 1 if n else 0
    t_customer = rng.integers(1, N_CUSTOMER + 1, n_t, dtype=np.int64)
    t_null = rng.random(n_t) < 0.04
    t_date = (rng.choice(data.date_dim.columns["d_date_sk"].astype(np.int64), n_t)
              if n_t else np.array([], np.int64))
    t_store = rng.integers(1, _n_stores(sf) + 1, n_t, dtype=np.int64)
    t_hd = rng.integers(1, N_HD + 1, n_t, dtype=np.int64)
    t_addr = rng.integers(1, N_CA + 1, n_t, dtype=np.int64)
    customer_valid = ~t_null[tid] if n else np.zeros(0, bool)
    customer = np.where(customer_valid, t_customer[tid], 0) if n else np.zeros(0, np.int64)
    columns = {
        "ss_sold_date_sk": t_date[tid] if n else np.array([], np.int64),
        "ss_item_sk": ss["ss_item_sk"].astype(np.int64),
        "ss_customer_sk": customer.astype(np.int64),
        "ss_quantity": ss["ss_quantity"].astype(np.int32),
        "ss_ext_sales_price": ext,
        "ss_store_sk": t_store[tid] if n else np.array([], np.int64),
        "ss_sold_time_sk": rng.integers(0, N_TIME, n, dtype=np.int64),
        "ss_hdemo_sk": t_hd[tid] if n else np.array([], np.int64),
        "ss_cdemo_sk": rng.integers(1, N_CD + 1, n, dtype=np.int64),
        "ss_promo_sk": rng.integers(1, N_PROMO + 1, n, dtype=np.int64),
        "ss_ticket_number": tid + 1,
        "ss_sales_price": sales_price,
        "ss_list_price": np.round(sales_price * rng.uniform(1.0, 1.5, n), 2),
        "ss_coupon_amt": np.round(
            np.where(rng.random(n) < 0.2, rng.uniform(0.5, 30.0, n), 0.0), 2
        ),
        "ss_wholesale_cost": np.round(sales_price * rng.uniform(0.4, 0.9, n), 2),
        "ss_net_profit": np.round(ext * rng.uniform(-0.2, 0.4, n), 2),
        "ss_addr_sk": t_addr[tid] if n else np.array([], np.int64),
        "ss_ext_list_price": np.round(
            sales_price * rng.uniform(1.0, 1.5, n) * np.maximum(qty, 1), 2
        ),
        "ss_ext_tax": np.round(ext * rng.uniform(0.0, 0.09, n), 2),
    }
    return columns, {"ss_customer_sk": customer_valid}


def _enrich_date_dim(data: TpcdsData) -> dict:
    dd = data.date_dim.columns
    i = np.arange(len(data.date_dim))
    moy = dd["d_moy"].astype(np.int32)
    names = np.array(["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                      "Friday", "Saturday"], dtype=object)
    return {
        "d_date_sk": dd["d_date_sk"].astype(np.int64),
        "d_year": dd["d_year"].astype(np.int32),
        "d_moy": moy,
        "d_date": ((_BASE_DATE - _EPOCH).days + i).astype(np.int32),
        "d_dom": ((i % 365) % 31 + 1).astype(np.int32),
        "d_qoy": ((moy - 1) // 3 + 1).astype(np.int32),
        "d_day_name": names[i % 7],
        "d_month_seq": (
            (dd["d_year"].astype(np.int64) - 1900) * 12 + moy - 1
        ).astype(np.int32),
        "d_week_seq": (WEEK_SEQ_BASE + i // 7).astype(np.int32),
        "d_dow": (i % 7).astype(np.int32),
    }


def _enrich_item(data: TpcdsData, seed: int) -> dict:
    rng = _rng(seed, "item")
    it = data.item.columns
    n = len(data.item)
    sk = it["i_item_sk"].astype(np.int64)
    brand_id = it["i_brand_id"].astype(np.int64)
    class_id = rng.integers(1, 17, n).astype(np.int32)
    manufact_id = rng.integers(1, 1001, n).astype(np.int32)
    manager_id = rng.integers(1, 101, n).astype(np.int32)
    return {
        "i_item_sk": sk,
        "i_brand_id": it["i_brand_id"].astype(np.int32),
        "i_category_id": it["i_category_id"].astype(np.int32),
        "i_category": it["i_category"].astype(object),
        "i_tags": it["i_tags"].astype(object),
        "i_item_id": np.array([f"AAAAAAAA{k:08d}" for k in sk], dtype=object),
        # unique per item: ORDER BY ... LIMIT boundaries tie-break on
        # it in several queries (q65) — a shared desc could leave the
        # boundary tie class ambiguous
        "i_item_desc": np.array(
            [f"item description {k:06d}" for k in sk], dtype=object
        ),
        # a pure function of brand_id: GROUP BY (i_brand_id, i_brand)
        # has exactly brand_id's cardinality, like the real generator
        "i_brand": np.array(
            [f"corpbrand #{b % 1000}" for b in brand_id], dtype=object
        ),
        "i_class_id": class_id,
        "i_class": np.array([f"class{c:02d}" for c in class_id], dtype=object),
        "i_manufact_id": manufact_id,
        "i_manufact": np.array(
            [f"manufact#{m}" for m in manufact_id], dtype=object
        ),
        "i_manager_id": manager_id,
        "i_current_price": np.round(rng.uniform(0.5, 99.0, n), 2),
        "i_wholesale_cost": np.round(rng.uniform(0.3, 70.0, n), 2),
    }


def _build_store(seed: int, sf: float) -> dict:
    rng = _rng(seed, "store")
    n = _n_stores(sf)
    names = np.array(["ought", "able", "ese", "anti", "cally", "ation", "eing",
                      "bar"], dtype=object)
    counties = np.array(["Williamson County", "Ziebach County", "Walker County",
                         "Daviess County", "Barrow County"], dtype=object)
    sk = np.arange(1, n + 1, dtype=np.int64)
    return {
        "s_store_sk": sk,
        "s_store_id": np.array([f"S{k:010d}" for k in sk], dtype=object),
        "s_store_name": names[(sk - 1) % len(names)],
        "s_number_employees": rng.integers(200, 301, n).astype(np.int32),
        "s_state": rng.choice(["TN", "SD", "SC", "KY", "OH"], n).astype(object),
        "s_county": counties[(sk - 1) % len(counties)],
        "s_gmt_offset": rng.choice([-5.0, -6.0], n),
        "s_city": _CITY_POOL[(sk - 1) % len(_CITY_POOL)],
        "s_zip": np.array([f"{28000 + 137 * k % 70000:05d}" for k in sk],
                          dtype=object),
    }


def _build_customer(seed: int) -> dict:
    rng = _rng(seed, "customer")
    n = N_CUSTOMER
    sk = np.arange(1, n + 1, dtype=np.int64)
    # wide pools (10 x 50 numbered variants): q68-style ORDER BY
    # (c_last_name, ticket) LIMIT boundaries must not tie across
    # customers that differ in other output columns
    first = np.array([f"{b}{i:02d}" for b in
                      ("James", "Mary", "John", "Linda", "Robert", "Ann",
                       "Michael", "Susan", "David", "Karen")
                      for i in range(50)], dtype=object)
    last = np.array([f"{b}{i:02d}" for b in
                     ("Smith", "Jones", "Brown", "White", "Green", "Hall",
                      "Clark", "Lewis", "Young", "King")
                     for i in range(50)], dtype=object)
    return {
        "c_customer_sk": sk,
        "c_customer_id": np.array([f"C{k:015d}" for k in sk], dtype=object),
        "c_salutation": rng.choice(["Mr.", "Mrs.", "Ms.", "Dr."], n).astype(object),
        "c_first_name": first[rng.integers(0, len(first), n)],
        "c_last_name": last[rng.integers(0, len(last), n)],
        "c_preferred_cust_flag": rng.choice(["Y", "N"], n).astype(object),
        "c_birth_year": rng.integers(1930, 1996, n).astype(np.int32),
        "c_current_addr_sk": rng.integers(1, N_CA + 1, n, dtype=np.int64),
    }


def _build_hd(seed: int) -> dict:
    rng = _rng(seed, "household_demographics")
    sk = np.arange(1, N_HD + 1, dtype=np.int64)
    pots = np.array(["0-500", "501-1000", "1001-5000", "5001-10000", ">10000",
                     "Unknown"], dtype=object)
    return {
        "hd_demo_sk": sk,
        "hd_buy_potential": pots[(sk - 1) % len(pots)],
        "hd_dep_count": rng.integers(0, 10, N_HD).astype(np.int32),
        "hd_vehicle_count": rng.integers(-1, 5, N_HD).astype(np.int32),
    }


def _build_cd(seed: int) -> dict:
    rng = _rng(seed, "customer_demographics")
    sk = np.arange(1, N_CD + 1, dtype=np.int64)
    return {
        "cd_demo_sk": sk,
        "cd_gender": rng.choice(["M", "F"], N_CD).astype(object),
        "cd_marital_status": rng.choice(["M", "S", "D", "W", "U"], N_CD).astype(object),
        "cd_education_status": rng.choice(
            ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"], N_CD).astype(object),
        "cd_dep_count": rng.integers(0, 7, N_CD).astype(np.int32),
    }


def _build_time_dim() -> dict:
    sk = np.arange(N_TIME, dtype=np.int64)
    hour = (sk // 3600).astype(np.int32)
    meal = np.where(hour < 9, "breakfast",
                    np.where(hour < 14, "lunch",
                             np.where(hour < 21, "dinner", "night")))
    return {
        "t_time_sk": sk,
        "t_hour": hour,
        "t_minute": ((sk % 3600) // 60).astype(np.int32),
        "t_meal_time": meal.astype(object),
    }


def _build_promotion(seed: int) -> dict:
    rng = _rng(seed, "promotion")
    sk = np.arange(1, N_PROMO + 1, dtype=np.int64)
    return {
        "p_promo_sk": sk,
        "p_channel_email": rng.choice(["Y", "N"], N_PROMO).astype(object),
        "p_channel_event": rng.choice(["Y", "N"], N_PROMO).astype(object),
    }


_CITY_POOL = np.array(["Midway", "Fairview", "Oak Grove", "Salem", "Glendale",
                       "Riverside", "Centerville", "Pleasant Hill"], dtype=object)


def _build_customer_address(seed: int) -> dict:
    rng = _rng(seed, "customer_address")
    sk = np.arange(1, N_CA + 1, dtype=np.int64)
    counties = np.array(["Williamson County", "Ziebach County", "Walker County",
                         "Daviess County", "Barrow County"], dtype=object)
    return {
        "ca_address_sk": sk,
        "ca_city": _CITY_POOL[rng.integers(0, len(_CITY_POOL), N_CA)],
        "ca_county": counties[rng.integers(0, len(counties), N_CA)],
        "ca_state": rng.choice(["TN", "SD", "SC", "KY", "OH", "TX", "GA"],
                               N_CA).astype(object),
        "ca_zip": np.array(
            [f"{28000 + 137 * k % 70000:05d}" for k in sk], dtype=object
        ),
        "ca_country": np.array(["United States"] * N_CA, dtype=object),
        "ca_gmt_offset": rng.choice([-5.0, -6.0], N_CA),
    }
