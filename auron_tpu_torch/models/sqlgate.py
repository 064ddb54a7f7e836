"""Real-text SQL differential gate (auron-it QueryRunner analog).

Port of ``auron_tpu/models/sqlgate.py``. The gate runs actual TPC-DS SQL
texts end to end: parse -> bind -> lower (``auron_tpu_torch/sql/``) ->
``MeshQueryDriver`` for the distributed stage (real exchanges, AQE) ->
one collect task from ``TaskDefinition`` bytes -> row-level comparison
against an independently hand-written pandas oracle over the SAME
catalog rows, plus a plan-stability golden per query
(``tests/goldens/sql/<name>.txt``, the reference's own files, rendered by
``plan/explain.explain_proto``).

Corpus: ``CASES`` holds the supported queries — verbatim dsdgen
store-channel texts where the catalog carries the columns (q3, q7, q19,
q34, ...; predicates use our data's parameter values, which is exactly
how dsqgen parameterizes the templates), plus store-channel adaptations
(suffix ``a``) of the multi-channel gate classes (q5/q14/q18/q72/q93/
q95-style shapes). ``UNSUPPORTED`` holds real texts whose first
construct is outside the subset — the gate asserts each raises a
positioned SqlUnsupported, never a wrong result. The texts and oracles
are the reference's, verbatim.

LIMIT queries compare against a tie-safe oracle head: the oracle sorts
by the query's ORDER BY columns and the gate REFUSES (authoring error)
if the boundary tie class is not row-identical — a silently
nondeterministic top-k can't hide as a pass.

Differences from the reference: the engine reads the port's ``Table``s
(``sql/catalog.build_tables``) as per-partition device batches on the
run's device (``cuda`` unless the caller passes ``device="cpu"``); the
oracles read their pandas frames (``catalog.frames_of``); pandas is
imported at first use only. ``run_gate`` can run a warm-up and several
timed runs of each query and records, per run, the wall, the driver's
stage walls and exchange statistics, the rows the exchanges routed, peak
device memory and the kernels' launches. It writes a golden only when
asked to update (a missing golden is drift). Each case runs as its own
``obs.query_trace`` (its spans and events attribute to it, its summary
lands in the ``/queries`` ring), and the record carries its trace id.

Run ``python -m auron_tpu_torch.models.sqlgate`` for the gate at
``sql.gate.sf`` on the card (``AURON_SQL_GATE_DEVICE=cpu`` for the CPU).
"""

from __future__ import annotations

import datetime as _dt
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from auron_tpu_torch.models import tpcds
from auron_tpu_torch.models.compare import compare_frames
from auron_tpu_torch.plan.explain import explain_proto
from auron_tpu_torch.sql import compile_text, tpcds_catalog
from auron_tpu_torch.sql.catalog import build_tables, frames_of
from auron_tpu_torch.sql.lowering import STAGE_RID, LoweredQuery
from auron_tpu_torch.utils.config import (
    SQL_GATE_FLOAT_REL,
    SQL_GATE_SF,
    SQL_SHUFFLE_PARTITIONS,
    Configuration,
)


class _Pandas:
    """pandas, imported at its first use: the oracles below keep the
    reference's text (``pd.DataFrame``, ``pd.concat``), and importing this
    module loads no pandas."""

    def __getattr__(self, name: str):
        import pandas

        return getattr(pandas, name)


pd = _Pandas()

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(REPO_ROOT, "tests", "goldens", "sql")

#: fact-table row estimate of the gate catalog, pinned at the canonical
#: SF=4 size REGARDLESS of the run's actual scale. Catalog estimates
#: drive the lowering's probe-seed choice, so letting them track the run
#: SF would flip plans between a toy run and a full-scale one (at toy
#: scale the fixed 86400-row time_dim outranks the scaled-down fact) and
#: break the plan-stability goldens. Stats are part of the SQL surface
#: contract, like the reference's plan-stability suites.
CANONICAL_FACT_ROWS = int(2_880_000 * 4)


def gate_catalog():
    """THE catalog every gate/test surface compiles against."""
    return tpcds_catalog(CANONICAL_FACT_ROWS)


# ---------------------------------------------------------------------------
# corpus plumbing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SqlCase:
    """One supported corpus query."""

    name: str
    sql: str
    oracle: Callable[[dict], "pd.DataFrame"]  # frames -> FULL result (unlimited)
    verbatim: bool                 # True = real dsdgen store-channel text
    order: tuple = ()              # oracle column names of ORDER BY keys
    ascending: tuple = ()          # per-key ascending flags
    limit: Optional[int] = None


CASES: list[SqlCase] = []


def _case(name, sql, oracle, verbatim, order=(), ascending=None, limit=None):
    CASES.append(SqlCase(
        name, sql, oracle, verbatim, tuple(order),
        tuple(ascending if ascending is not None else [True] * len(order)),
        limit))


def case_by_name(name: str) -> SqlCase:
    for c in CASES:
        if c.name == name:
            return c
    raise KeyError(name)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


def plan_text(lq: LoweredQuery) -> str:
    """Golden rendering: both stages + the output schema."""
    parts = [explain_proto(lq.distributed)]
    if lq.collect is not None:
        parts.append("-- collect --")
        parts.append(explain_proto(lq.collect))
    parts.append("-- schema: "
                 + ", ".join(f"{f.name}:{f.dtype}" for f in lq.schema))
    return "\n".join(parts) + "\n"


def build_resources(lq: LoweredQuery, tables: dict, cache: dict,
                    device="cuda") -> dict:
    """Resource dict for MeshQueryDriver; batch lists cached per
    (rid, n_parts) so a gate run uploads each view once."""
    resources = {}
    for use in lq.tables:
        key = (use.rid, lq.n_parts)
        if key not in cache:
            t = tables[use.table]
            if use.replicated:
                cache[key] = [tpcds.to_batches(t, 1, device=device)[0]] * lq.n_parts
            else:
                cache[key] = tpcds.to_batches(t, lq.n_parts, device=device)
        resources[use.rid] = cache[key]
    return resources


def _frame(batches: list, lq: LoweredQuery) -> "pd.DataFrame":
    """The answer's live rows as one pandas frame (through Arrow, as the
    reference's ``Batch.to_pandas``), named by the query's output schema."""
    cols = list(lq.schema.names)
    dfs = [b.to_arrow().to_pandas() for b in batches]
    dfs = [d for d in dfs if len(d)]
    if dfs:
        out = pd.concat(dfs, ignore_index=True)
        out.columns = cols
    else:
        out = pd.DataFrame({c: [] for c in cols})
    return out


def execute(lq: LoweredQuery, tables: dict, mesh, conf: dict | None = None,
            cache: Optional[dict] = None, stats: Optional[dict] = None) -> "pd.DataFrame":
    """Run one lowered query: distributed stage on the mesh, optional
    single-task collect stage (from ``TaskDefinition`` bytes) over the
    gathered output. ``stats`` gets the driver's stage walls, its exchange
    statistics and the rows and bytes the exchanges routed."""
    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.parallel.mesh_driver import MeshQueryDriver
    from auron_tpu_torch.plan import builders as B

    cache = cache if cache is not None else {}
    resources = build_resources(lq, tables, cache, mesh.device)
    driver = MeshQueryDriver(mesh, conf=Configuration(conf or {}))
    outs = driver.run(lq.distributed, resources)
    batches = [b for part in outs for b in part]
    if stats is not None:
        stats["walls"] = dict(driver.walls)
        stats["exchanges"] = [{
            "id": ex.exchange_id, "mode": ex.mode, "routing": ex.rows.tolist(),
            "slot_cap": ex.slot_cap, "est_bytes_per_shard": ex.est_bytes_per_shard,
            "coalesced_groups": ex.coalesced_groups, "skew_tasks": ex.skew_tasks,
            "routed_bytes": ex.routed_bytes,
        } for ex in driver.stats]
        stats["shuffle_bytes"] = sum(ex.routed_bytes for ex in driver.stats)
    if lq.collect is not None:
        # the distributed stage is finished on the card before the
        # collect task starts (the reference's stage barrier)
        if mesh.device.type == "cuda":
            import torch

            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        task = B.task(lq.collect, conf=conf).SerializeToString()
        out = []
        with api.native_task(task, {STAGE_RID: [batches]}, str(mesh.device)) as h:
            while (b := api.next_batch(h)) is not None:
                out.append(b)
        batches = out
        if stats is not None:
            stats["walls"]["collect_s"] = time.perf_counter() - t0
    return _frame(batches, lq)


class TieError(AssertionError):
    """Authoring error: a LIMIT boundary tie class is not row-identical."""


def oracle_head(df: "pd.DataFrame", case: SqlCase) -> "pd.DataFrame":
    """The oracle's expected rows under ORDER BY ... LIMIT: tie-safe head
    (see module docstring). Without a limit, returns df unchanged (the
    comparator canonical-sorts both sides anyway)."""
    if case.limit is None or len(df) <= case.limit:
        return df.reset_index(drop=True)
    by = list(case.order)
    if df[by].isna().any().any():
        raise TieError(
            f"{case.name}: NULL in ORDER BY keys with an effective LIMIT — "
            "pandas cannot mirror per-key NULL ordering; adjust the query")
    full = df.sort_values(by, ascending=list(case.ascending),
                          kind="mergesort").reset_index(drop=True)
    head = full.iloc[:case.limit]
    boundary = full.iloc[case.limit - 1][by]
    # only a tie class that CROSSES the boundary makes the top-k
    # nondeterministic; a tie contained entirely in the head is fine
    if (full.iloc[case.limit][by] == boundary).all():
        tie = full[(full[by] == boundary).all(axis=1)]
        if len(tie.drop_duplicates()) > 1:
            raise TieError(
                f"{case.name}: non-identical rows tie at the LIMIT "
                "boundary — the top-k is nondeterministic; adjust the "
                "query parameters")
    return head


def oracle_answer(case: SqlCase, frames: dict) -> tuple:
    """(the oracle's expected rows, its seconds) of one case."""
    t0 = time.perf_counter()
    want = oracle_head(case.oracle(frames), case)
    return want, time.perf_counter() - t0


def check_golden(name: str, text: str, update: bool = False) -> Optional[str]:
    """Diff `text` against the stored golden; None = match, else message.
    Only ``update=True`` (re)writes the file; a missing golden is drift."""
    path = os.path.join(GOLDEN_DIR, f"{name}.txt")
    if update:
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        return None
    if not os.path.exists(path):
        return f"no golden at {path}"
    with open(path) as f:
        golden = f.read()
    if golden != text:
        return (f"plan drift vs {path}:\n--- golden ---\n{golden}"
                f"--- current ---\n{text}")
    return None


def _launches() -> dict:
    from auron_tpu_torch.ops import bitonic, partition_kernels

    return {**bitonic.LAUNCHES, **partition_kernels.LAUNCHES}


def _timed_run(lq: LoweredQuery, tables: dict, mesh, conf, cache: dict) -> tuple:
    """(answer, run record) of one execution: its wall (ending in the
    answer's host read), the driver's stage walls and exchange statistics,
    peak device memory and the kernels' launches in it."""
    import torch

    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    before = _launches()
    st: dict = {}
    t0 = time.perf_counter()
    got = execute(lq, tables, mesh, conf=conf, cache=cache, stats=st)
    st["engine_s"] = time.perf_counter() - t0
    st["launches"] = {k: v - before[k] for k, v in _launches().items()}
    st["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device) if on_card else None
    return got, st


def run_case(case: SqlCase, tables: dict, frames: dict, mesh, catalog, n_parts: int,
             cache: dict, float_rel: float, update_goldens: bool = False,
             conf: dict | None = None, runs: int = 1, warmup: bool = False,
             oracle: Optional[Callable[[], tuple]] = None) -> dict:
    """Compile, golden-check, execute (a warm-up when asked, then ``runs``
    timed runs) and diff one corpus query; every run's answer is held to
    the oracle. ``oracle`` gives (expected rows, seconds) precomputed."""
    rec = {"query": case.name, "verbatim": case.verbatim, "ok": False,
           "error": None, "rows": None, "compile_s": None, "engine_s": None,
           "oracle_s": None, "warm": None, "runs": []}
    try:
        from auron_tpu_torch import obs

        # each corpus query runs as its own query trace: parse/bind/lower
        # spans + the execution's task/op/read events attribute to it
        with obs.query_trace(f"sql.{case.name}", conf=Configuration(conf or {})) as qt:
            run_conf = qt.conf.as_dict() if qt.conf is not None else conf
            t0 = time.perf_counter()
            lq = compile_text(case.sql, catalog, n_parts=n_parts)
            rec["compile_s"] = time.perf_counter() - t0
            drift = check_golden(case.name, plan_text(lq), update=update_goldens)
            if drift:
                rec["error"] = drift
                # never ran: keep the aborted trace out of /queries
                qt.keep = False
                return rec
            answers = []
            if warmup:
                got, rec["warm"] = _timed_run(lq, tables, mesh, run_conf, cache)
                answers.append(got)
            for _ in range(runs):
                got, st = _timed_run(lq, tables, mesh, run_conf, cache)
                answers.append(got)
                rec["runs"].append(st)
        if qt.summary is not None:
            rec["obs"] = {"trace_id": qt.summary["trace_id"]}
            if obs.mode() == obs.MODE_TRACE:
                # event counters only accumulate under full trace mode
                rec["obs"].update({k: qt.summary[k] for k in
                                   ("host_syncs", "compiles", "spills")})
        rec["engine_s"] = [st["engine_s"] for st in rec["runs"]]
        want, rec["oracle_s"] = oracle() if oracle is not None else oracle_answer(case, frames)
        rec["rows"] = len(want)
        for got in answers:
            err = compare_frames(got, want, float_rel, sorted_rows=True)
            if err is not None:
                rec["error"] = err
                return rec
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 - gate records, caller decides
        rec["error"] = f"{type(e).__name__}: {e}"
    return rec


def run_unsupported(catalog) -> list[dict]:
    """Every out-of-subset text must raise a positioned SqlUnsupported."""
    from auron_tpu_torch.sql import SqlUnsupported

    out = []
    for name, (sql, construct) in UNSUPPORTED.items():
        rec = {"query": name, "ok": False, "error": None,
               "construct": construct}
        try:
            compile_text(sql, catalog)
            rec["error"] = "lowered without a diagnostic"
        except SqlUnsupported as e:
            if e.construct != construct:
                rec["error"] = f"construct {e.construct!r} != {construct!r}"
            elif e.pos.line < 1:
                rec["error"] = "diagnostic carries no source position"
            else:
                rec["ok"] = True
                rec["line"], rec["col"] = e.pos.line, e.pos.col
        except Exception as e:  # noqa: BLE001
            rec["error"] = f"{type(e).__name__}: {e}"
        out.append(rec)
    return out


def gate_tables(sf: float, seed: int = 42) -> dict:
    """The gate's catalog tables at ``sf`` (``build_tables`` over
    ``generate(sf, seed)``)."""
    return build_tables(tpcds.generate(sf=sf, seed=seed), seed=seed)


def run_gate(sf: Optional[float] = None, names: Optional[list[str]] = None,
             n_parts: Optional[int] = None, device="cuda", conf: dict | None = None,
             stats: Optional[dict] = None, update_goldens: bool = False,
             tables: Optional[dict] = None, frames: Optional[dict] = None,
             cache: Optional[dict] = None, runs: int = 1, warmup: bool = False,
             oracles: Optional[dict] = None) -> list[dict]:
    """Run the differential gate on ``device``; returns one record per
    query (``ok``, ``error``, ``rows``, ``compile_s``, ``engine_s`` of each
    timed run, ``oracle_s``, and per run in ``warm`` / ``runs``: stage
    walls, exchange statistics, ``shuffle_bytes``, ``peak_bytes``,
    ``launches``). ``tables``/``frames`` reuse a built catalog (else built
    from ``generate(sf, 42)``), ``cache`` its device batches across calls,
    ``oracles`` maps a name to a callable giving (expected rows, seconds).
    ``stats`` gets ``tables_s`` and ``frames_s`` when this call built them."""
    from auron_tpu_torch.parallel.mesh import make_mesh

    cfg = Configuration(conf or {})
    sf = sf if sf is not None else SQL_GATE_SF.get(cfg)
    n_parts = n_parts if n_parts is not None else SQL_SHUFFLE_PARTITIONS.get(cfg)
    float_rel = SQL_GATE_FLOAT_REL.get(cfg)
    catalog = gate_catalog()
    mesh = make_mesh(n_parts, device)
    if tables is None:
        t0 = time.perf_counter()
        tables = gate_tables(sf)
        if stats is not None:
            stats["tables_s"] = time.perf_counter() - t0
    if frames is None:
        t0 = time.perf_counter()
        frames = frames_of(tables)
        if stats is not None:
            stats["frames_s"] = time.perf_counter() - t0
    cache = cache if cache is not None else {}
    cases = CASES if names is None else [case_by_name(n) for n in names]
    return [run_case(case, tables, frames, mesh, catalog, n_parts, cache, float_rel,
                     update_goldens=update_goldens, conf=conf, runs=runs, warmup=warmup,
                     oracle=(oracles or {}).get(case.name))
            for case in cases]


def main() -> None:
    import json
    import sys

    sf = float(os.environ.get("AURON_SQL_GATE_SF", "0") or 0) or None
    names = [n for n in os.environ.get("AURON_SQL_GATE_QUERIES", "").split(",")
             if n] or None
    update = os.environ.get("AURON_SQL_UPDATE_GOLDENS") == "1"
    device = os.environ.get("AURON_SQL_GATE_DEVICE", "cuda")
    recs = run_gate(sf=sf, names=names, device=device, update_goldens=update)
    bad = 0
    for r in recs:
        print(json.dumps({k: r[k] for k in ("query", "ok", "error", "rows", "compile_s",
                                            "engine_s", "oracle_s")}), flush=True)
        bad += not r["ok"]
    urecs = run_unsupported(gate_catalog())
    for r in urecs:
        print(json.dumps(r), flush=True)
        bad += not r["ok"]
    print(json.dumps({"metric": "sqlgate", "queries": len(recs),
                      "passed": sum(r["ok"] for r in recs),
                      "unsupported": len(urecs),
                      "unsupported_ok": sum(r["ok"] for r in urecs)}),
          flush=True)
    if bad:
        sys.exit(1)


# ---------------------------------------------------------------------------
# oracle helpers
# ---------------------------------------------------------------------------


def _m(left, right, lk, rk):
    return left.merge(right, left_on=lk, right_on=rk)


def _gsum(s: pd.Series):
    """SQL SUM: empty/all-null -> NULL (min_count keeps pandas honest)."""
    return s.sum(min_count=1)


# ---------------------------------------------------------------------------
# verbatim dsdgen store-channel texts
# ---------------------------------------------------------------------------

_Q3 = """
select dt.d_year
      ,item.i_brand_id brand_id
      ,item.i_brand brand
      ,sum(ss_ext_sales_price) sum_agg
 from date_dim dt
     ,store_sales
     ,item
 where dt.d_date_sk = store_sales.ss_sold_date_sk
   and store_sales.ss_item_sk = item.i_item_sk
   and item.i_manufact_id = 128
   and dt.d_moy = 11
 group by dt.d_year
         ,item.i_brand_id
         ,item.i_brand
 order by dt.d_year
         ,sum_agg desc
         ,brand_id
 limit 100
"""


def _o_q3(t):
    m = _m(t["date_dim"][t["date_dim"].d_moy == 11], t["store_sales"],
           "d_date_sk", "ss_sold_date_sk")
    m = _m(m, t["item"][t["item"].i_manufact_id == 128],
           "ss_item_sk", "i_item_sk")
    g = (m.groupby(["d_year", "i_brand_id", "i_brand"], as_index=False)
          .agg(sum_agg=("ss_ext_sales_price", "sum")))
    return g.rename(columns={"i_brand_id": "brand_id", "i_brand": "brand"})


_case("q3", _Q3, _o_q3, True,
      order=("d_year", "sum_agg", "brand_id"),
      ascending=(True, False, True), limit=100)

_Q7 = """
select i_item_id,
       avg(ss_quantity) agg1,
       avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3,
       avg(ss_sales_price) agg4
 from store_sales, customer_demographics, date_dim, item, promotion
 where ss_sold_date_sk = d_date_sk and
       ss_item_sk = i_item_sk and
       ss_cdemo_sk = cd_demo_sk and
       ss_promo_sk = p_promo_sk and
       cd_gender = 'M' and
       cd_marital_status = 'S' and
       cd_education_status = 'College' and
       (p_channel_email = 'N' or p_channel_event = 'N') and
       d_year = 2000
 group by i_item_id
 order by i_item_id
 limit 100
"""


def _o_q7(t):
    cd = t["customer_demographics"]
    cd = cd[(cd.cd_gender == "M") & (cd.cd_marital_status == "S")
            & (cd.cd_education_status == "College")]
    p = t["promotion"]
    p = p[(p.p_channel_email == "N") | (p.p_channel_event == "N")]
    m = _m(t["store_sales"], cd, "ss_cdemo_sk", "cd_demo_sk")
    m = _m(m, t["date_dim"][t["date_dim"].d_year == 2000],
           "ss_sold_date_sk", "d_date_sk")
    m = _m(m, t["item"], "ss_item_sk", "i_item_sk")
    m = _m(m, p, "ss_promo_sk", "p_promo_sk")
    return (m.groupby("i_item_id", as_index=False)
             .agg(agg1=("ss_quantity", "mean"), agg2=("ss_list_price", "mean"),
                  agg3=("ss_coupon_amt", "mean"),
                  agg4=("ss_sales_price", "mean")))


_case("q7", _Q7, _o_q7, True, order=("i_item_id",), limit=100)

_Q19 = """
select i_brand_id brand_id, i_brand brand, i_manufact_id, i_manufact,
       sum(ss_ext_sales_price) ext_price
 from date_dim, store_sales, item, customer, customer_address, store
 where d_date_sk = ss_sold_date_sk
   and ss_item_sk = i_item_sk
   and i_manager_id = 8
   and d_moy = 11
   and d_year = 1998
   and ss_customer_sk = c_customer_sk
   and c_current_addr_sk = ca_address_sk
   and substr(ca_zip,1,5) <> substr(s_zip,1,5)
   and ss_store_sk = s_store_sk
 group by i_brand, i_brand_id, i_manufact_id, i_manufact
 order by ext_price desc, brand, brand_id, i_manufact_id, i_manufact
 limit 100
"""


def _o_q19(t):
    dd = t["date_dim"]
    m = _m(dd[(dd.d_moy == 11) & (dd.d_year == 1998)], t["store_sales"],
           "d_date_sk", "ss_sold_date_sk")
    m = _m(m, t["item"][t["item"].i_manager_id == 8],
           "ss_item_sk", "i_item_sk")
    m = _m(m, t["customer"], "ss_customer_sk", "c_customer_sk")
    m = _m(m, t["customer_address"], "c_current_addr_sk", "ca_address_sk")
    m = _m(m, t["store"], "ss_store_sk", "s_store_sk")
    m = m[m.ca_zip.str[:5] != m.s_zip.str[:5]]
    g = (m.groupby(["i_brand", "i_brand_id", "i_manufact_id", "i_manufact"],
                   as_index=False)
          .agg(ext_price=("ss_ext_sales_price", "sum")))
    return g.rename(columns={"i_brand_id": "brand_id", "i_brand": "brand"})


_case("q19", _Q19, _o_q19, True,
      order=("ext_price", "brand", "brand_id", "i_manufact_id", "i_manufact"),
      ascending=(False, True, True, True, True), limit=100)

_Q34 = """
select c_last_name
      ,c_first_name
      ,c_salutation
      ,c_preferred_cust_flag
      ,ss_ticket_number
      ,cnt from
  (select ss_ticket_number
         ,ss_customer_sk
         ,count(*) cnt
   from store_sales,date_dim,store,household_demographics
   where store_sales.ss_sold_date_sk = date_dim.d_date_sk
   and store_sales.ss_store_sk = store.s_store_sk
   and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
   and (date_dim.d_dom between 1 and 3 or date_dim.d_dom between 25 and 28)
   and (household_demographics.hd_buy_potential = '>10000'
        or household_demographics.hd_buy_potential = 'Unknown')
   and household_demographics.hd_vehicle_count > 0
   and (case when household_demographics.hd_vehicle_count > 0
             then household_demographics.hd_dep_count /
                  household_demographics.hd_vehicle_count
             else null end) > 1.2
   and date_dim.d_year in (1999,1999+1,1999+2)
   and store.s_county in ('Williamson County','Williamson County',
                          'Williamson County','Williamson County')
   group by ss_ticket_number,ss_customer_sk) dn,customer
 where ss_customer_sk = c_customer_sk
   and cnt between 5 and 7
 order by c_last_name,c_first_name,c_salutation,c_preferred_cust_flag desc,
          ss_ticket_number
"""


def _dn_oracle(t, dom_mask_fn, hd_mask_fn, county_list, years,
               extra_ratio=None):
    dd = t["date_dim"]
    ddf = dd[dom_mask_fn(dd) & dd.d_year.isin(years)]
    st = t["store"][t["store"].s_county.isin(county_list)]
    hd = t["household_demographics"]
    hdf = hd[hd_mask_fn(hd)]
    if extra_ratio is not None:
        ratio = np.where(hdf.hd_vehicle_count > 0,
                         hdf.hd_dep_count / hdf.hd_vehicle_count.replace(0, 1),
                         np.nan)
        hdf = hdf[ratio > extra_ratio]
    m = _m(t["store_sales"], ddf, "ss_sold_date_sk", "d_date_sk")
    m = _m(m, st, "ss_store_sk", "s_store_sk")
    m = _m(m, hdf, "ss_hdemo_sk", "hd_demo_sk")
    return (m.groupby(["ss_ticket_number", "ss_customer_sk"], dropna=False,
                      as_index=False)
             .agg(cnt=("ss_ticket_number", "size")))


def _o_q34(t):
    dn = _dn_oracle(
        t, lambda d: d.d_dom.between(1, 3) | d.d_dom.between(25, 28),
        lambda h: (h.hd_buy_potential.isin([">10000", "Unknown"])
                   & (h.hd_vehicle_count > 0)),
        ["Williamson County"], [1999, 2000, 2001], extra_ratio=1.2)
    dn = dn[dn.cnt.between(5, 7)]
    out = _m(dn, t["customer"], "ss_customer_sk", "c_customer_sk")
    return out[["c_last_name", "c_first_name", "c_salutation",
                "c_preferred_cust_flag", "ss_ticket_number", "cnt"]]


_case("q34", _Q34, _o_q34, True)

_Q42 = """
select dt.d_year
      ,item.i_category_id
      ,item.i_category
      ,sum(ss_ext_sales_price)
 from date_dim dt
     ,store_sales
     ,item
 where dt.d_date_sk = store_sales.ss_sold_date_sk
   and store_sales.ss_item_sk = item.i_item_sk
   and item.i_manager_id = 1
   and dt.d_moy = 11
   and dt.d_year = 2000
 group by dt.d_year
         ,item.i_category_id
         ,item.i_category
 order by sum(ss_ext_sales_price) desc,dt.d_year
         ,item.i_category_id
         ,item.i_category
 limit 100
"""


def _o_q42(t):
    dd = t["date_dim"]
    m = _m(dd[(dd.d_moy == 11) & (dd.d_year == 2000)], t["store_sales"],
           "d_date_sk", "ss_sold_date_sk")
    m = _m(m, t["item"][t["item"].i_manager_id == 1],
           "ss_item_sk", "i_item_sk")
    return (m.groupby(["d_year", "i_category_id", "i_category"],
                      as_index=False)
             .agg(_c3=("ss_ext_sales_price", "sum")))


_case("q42", _Q42, _o_q42, True,
      order=("_c3", "d_year", "i_category_id", "i_category"),
      ascending=(False, True, True, True), limit=100)

_Q43 = """
select s_store_name, s_store_id,
        sum(case when (d_day_name='Sunday') then ss_sales_price else null end) sun_sales,
        sum(case when (d_day_name='Monday') then ss_sales_price else null end) mon_sales,
        sum(case when (d_day_name='Tuesday') then ss_sales_price else null end) tue_sales,
        sum(case when (d_day_name='Wednesday') then ss_sales_price else null end) wed_sales,
        sum(case when (d_day_name='Thursday') then ss_sales_price else null end) thu_sales,
        sum(case when (d_day_name='Friday') then ss_sales_price else null end) fri_sales,
        sum(case when (d_day_name='Saturday') then ss_sales_price else null end) sat_sales
 from date_dim, store_sales, store
 where d_date_sk = ss_sold_date_sk and
       s_store_sk = ss_store_sk and
       s_gmt_offset = -5 and
       d_year = 1998
 group by s_store_name, s_store_id
 order by s_store_name, s_store_id,sun_sales,mon_sales,tue_sales,wed_sales,
          thu_sales,fri_sales,sat_sales
 limit 100
"""

_DAYS = [("Sunday", "sun_sales"), ("Monday", "mon_sales"),
         ("Tuesday", "tue_sales"), ("Wednesday", "wed_sales"),
         ("Thursday", "thu_sales"), ("Friday", "fri_sales"),
         ("Saturday", "sat_sales")]


def _o_q43(t):
    dd = t["date_dim"]
    st = t["store"]
    m = _m(dd[dd.d_year == 1998], t["store_sales"],
           "d_date_sk", "ss_sold_date_sk")
    m = _m(m, st[st.s_gmt_offset == -5.0], "ss_store_sk", "s_store_sk")
    for day, col in _DAYS:
        m[col] = m.ss_sales_price.where(m.d_day_name == day)
    g = m.groupby(["s_store_name", "s_store_id"], as_index=False)
    return g[[c for _, c in _DAYS]].sum(min_count=1)


_case("q43", _Q43, _o_q43, True)

_Q46 = """
select c_last_name
      ,c_first_name
      ,ca_city
      ,bought_city
      ,ss_ticket_number
      ,amt,profit
 from
  (select ss_ticket_number
         ,ss_customer_sk
         ,ca_city bought_city
         ,sum(ss_coupon_amt) amt
         ,sum(ss_net_profit) profit
   from store_sales,date_dim,store,household_demographics,customer_address
   where store_sales.ss_sold_date_sk = date_dim.d_date_sk
   and store_sales.ss_store_sk = store.s_store_sk
   and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
   and store_sales.ss_addr_sk = customer_address.ca_address_sk
   and (household_demographics.hd_dep_count = 5 or
        household_demographics.hd_vehicle_count= 3)
   and date_dim.d_dow in (6,0)
   and store.s_city in ('Fairview','Midway','Fairview','Fairview','Fairview')
   group by ss_ticket_number,ss_customer_sk,ss_addr_sk,ca_city) dn,customer,customer_address current_addr
 where ss_customer_sk = c_customer_sk
   and customer.c_current_addr_sk = current_addr.ca_address_sk
   and current_addr.ca_city <> bought_city
 order by c_last_name
         ,c_first_name
         ,ca_city
         ,bought_city
         ,ss_ticket_number
 limit 100
"""


def _o_q46(t):
    dd = t["date_dim"]
    hd = t["household_demographics"]
    st = t["store"]
    m = _m(t["store_sales"], dd[dd.d_dow.isin([6, 0])],
           "ss_sold_date_sk", "d_date_sk")
    m = _m(m, st[st.s_city.isin(["Fairview", "Midway"])],
           "ss_store_sk", "s_store_sk")
    m = _m(m, hd[(hd.hd_dep_count == 5) | (hd.hd_vehicle_count == 3)],
           "ss_hdemo_sk", "hd_demo_sk")
    m = _m(m, t["customer_address"], "ss_addr_sk", "ca_address_sk")
    dn = (m.groupby(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                     "ca_city"], dropna=False, as_index=False)
           .agg(amt=("ss_coupon_amt", "sum"), profit=("ss_net_profit", "sum"))
           .rename(columns={"ca_city": "bought_city"}))
    out = _m(dn, t["customer"], "ss_customer_sk", "c_customer_sk")
    out = _m(out, t["customer_address"], "c_current_addr_sk", "ca_address_sk")
    out = out[out.ca_city != out.bought_city]
    return out[["c_last_name", "c_first_name", "ca_city", "bought_city",
                "ss_ticket_number", "amt", "profit"]]


_case("q46", _Q46, _o_q46, True,
      order=("c_last_name", "c_first_name", "ca_city", "bought_city",
             "ss_ticket_number"),
      limit=100)

_Q52 = """
select dt.d_year
      ,item.i_brand_id brand_id
      ,item.i_brand brand
      ,sum(ss_ext_sales_price) ext_price
 from date_dim dt
     ,store_sales
     ,item
 where dt.d_date_sk = store_sales.ss_sold_date_sk
    and store_sales.ss_item_sk = item.i_item_sk
    and item.i_manager_id = 1
    and dt.d_moy=11
    and dt.d_year=2000
 group by dt.d_year
         ,item.i_brand
         ,item.i_brand_id
 order by dt.d_year
         ,ext_price desc
         ,brand_id
 limit 100
"""


def _o_q52(t):
    dd = t["date_dim"]
    m = _m(dd[(dd.d_moy == 11) & (dd.d_year == 2000)], t["store_sales"],
           "d_date_sk", "ss_sold_date_sk")
    m = _m(m, t["item"][t["item"].i_manager_id == 1],
           "ss_item_sk", "i_item_sk")
    g = (m.groupby(["d_year", "i_brand", "i_brand_id"], as_index=False)
          .agg(ext_price=("ss_ext_sales_price", "sum")))
    return g.rename(columns={"i_brand_id": "brand_id", "i_brand": "brand"})


_case("q52", _Q52, _o_q52, True,
      order=("d_year", "ext_price", "brand_id"),
      ascending=(True, False, True), limit=100)

_Q55 = """
select i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
 from date_dim, store_sales, item
 where d_date_sk = ss_sold_date_sk
   and ss_item_sk = i_item_sk
   and i_manager_id = 28
   and d_moy = 11
   and d_year = 1999
 group by i_brand, i_brand_id
 order by ext_price desc, brand_id
 limit 100
"""


def _o_q55(t):
    dd = t["date_dim"]
    m = _m(dd[(dd.d_moy == 11) & (dd.d_year == 1999)], t["store_sales"],
           "d_date_sk", "ss_sold_date_sk")
    m = _m(m, t["item"][t["item"].i_manager_id == 28],
           "ss_item_sk", "i_item_sk")
    g = (m.groupby(["i_brand", "i_brand_id"], as_index=False)
          .agg(ext_price=("ss_ext_sales_price", "sum")))
    return g.rename(columns={"i_brand_id": "brand_id", "i_brand": "brand"})


_case("q55", _Q55, _o_q55, True,
      order=("ext_price", "brand_id"), ascending=(False, True), limit=100)

_Q59 = """
with wss as
 (select d_week_seq,
        ss_store_sk,
        sum(case when (d_day_name='Sunday') then ss_sales_price else null end) sun_sales,
        sum(case when (d_day_name='Monday') then ss_sales_price else null end) mon_sales,
        sum(case when (d_day_name='Tuesday') then ss_sales_price else null end) tue_sales,
        sum(case when (d_day_name='Wednesday') then ss_sales_price else null end) wed_sales,
        sum(case when (d_day_name='Thursday') then ss_sales_price else null end) thu_sales,
        sum(case when (d_day_name='Friday') then ss_sales_price else null end) fri_sales,
        sum(case when (d_day_name='Saturday') then ss_sales_price else null end) sat_sales
 from store_sales,date_dim
 where d_date_sk = ss_sold_date_sk
 group by d_week_seq,ss_store_sk
 )
  select s_store_name1,s_store_id1,d_week_seq1
       ,sun_sales1/sun_sales2,mon_sales1/mon_sales2
       ,tue_sales1/tue_sales2,wed_sales1/wed_sales2,thu_sales1/thu_sales2
       ,fri_sales1/fri_sales2,sat_sales1/sat_sales2
 from
 (select s_store_name s_store_name1,wss.d_week_seq d_week_seq1
        ,s_store_id s_store_id1,sun_sales sun_sales1
        ,mon_sales mon_sales1,tue_sales tue_sales1
        ,wed_sales wed_sales1,thu_sales thu_sales1
        ,fri_sales fri_sales1,sat_sales sat_sales1
  from wss,store,date_dim d
  where d.d_week_seq = wss.d_week_seq and
        ss_store_sk = s_store_sk and
        d_month_seq between 1176 and 1176 + 11) y,
 (select s_store_name s_store_name2,wss.d_week_seq d_week_seq2
        ,s_store_id s_store_id2,sun_sales sun_sales2
        ,mon_sales mon_sales2,tue_sales tue_sales2
        ,wed_sales wed_sales2,thu_sales thu_sales2
        ,fri_sales fri_sales2,sat_sales sat_sales2
  from wss,store,date_dim d
  where d.d_week_seq = wss.d_week_seq and
        ss_store_sk = s_store_sk and
        d_month_seq between 1176+ 12 and 1176 + 23) x
 where s_store_id1=s_store_id2
   and d_week_seq1=d_week_seq2-52
 order by s_store_name1,s_store_id1,d_week_seq1
 limit 100
"""


def _o_q59(t):
    dd = t["date_dim"]
    m = _m(t["store_sales"], dd, "ss_sold_date_sk", "d_date_sk")
    for day, col in _DAYS:
        m[col] = m.ss_sales_price.where(m.d_day_name == day)
    wss = (m.groupby(["d_week_seq", "ss_store_sk"], as_index=False)
            [[c for _, c in _DAYS]].sum(min_count=1))

    def leg(lo, hi, sfx):
        dwin = dd[(dd.d_month_seq >= lo) & (dd.d_month_seq <= hi)]
        y = wss.merge(dwin[["d_week_seq"]], on="d_week_seq")
        y = _m(y, t["store"], "ss_store_sk", "s_store_sk")
        out = pd.DataFrame({
            f"s_store_name{sfx}": y.s_store_name,
            f"s_store_id{sfx}": y.s_store_id,
            f"d_week_seq{sfx}": y.d_week_seq,
        })
        for _, c in _DAYS:
            out[f"{c[:3]}_sales{sfx}"] = y[c]
        return out

    y = leg(1176, 1187, "1")
    x = leg(1188, 1199, "2")
    x["_join_week"] = x.d_week_seq2 - 52
    j = y.merge(x, left_on=["s_store_id1", "d_week_seq1"],
                right_on=["s_store_id2", "_join_week"])
    out = j[["s_store_name1", "s_store_id1", "d_week_seq1"]].copy()
    for i, (_, c) in enumerate(_DAYS):
        out[f"_c{3 + i}"] = j[f"{c[:3]}_sales1"] / j[f"{c[:3]}_sales2"]
    return out


_case("q59", _Q59, _o_q59, True,
      order=("s_store_name1", "s_store_id1", "d_week_seq1"), limit=100)

_Q65 = """
select s_store_name, i_item_desc, sc.revenue, i_current_price,
       i_wholesale_cost, i_brand
 from store, item,
     (select ss_store_sk, avg(revenue) as ave
      from
          (select  ss_store_sk, ss_item_sk,
                   sum(ss_sales_price) as revenue
          from store_sales, date_dim
          where ss_sold_date_sk = d_date_sk and d_month_seq between 1176 and 1176+11
          group by ss_store_sk, ss_item_sk) sa
      group by ss_store_sk) sb,
     (select  ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
      from store_sales, date_dim
      where ss_sold_date_sk = d_date_sk and d_month_seq between 1176 and 1176+11
      group by ss_store_sk, ss_item_sk) sc
 where sb.ss_store_sk = sc.ss_store_sk and
       sc.revenue <= 0.1 * sb.ave and
       s_store_sk = sc.ss_store_sk and
       i_item_sk = sc.ss_item_sk
 order by s_store_name, i_item_desc
 limit 100
"""


def _o_q65(t):
    dd = t["date_dim"]
    w = _m(t["store_sales"],
           dd[(dd.d_month_seq >= 1176) & (dd.d_month_seq <= 1187)],
           "ss_sold_date_sk", "d_date_sk")
    sa = (w.groupby(["ss_store_sk", "ss_item_sk"], as_index=False)
           .agg(revenue=("ss_sales_price", "sum")))
    sb = sa.groupby("ss_store_sk", as_index=False).agg(ave=("revenue", "mean"))
    m = sb.merge(sa, on="ss_store_sk")
    m = m[m.revenue <= 0.1 * m.ave]
    m = _m(m, t["store"], "ss_store_sk", "s_store_sk")
    m = _m(m, t["item"], "ss_item_sk", "i_item_sk")
    return m[["s_store_name", "i_item_desc", "revenue", "i_current_price",
              "i_wholesale_cost", "i_brand"]]


_case("q65", _Q65, _o_q65, True,
      order=("s_store_name", "i_item_desc"), limit=100)

_Q68 = """
select c_last_name
      ,c_first_name
      ,ca_city
      ,bought_city
      ,ss_ticket_number
      ,extended_price
      ,extended_tax
      ,list_price
 from (select ss_ticket_number
             ,ss_customer_sk
             ,ca_city bought_city
             ,sum(ss_ext_sales_price) extended_price
             ,sum(ss_ext_list_price) list_price
             ,sum(ss_ext_tax) extended_tax
       from store_sales
           ,date_dim
           ,store
           ,household_demographics
           ,customer_address
       where store_sales.ss_sold_date_sk = date_dim.d_date_sk
         and store_sales.ss_store_sk = store.s_store_sk
         and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
         and store_sales.ss_addr_sk = customer_address.ca_address_sk
         and date_dim.d_dom between 1 and 2
         and (household_demographics.hd_dep_count = 5 or
              household_demographics.hd_vehicle_count= 3)
         and date_dim.d_year in (1999,1999+1,1999+2)
         and store.s_city in ('Midway','Fairview')
       group by ss_ticket_number
               ,ss_customer_sk
               ,ss_addr_sk,ca_city) dn
      ,customer
      ,customer_address current_addr
 where ss_customer_sk = c_customer_sk
   and customer.c_current_addr_sk = current_addr.ca_address_sk
   and current_addr.ca_city <> bought_city
 order by c_last_name
         ,ss_ticket_number
 limit 100
"""


def _o_q68(t):
    dd = t["date_dim"]
    hd = t["household_demographics"]
    st = t["store"]
    m = _m(t["store_sales"],
           dd[dd.d_dom.between(1, 2)
              & dd.d_year.isin([1999, 2000, 2001])],
           "ss_sold_date_sk", "d_date_sk")
    m = _m(m, st[st.s_city.isin(["Midway", "Fairview"])],
           "ss_store_sk", "s_store_sk")
    m = _m(m, hd[(hd.hd_dep_count == 5) | (hd.hd_vehicle_count == 3)],
           "ss_hdemo_sk", "hd_demo_sk")
    m = _m(m, t["customer_address"], "ss_addr_sk", "ca_address_sk")
    dn = (m.groupby(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                     "ca_city"], dropna=False, as_index=False)
           .agg(extended_price=("ss_ext_sales_price", "sum"),
                list_price=("ss_ext_list_price", "sum"),
                extended_tax=("ss_ext_tax", "sum"))
           .rename(columns={"ca_city": "bought_city"}))
    out = _m(dn, t["customer"], "ss_customer_sk", "c_customer_sk")
    out = _m(out, t["customer_address"], "c_current_addr_sk", "ca_address_sk")
    out = out[out.ca_city != out.bought_city]
    return out[["c_last_name", "c_first_name", "ca_city", "bought_city",
                "ss_ticket_number", "extended_price", "extended_tax",
                "list_price"]]


_case("q68", _Q68, _o_q68, True,
      order=("c_last_name", "ss_ticket_number"), limit=100)

_Q73 = """
select c_last_name
      ,c_first_name
      ,c_salutation
      ,c_preferred_cust_flag
      ,ss_ticket_number
      ,cnt from
  (select ss_ticket_number
         ,ss_customer_sk
         ,count(*) cnt
   from store_sales,date_dim,store,household_demographics
   where store_sales.ss_sold_date_sk = date_dim.d_date_sk
   and store_sales.ss_store_sk = store.s_store_sk
   and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
   and date_dim.d_dom between 1 and 2
   and (household_demographics.hd_buy_potential = '>10000'
        or household_demographics.hd_buy_potential = 'Unknown')
   and household_demographics.hd_vehicle_count > 0
   and case when household_demographics.hd_vehicle_count > 0 then
            household_demographics.hd_dep_count /
            household_demographics.hd_vehicle_count else null end > 1
   and date_dim.d_year in (1999,1999+1,1999+2)
   and store.s_county in ('Williamson County','Williamson County',
                          'Williamson County','Williamson County')
   group by ss_ticket_number,ss_customer_sk) dj,customer
 where ss_customer_sk = c_customer_sk
   and cnt between 1 and 5
 order by cnt desc, c_last_name asc
"""


def _o_q73(t):
    dn = _dn_oracle(
        t, lambda d: d.d_dom.between(1, 2),
        lambda h: (h.hd_buy_potential.isin([">10000", "Unknown"])
                   & (h.hd_vehicle_count > 0)),
        ["Williamson County"], [1999, 2000, 2001], extra_ratio=1.0)
    dn = dn[dn.cnt.between(1, 5)]
    out = _m(dn, t["customer"], "ss_customer_sk", "c_customer_sk")
    return out[["c_last_name", "c_first_name", "c_salutation",
                "c_preferred_cust_flag", "ss_ticket_number", "cnt"]]


_case("q73", _Q73, _o_q73, True)

_Q79 = """
select c_last_name,c_first_name,substr(s_city,1,30),ss_ticket_number,amt,profit
  from
   (select ss_ticket_number
          ,ss_customer_sk
          ,store.s_city
          ,sum(ss_coupon_amt) amt
          ,sum(ss_net_profit) profit
    from store_sales,date_dim,store,household_demographics
    where store_sales.ss_sold_date_sk = date_dim.d_date_sk
    and store_sales.ss_store_sk = store.s_store_sk
    and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
    and (household_demographics.hd_dep_count = 6 or
         household_demographics.hd_vehicle_count > 2)
    and date_dim.d_dow = 1
    and date_dim.d_year in (1999,1999+1,1999+2)
    and store.s_number_employees between 200 and 295
    group by ss_ticket_number,ss_customer_sk,ss_store_sk,store.s_city) ms,customer
 where ss_customer_sk = c_customer_sk
 order by c_last_name,c_first_name,substr(s_city,1,30), profit
 limit 100
"""


def _o_q79(t):
    dd = t["date_dim"]
    hd = t["household_demographics"]
    st = t["store"]
    m = _m(t["store_sales"],
           dd[(dd.d_dow == 1) & dd.d_year.isin([1999, 2000, 2001])],
           "ss_sold_date_sk", "d_date_sk")
    m = _m(m, st[st.s_number_employees.between(200, 295)],
           "ss_store_sk", "s_store_sk")
    m = _m(m, hd[(hd.hd_dep_count == 6) | (hd.hd_vehicle_count > 2)],
           "ss_hdemo_sk", "hd_demo_sk")
    ms = (m.groupby(["ss_ticket_number", "ss_customer_sk", "ss_store_sk",
                     "s_city"], dropna=False, as_index=False)
           .agg(amt=("ss_coupon_amt", "sum"),
                profit=("ss_net_profit", "sum")))
    out = _m(ms, t["customer"], "ss_customer_sk", "c_customer_sk")
    out["_c2"] = out.s_city.str[:30]
    return out[["c_last_name", "c_first_name", "_c2", "ss_ticket_number",
                "amt", "profit"]]


_case("q79", _Q79, _o_q79, True,
      order=("c_last_name", "c_first_name", "_c2", "profit"), limit=100)

_Q96 = """
select count(*)
 from store_sales
     ,household_demographics
     ,time_dim, store
 where ss_sold_time_sk = time_dim.t_time_sk
     and ss_hdemo_sk = household_demographics.hd_demo_sk
     and ss_store_sk = s_store_sk
     and time_dim.t_hour = 20
     and time_dim.t_minute >= 30
     and household_demographics.hd_dep_count = 7
     and store.s_store_name = 'ese'
 order by count(*)
 limit 100
"""


def _o_q96(t):
    td = t["time_dim"]
    hd = t["household_demographics"]
    st = t["store"]
    m = _m(t["store_sales"], td[(td.t_hour == 20) & (td.t_minute >= 30)],
           "ss_sold_time_sk", "t_time_sk")
    m = _m(m, hd[hd.hd_dep_count == 7], "ss_hdemo_sk", "hd_demo_sk")
    m = _m(m, st[st.s_store_name == "ese"], "ss_store_sk", "s_store_sk")
    return pd.DataFrame({"_c0": [np.int64(len(m))]})


_case("q96", _Q96, _o_q96, True)

# ---------------------------------------------------------------------------
# store-channel adaptations of the engine's gate classes (suffix "a"):
# same operator shapes as models/tpcds.py's hand-built pipelines, but
# driven by SQL text through the frontend
# ---------------------------------------------------------------------------

_Q1A = """
select count(*) cnt
      ,sum(ss_ext_sales_price) total
      ,avg(ss_ext_sales_price) mean
 from store_sales, date_dim
 where ss_sold_date_sk = d_date_sk
   and d_year = 2000
"""


def _o_q1a(t):
    m = _m(t["store_sales"], t["date_dim"][t["date_dim"].d_year == 2000],
           "ss_sold_date_sk", "d_date_sk")
    return pd.DataFrame({
        "cnt": [np.int64(len(m))],
        "total": [_gsum(m.ss_ext_sales_price)],
        "mean": [m.ss_ext_sales_price.mean()],
    })


_case("q1a", _Q1A, _o_q1a, False)

_Q5A = """
select t.channel, sum(t.price) total, count(*) cnt
 from (select 'email' as channel, ss_ext_sales_price as price
       from store_sales, promotion
       where ss_promo_sk = p_promo_sk and p_channel_email = 'Y'
       union all
       select 'event', ss_ext_sales_price
       from store_sales, promotion
       where ss_promo_sk = p_promo_sk and p_channel_event = 'Y') t
 group by t.channel
 order by t.channel
"""


def _o_q5a(t):
    p = t["promotion"]
    em = _m(t["store_sales"], p[p.p_channel_email == "Y"],
            "ss_promo_sk", "p_promo_sk").assign(channel="email")
    ev = _m(t["store_sales"], p[p.p_channel_event == "Y"],
            "ss_promo_sk", "p_promo_sk").assign(channel="event")
    u = pd.concat([em, ev], ignore_index=True)
    return (u.groupby("channel", as_index=False)
             .agg(total=("ss_ext_sales_price", "sum"),
                  cnt=("channel", "size")))


_case("q5a", _Q5A, _o_q5a, False)

_Q14A = """
select d_year, count(*) d_items
 from (select d_year, ss_item_sk
       from store_sales, date_dim
       where ss_sold_date_sk = d_date_sk
       group by d_year, ss_item_sk) di
 group by d_year
 order by d_year
"""


def _o_q14a(t):
    m = _m(t["store_sales"], t["date_dim"], "ss_sold_date_sk", "d_date_sk")
    di = m[["d_year", "ss_item_sk"]].drop_duplicates()
    return (di.groupby("d_year", as_index=False)
              .agg(d_items=("ss_item_sk", "size")))


_case("q14a", _Q14A, _o_q14a, False)

_Q18A = """
select i_category_id cat
      ,d_year
      ,avg(ss_quantity) q_avg
      ,avg(ss_ext_sales_price) p_avg
      ,sum(ss_ext_sales_price) p_sum
      ,count(*) cnt
 from store_sales, date_dim, item
 where ss_sold_date_sk = d_date_sk
   and ss_item_sk = i_item_sk
 group by i_category_id, d_year
 order by cat, d_year
"""


def _o_q18a(t):
    m = _m(t["store_sales"], t["date_dim"], "ss_sold_date_sk", "d_date_sk")
    m = _m(m, t["item"], "ss_item_sk", "i_item_sk")
    g = (m.groupby(["i_category_id", "d_year"], as_index=False)
          .agg(q_avg=("ss_quantity", "mean"),
               p_avg=("ss_ext_sales_price", "mean"),
               p_sum=("ss_ext_sales_price", "sum"),
               cnt=("ss_item_sk", "size")))
    return g.rename(columns={"i_category_id": "cat"})


_case("q18a", _Q18A, _o_q18a, False)

_Q48A = """
select sum(ss_quantity) qty
 from store_sales, store, customer_demographics, date_dim
 where s_store_sk = ss_store_sk
   and ss_sold_date_sk = d_date_sk
   and ss_cdemo_sk = cd_demo_sk
   and d_year = 2000
   and ((cd_marital_status = 'M'
         and cd_education_status = '4 yr Degree'
         and ss_sales_price between 100.00 and 150.00)
     or (cd_marital_status = 'D'
         and cd_education_status = '2 yr Degree'
         and ss_sales_price between 50.00 and 100.00)
     or (cd_marital_status = 'S'
         and cd_education_status = 'College'
         and ss_sales_price between 150.00 and 200.00))
"""


def _o_q48a(t):
    m = _m(t["store_sales"], t["store"], "ss_store_sk", "s_store_sk")
    m = _m(m, t["date_dim"][t["date_dim"].d_year == 2000],
           "ss_sold_date_sk", "d_date_sk")
    m = _m(m, t["customer_demographics"], "ss_cdemo_sk", "cd_demo_sk")
    keep = (
        ((m.cd_marital_status == "M") & (m.cd_education_status == "4 yr Degree")
         & m.ss_sales_price.between(100.0, 150.0))
        | ((m.cd_marital_status == "D")
           & (m.cd_education_status == "2 yr Degree")
           & m.ss_sales_price.between(50.0, 100.0))
        | ((m.cd_marital_status == "S") & (m.cd_education_status == "College")
           & m.ss_sales_price.between(150.0, 200.0)))
    return pd.DataFrame({"qty": [_gsum(m.ss_quantity[keep])]})


_case("q48a", _Q48A, _o_q48a, False)

_Q72A = """
select i_item_id, count(*) cnt
 from store_sales, date_dim d1, date_dim d2, item, household_demographics
 where ss_sold_date_sk = d1.d_date_sk
   and d2.d_week_seq = d1.d_week_seq
   and ss_item_sk = i_item_sk
   and ss_hdemo_sk = hd_demo_sk
   and d1.d_year = 1999
   and hd_buy_potential = '1001-5000'
   and d2.d_dow = 5
 group by i_item_id
 order by cnt desc, i_item_id
 limit 100
"""


def _o_q72a(t):
    dd = t["date_dim"]
    hd = t["household_demographics"]
    m = _m(t["store_sales"], dd[dd.d_year == 1999],
           "ss_sold_date_sk", "d_date_sk")
    d2 = dd[dd.d_dow == 5][["d_week_seq"]]
    m = m.merge(d2, on="d_week_seq")
    m = _m(m, t["item"], "ss_item_sk", "i_item_sk")
    m = _m(m, hd[hd.hd_buy_potential == "1001-5000"],
           "ss_hdemo_sk", "hd_demo_sk")
    return (m.groupby("i_item_id", as_index=False)
             .agg(cnt=("i_item_id", "size")))


_case("q72a", _Q72A, _o_q72a, False,
      order=("cnt", "i_item_id"), ascending=(False, True), limit=100)

_Q93A = """
select i_category
      ,sum(case when p_channel_email = 'Y' then ss_ext_sales_price
                else 0.0 end) promo_sales
      ,sum(ss_ext_sales_price) total_sales
 from store_sales left join promotion
        on ss_promo_sk = p_promo_sk and p_channel_event = 'N'
     ,item
 where ss_item_sk = i_item_sk
 group by i_category
 order by i_category
"""


def _o_q93a(t):
    p = t["promotion"]
    j = t["store_sales"].merge(p[p.p_channel_event == "N"],
                               left_on="ss_promo_sk", right_on="p_promo_sk",
                               how="left")
    j = _m(j, t["item"], "ss_item_sk", "i_item_sk")
    j["_promo"] = np.where(j.p_channel_email == "Y", j.ss_ext_sales_price, 0.0)
    return (j.groupby("i_category", as_index=False)
             .agg(promo_sales=("_promo", "sum"),
                  total_sales=("ss_ext_sales_price", "sum")))


_case("q93a", _Q93A, _o_q93a, False)

_Q95A = """
select d_year, count(*) cnt
 from store_sales, date_dim
 where ss_sold_date_sk = d_date_sk
   and ss_item_sk in (select i_item_sk from item where i_category = 'Books')
 group by d_year
 order by d_year
"""


def _o_q95a(t):
    books = t["item"][t["item"].i_category == "Books"].i_item_sk
    ss = t["store_sales"]
    m = _m(ss[ss.ss_item_sk.isin(set(books))], t["date_dim"],
           "ss_sold_date_sk", "d_date_sk")
    return m.groupby("d_year", as_index=False).agg(cnt=("d_year", "size"))


_case("q95a", _Q95A, _o_q95a, False)

_Q98A = """
select i_item_id, i_item_desc, i_category,
       sum(ss_ext_sales_price) itemrevenue
 from store_sales, item, date_dim
 where ss_item_sk = i_item_sk
   and i_category in ('Sports', 'Books', 'Home')
   and ss_sold_date_sk = d_date_sk
   and d_date between cast('1999-02-22' as date)
                  and (cast('1999-02-22' as date) + interval '30' day)
 group by i_item_id, i_item_desc, i_category
 order by i_category, i_item_id
 limit 100
"""


def _o_q98a(t):
    lo = _dt.date(1999, 2, 22)
    hi = lo + _dt.timedelta(days=30)
    dd = t["date_dim"]
    dd = dd[(dd.d_date >= lo) & (dd.d_date <= hi)]
    it = t["item"]
    m = _m(t["store_sales"],
           it[it.i_category.isin(["Sports", "Books", "Home"])],
           "ss_item_sk", "i_item_sk")
    m = _m(m, dd, "ss_sold_date_sk", "d_date_sk")
    return (m.groupby(["i_item_id", "i_item_desc", "i_category"],
                      as_index=False)
             .agg(itemrevenue=("ss_ext_sales_price", "sum")))


_case("q98a", _Q98A, _o_q98a, False,
      order=("i_category", "i_item_id"), limit=100)

# ---------------------------------------------------------------------------
# out-of-subset corpus: real texts that MUST raise SqlUnsupported.
# name -> (sql, expected construct)
# ---------------------------------------------------------------------------

UNSUPPORTED: dict[str, tuple[str, str]] = {
    # window-function texts (q53/q63/q89/q67 family): the outer `select *`
    # wrapper is the FIRST out-of-subset construct the compiler meets, so
    # that is what the diagnostic names; q70/q36 (no wrapper) surface the
    # window function itself
    "q53": ("""
select * from
  (select i_manufact_id, sum(ss_sales_price) sum_sales,
          avg(sum(ss_sales_price)) over (partition by i_manufact_id) avg_quarterly_sales
   from item, store_sales, date_dim, store
   where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
     and ss_store_sk = s_store_sk
     and d_month_seq in (1200,1200+1,1200+2,1200+3)
   group by i_manufact_id, d_qoy) tmp1
 where avg_quarterly_sales > 0
 order by avg_quarterly_sales
 limit 100
""", "select *"),
    "q63": ("""
select * from
  (select i_manager_id, sum(ss_sales_price) sum_sales,
          avg(sum(ss_sales_price)) over (partition by i_manager_id) avg_monthly_sales
   from item, store_sales, date_dim, store
   where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
     and ss_store_sk = s_store_sk
     and d_month_seq in (1181,1181+1,1181+2,1181+3)
   group by i_manager_id, d_moy) tmp1
 where avg_monthly_sales > 0
 order by i_manager_id, avg_monthly_sales, sum_sales
 limit 100
""", "select *"),
    "q89": ("""
select * from(
 select i_category, i_class, i_brand, s_store_name, s_company_name,
        d_moy, sum(ss_sales_price) sum_sales,
        avg(sum(ss_sales_price)) over
          (partition by i_category, i_brand, s_store_name) avg_monthly_sales
 from item, store_sales, date_dim, store
 where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
   and ss_store_sk = s_store_sk and d_year in (1999)
 group by i_category, i_class, i_brand, s_store_name, s_company_name, d_moy) tmp1
 order by sum_sales
 limit 100
""", "select *"),
    "q67": ("""
select * from
  (select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
          d_moy, s_store_id, sumsales,
          rank() over (partition by i_category order by sumsales desc) rk
   from (select i_category, i_class, i_brand, i_product_name, d_year,
                d_qoy, d_moy, s_store_id,
                sum(ss_sales_price*ss_quantity) sumsales
         from store_sales, date_dim, store, item
         where ss_sold_date_sk=d_date_sk and ss_item_sk=i_item_sk
           and ss_store_sk = s_store_sk and d_month_seq between 1200 and 1200+11
         group by rollup(i_category, i_class, i_brand, i_product_name,
                         d_year, d_qoy, d_moy, s_store_id)) dw1) dw2
 where rk <= 100
 order by i_category, rk
 limit 100
""", "select *"),
    "q70": ("""
select sum(ss_net_profit) as total_sum, s_state, s_county,
       grouping(s_state)+grouping(s_county) as lochierarchy,
       rank() over (
         partition by grouping(s_state)+grouping(s_county),
         case when grouping(s_county) = 0 then s_state end
         order by sum(ss_net_profit) desc) as rank_within_parent
 from store_sales, date_dim d1, store
 where d1.d_month_seq between 1200 and 1200+11
   and d1.d_date_sk = ss_sold_date_sk
   and s_store_sk = ss_store_sk
 group by rollup(s_state,s_county)
 order by lochierarchy desc
 limit 100
""", "window function"),
    "q36": ("""
select sum(ss_net_profit)/sum(ss_ext_sales_price) as gross_margin,
       i_category, i_class,
       grouping(i_category)+grouping(i_class) as lochierarchy,
       rank() over (
         partition by grouping(i_category)+grouping(i_class),
         case when grouping(i_class) = 0 then i_category end
         order by sum(ss_net_profit)/sum(ss_ext_sales_price) asc) as rank_within_parent
 from store_sales, date_dim d1, item, store
 where d1.d_year = 2001
   and d1.d_date_sk = ss_sold_date_sk
   and i_item_sk = ss_item_sk
   and s_store_sk = ss_store_sk
 group by rollup(i_category,i_class)
 order by lochierarchy desc
 limit 100
""", "window function"),
    # DISTINCT aggregates (q28 family; the `select *` wrapper raises first)
    "q28": ("""
select *
 from (select avg(ss_list_price) B1_LP, count(ss_list_price) B1_CNT,
              count(distinct ss_list_price) B1_CNTD
       from store_sales
       where ss_quantity between 0 and 5
         and (ss_list_price between 8 and 8+10
           or ss_coupon_amt between 459 and 459+1000)) B1,
      (select avg(ss_list_price) B2_LP, count(ss_list_price) B2_CNT,
              count(distinct ss_list_price) B2_CNTD
       from store_sales
       where ss_quantity between 6 and 10
         and (ss_list_price between 90 and 90+10
           or ss_coupon_amt between 2323 and 2323+1000)) B2
 limit 100
""", "select *"),
    # scalar subquery in a predicate (q41 family)
    "q41": ("""
select distinct(i_item_desc)
 from item i1
 where i_manufact_id between 738 and 738+40
   and (select count(*) as item_cnt
        from item
        where (i_manufact = i1.i_manufact and i_category = 'Women')) > 0
 order by i_item_desc
 limit 100
""", "scalar subquery"),
    # scalar-aggregate derived tables joined with no keys (q61 family):
    # the comma cross join is the first out-of-subset construct
    "q61": ("""
select promotions, total, promotions/total*100
 from (select sum(ss_ext_sales_price) promotions
       from store_sales, store, promotion, date_dim
       where ss_store_sk = s_store_sk
         and ss_promo_sk = p_promo_sk
         and ss_sold_date_sk = d_date_sk
         and p_channel_email = 'Y'
         and d_year = 1998) promotional_sales,
      (select sum(ss_ext_sales_price) total
       from store_sales, store, date_dim
       where ss_store_sk = s_store_sk
         and ss_sold_date_sk = d_date_sk
         and d_year = 1998) all_sales
 order by promotions, total
 limit 100
""", "cross join"),
    # set operations beyond UNION ALL (q8 zip-list intersect)
    "q8": ("""
select s_store_name, sum(ss_net_profit)
 from store_sales, date_dim, store,
      (select ca_zip from
        (select substr(ca_zip,1,5) ca_zip from customer_address
         where substr(ca_zip,1,5) in ('24128','76232','65084')
         intersect
         select ca_zip from
          (select substr(ca_zip,1,5) ca_zip, count(*) cnt
           from customer_address, customer
           where ca_address_sk = c_current_addr_sk
             and c_preferred_cust_flag='Y'
           group by ca_zip
           having count(*) > 10) A1) A2) V1
 where ss_store_sk = s_store_sk
   and ss_sold_date_sk = d_date_sk
   and d_qoy = 2 and d_year = 1998
   and (substr(s_zip,1,2) = substr(V1.ca_zip,1,2))
 group by s_store_name
 order by s_store_name
 limit 100
""", "intersect"),
    # correlated subquery (q1 family, store-channel tables only)
    "q32": ("""
select sum(ss_ext_sales_price) as excess_discount_amount
 from store_sales, item, date_dim
 where i_manufact_id = 977
   and i_item_sk = ss_item_sk
   and d_date_sk = ss_sold_date_sk
   and ss_ext_sales_price > (select 1.3 * avg(ss_ext_sales_price)
                             from store_sales
                             where ss_item_sk = i_item_sk)
 limit 100
""", "scalar subquery"),
}


if __name__ == "__main__":
    main()
