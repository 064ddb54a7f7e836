"""SqlServer: concurrent multi-tenant query execution over one card (port
of ``auron_tpu/serve/server.py``).

One instance serves many concurrent queries:

- each query runs under its OWN query trace (obs.query_trace) and its
  own per-tenant session Configuration — conf is threaded explicitly
  through the mesh driver and into the collect task's TaskDefinition,
  never read from ambient thread state;
- parse -> bind -> lower is skipped on a plan-digest cache hit
  (serve/cache.py); execution re-enters the fusion stage cache, so a
  replayed query adds zero new graph captures;
- the admission controller (serve/admission.py) bounds concurrency and
  applies memory-manager-aware backpressure BEFORE a query touches the
  card;
- per-query isolation of the collect stage rides call_native's
  ``extra_resources`` overlay: concurrent queries hand their own stage
  output under the shared ``sql:__stage__`` rid without racing on the
  global resource map.

Differences from the reference:

- the server owns the port's catalog ``Table``s (``sql/catalog.
  build_tables``), not pandas frames, and uploads each scanned view once
  per (rid, mesh width) with ``models/tpcds.to_batches`` on its device;
- it runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``; a
  CUDA server without a card raises). On the card each admitted query
  runs on a CUDA stream of its own, the way the task slots do
  (``models/tpcds.run_tasks_parallel``): its driver, its tasks and its
  collect task launch there, and the stage barrier before the collect
  task waits on that stream only, never on the whole device, so it does
  not stall the other tenants;
- the port's mesh is P logical partitions of one card: a width is
  refused (QueryError) where ``parallel/mesh.make_mesh`` refuses it;
- ``exchange.mode`` stays ``auto`` on every device: the reference forces
  ``file`` on JAX's CPU backend against an XLA:CPU collective hazard the
  port does not have (its CPU gate runs both transports);
- pandas is imported inside the functions that need it;
- an admitted query holds the host's turn (``runtime/dispatch.py``) while
  it plans, dispatches and builds its answer, and gives it up where it
  waits (a stage's end, the collect barrier, its task's queue, a table
  upload, its stream's last sync): the threads of concurrent queries take
  turns at dispatching instead of handing the interpreter lock to each
  other at every torch call. The reference needs none: its queries are
  XLA executions that hold no interpreter lock while they run.
"""

from __future__ import annotations

import threading
import time

from auron_tpu_torch.runtime import dispatch
from auron_tpu_torch.serve.admission import AdmissionController
from auron_tpu_torch.serve.cache import PlanCache, plan_cache_key
from auron_tpu_torch.utils.config import (
    SERVE_PLAN_CACHE_ENTRIES,
    SQL_SHUFFLE_PARTITIONS,
    Configuration,
    conf_scope,
)

#: session-conf keys tenants may NOT override: these mutate process-wide
#: state when a task conf carries them (obs.apply_conf flips the global
#: recording mode; the http service is the server's own front door) or
#: reconfigure the server/admission layer itself. A request naming one
#: fails loudly instead of silently bleeding into every other tenant.
_SESSION_DENIED_PREFIXES = ("obs.", "http.service.", "serve.")


class QueryError(RuntimeError):
    """A request-level error (bad SQL, bad conf key): HTTP 400."""


class SqlServer:
    """In-process SQL serving front end (POST /sql's implementation)."""

    def __init__(self, catalog, tables: dict, conf: Configuration | None = None,
                 n_parts: int | None = None, mesh=None, device="cuda"):
        from auron_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.catalog = catalog
        self.tables = tables
        # exchange.mode keeps its auto default on the CPU too (module
        # docstring)
        self.conf = (conf or Configuration()).copy()
        self.n_parts = (n_parts if n_parts is not None
                        else self.conf.get(SQL_SHUFFLE_PARTITIONS))
        self.conf = self.conf.set(SQL_SHUFFLE_PARTITIONS, self.n_parts)
        # meshes per width: a tenant overriding sql.shuffle.partitions
        # gets a DIFFERENT plan (the knob rides the plan-cache key) and
        # must execute at that width
        self._mesh_lock = threading.Lock()
        self._meshes = {}
        if mesh is not None:
            self._meshes[self.n_parts] = mesh
        self.mesh = self._mesh_for(self.n_parts)
        self.plan_cache = PlanCache(self.conf.get(SERVE_PLAN_CACHE_ENTRIES))
        self.admission = AdmissionController(self.conf)
        # uploaded table views, (rid, n_parts) -> per-partition batch
        # lists; one upload per scanned view across ALL queries/tenants.
        # The lock guards only the dict — uploads run OUTSIDE it behind a
        # per-key in-flight event, so a first-touch staging of one large
        # table never serializes unrelated concurrent queries
        self._res_lock = threading.Lock()
        self._res_cache: dict = {}
        self._stats_lock = threading.Lock()
        self.queries_ok = 0
        self.queries_err = 0

    # ------------------------------------------------------------------
    # session confs

    def session_conf(self, overrides: dict | None,
                     tenant: str | None = None) -> Configuration:
        """Base conf + validated per-request overrides. Unknown keys and
        process-global keys refuse loudly (QueryError -> 400)."""
        from auron_tpu_torch.utils.config import _REGISTRY

        conf = self.conf.copy()
        for k, v in (overrides or {}).items():
            if any(k.startswith(p) for p in _SESSION_DENIED_PREFIXES):
                raise QueryError(
                    f"conf key {k!r} is not session-settable (process-wide "
                    "or server-level state)")
            if k not in _REGISTRY:
                raise QueryError(f"unknown conf key {k!r}")
            conf = conf.set(k, str(v))
        return conf

    # ------------------------------------------------------------------
    # planning

    def plan(self, sql: str, conf: Configuration):
        """(LoweredQuery, digest-key, cache_hit) — the program-cache front
        door: a hit skips parse/bind/lower entirely."""
        from auron_tpu_torch.sql import compile_text

        key = plan_cache_key(sql, conf)
        lq = self.plan_cache.lookup(key)
        if lq is not None:
            return lq, key, True
        lq = compile_text(sql, self.catalog,
                          n_parts=conf.get(SQL_SHUFFLE_PARTITIONS))
        self.plan_cache.insert(key, lq)
        return lq, key, False

    # ------------------------------------------------------------------
    # execution

    def _mesh_for(self, n_parts: int):
        from auron_tpu_torch.parallel.mesh import make_mesh

        with self._mesh_lock:
            mesh = self._meshes.get(n_parts)
            if mesh is None:
                # explicit check, not assert-sniffing: a width make_mesh
                # refuses is the tenant's error, not the server's
                try:
                    mesh = make_mesh(n_parts, self.device)
                except ValueError as e:
                    raise QueryError(f"sql.shuffle.partitions={n_parts}: {e}") from None
                self._meshes[n_parts] = mesh
            return mesh

    def _build_resources(self, lq) -> dict:
        """Batch lists for every table the plan scans, uploaded once per
        (rid, width). Two first-queries of one table serialize on that
        table's in-flight event only; queries over already-resident (or
        different) tables proceed without waiting."""
        return {use.rid: self._table_view(use, lq.n_parts)
                for use in lq.tables}

    def _table_view(self, use, n_parts: int):
        from auron_tpu_torch.models.tpcds import to_batches

        key = (use.rid, n_parts)
        with self._res_lock:
            ent = self._res_cache.get(key)
            if ent is None:
                ent = self._res_cache[key] = {
                    "done": threading.Event(), "val": None}
                uploader = True
            else:
                uploader = False
        if uploader:
            try:
                table = self.tables[use.table]
                if use.replicated:
                    val = [to_batches(table, 1, device=self.device)[0]] * n_parts
                else:
                    val = to_batches(table, n_parts, device=self.device)
                if self.device.type == "cuda":
                    import torch

                    # other tenants read the view on their own streams:
                    # the upload is finished before anyone sees it
                    with dispatch.waiting():
                        torch.cuda.current_stream(self.device).synchronize()
                ent["val"] = val
            except BaseException:
                # failed upload must not wedge waiters or poison the
                # cache: drop the entry, release waiters (they re-raise)
                with self._res_lock:
                    self._res_cache.pop(key, None)
                raise
            finally:
                ent["done"].set()
            return val
        with dispatch.waiting():
            ent["done"].wait()
        if ent["val"] is None:
            raise RuntimeError(
                f"concurrent upload of {use.rid} failed; retry the query")
        return ent["val"]

    def _execute(self, lq, conf: Configuration):
        """Run one lowered query under ``conf``: distributed stage through
        a fresh driver (drivers carry per-run state), then the optional
        collect stage as an isolated task. Returns the result frame."""
        from auron_tpu_torch.bridge import api
        from auron_tpu_torch.models.sqlgate import _frame
        from auron_tpu_torch.parallel.mesh_driver import MeshQueryDriver
        from auron_tpu_torch.plan import builders as B
        from auron_tpu_torch.sql.lowering import STAGE_RID

        resources = self._build_resources(lq)
        driver = MeshQueryDriver(self._mesh_for(lq.n_parts), conf=conf)
        outs = driver.run(lq.distributed, resources)
        batches = [b for part in outs for b in part]
        if lq.collect is not None:
            if self.device.type == "cuda":
                import torch

                # stage barrier: THIS query's stream, not the device (the
                # other tenants' streams run on, and dispatch meanwhile)
                dispatch.wait_for(torch.cuda.current_stream(self.device))
            # the collect task ships THIS query's conf (tenant knobs +
            # obs.trace.id) and reads its stage input through the
            # call-scoped resource overlay — no global-map rendezvous,
            # no cross-query bleed on the shared STAGE_RID
            task = B.task(lq.collect, conf=conf.as_dict())
            h = api.call_native(task.SerializeToString(),
                                extra_resources={STAGE_RID: [batches]},
                                device=str(self.device))
            out = []
            try:
                while (b := api.next_batch(h)) is not None:
                    out.append(b)
            except BaseException:
                # a failing per-query collect must not leak its runtime
                # (handle in api._runtimes, pump thread blocked on the
                # bounded queue) — finalize cancels/joins; ITS error is
                # secondary to the one already propagating
                try:
                    api.finalize_native(h)
                except Exception:  # noqa: BLE001 — the collect error is primary
                    pass
                raise
            api.finalize_native(h)
            batches = out
        return _frame(batches, lq)

    def _query_stream(self):
        """A CUDA stream of the query's own, ordered after the caller's
        stream (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        import torch

        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        return stream

    # ------------------------------------------------------------------
    # the front door

    def submit(self, sql: str, session: dict | None = None,
               tenant: str | None = None):
        """Plan (or cache-hit) + admit + execute one query. Returns the
        result frame and a record (digest, cache_hit, timings, trace)."""
        import contextlib

        from auron_tpu_torch import obs

        t_arrive = time.perf_counter()
        try:
            # inside the try: a refused conf key (QueryError) and an
            # admission timeout must count on /serve's queries_err too
            conf = self.session_conf(session, tenant=tenant)
            self._mesh_for(conf.get(SQL_SHUFFLE_PARTITIONS))
            with self.admission.admit() as slot:
                rec = {
                    "tenant": tenant,
                    "cache_hit": False,
                    "queue_wait_s": round(slot.wait_s, 4),
                }
                stream = self._query_stream()
                if stream is not None:
                    import torch

                    on_stream = torch.cuda.stream(stream)
                else:
                    on_stream = contextlib.nullcontext()
                # conf_scope: everything below (ingest, drivers, tasks)
                # resolves THIS query's conf, never a sibling handler
                # thread's
                try:
                    with on_stream, dispatch.turn(), conf_scope(conf), obs.query_trace(
                        f"serve.{tenant or 'anon'}", conf=conf
                    ) as qt:
                        lq, key, hit = self.plan(sql, qt.conf or conf)
                        rec["digest"] = key
                        rec["cache_hit"] = hit
                        df = self._execute(lq, qt.conf if qt.conf is not None
                                           else conf)
                finally:
                    if stream is not None:
                        stream.synchronize()
                if qt.summary is not None:
                    rec["trace_id"] = qt.summary["trace_id"]
                rec["rows"] = len(df)
                rec["wall_s"] = round(time.perf_counter() - t_arrive, 4)
                with self._stats_lock:
                    self.queries_ok += 1
                return df, rec
        except Exception:
            with self._stats_lock:
                self.queries_err += 1
            raise

    def execute_json(self, body: dict) -> dict:
        """The POST /sql contract: body
        ``{"sql": ..., "conf": {...}?, "tenant": ...?}`` ->
        ``{"columns": [...], "rows": [[...]], ...record}``. Raises
        QueryError for request-level problems (handler answers 400)."""
        if not isinstance(body, dict) or not isinstance(body.get("sql"), str):
            raise QueryError('body must be a JSON object with a "sql" string')
        session = body.get("conf")
        if session is not None and not isinstance(session, dict):
            raise QueryError('"conf" must be an object of key -> value')
        from auron_tpu_torch.sql.diagnostics import SqlDiagnostic

        try:
            df, rec = self.submit(body["sql"], session=session,
                                  tenant=body.get("tenant"))
        except SqlDiagnostic as e:
            raise QueryError(str(e)) from None
        rec["columns"] = list(df.columns)
        rec["rows"] = _json_rows(df)
        return rec

    def stats(self) -> dict:
        """The /serve endpoint's payload."""
        with self._stats_lock:
            ok, err = self.queries_ok, self.queries_err
        return {
            "n_parts": self.n_parts,
            "device": str(self.device),
            "queries_ok": ok,
            "queries_err": err,
            "plan_cache": self.plan_cache.stats(),
            "admission": self.admission.stats(),
            "tables_resident": len(self._res_cache),
        }


def _json_rows(df) -> list[list]:
    """JSON-safe row materialization: numpy scalars -> python, NaN/NaT ->
    null. Deterministic (shortest-roundtrip float repr), so two identical
    result frames serialize byte-identically — the property the
    concurrency differential gate's HTTP leg compares on."""
    import pandas as pd

    out = []
    for row in df.itertuples(index=False, name=None):
        vals = []
        for v in row:
            if v is None or (isinstance(v, float) and v != v) or pd.isna(v):
                vals.append(None)
            elif hasattr(v, "isoformat"):
                # datetime-like (pd.Timestamp, date): BEFORE .item() —
                # Timestamp.item does not exist and a raw Timestamp is
                # not JSON-serializable (a DATE32 projection would 500)
                vals.append(v.isoformat())
            elif hasattr(v, "item"):
                vals.append(v.item())
            else:
                vals.append(v)
        out.append(vals)
    return out
