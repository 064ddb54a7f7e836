"""The port's concurrent multi-tenant serving (``auron_tpu_torch/serve``)
on the CPU at SF 0.02 and P = 2.

Every case of ``tests/test_serve.py`` on the port — the plan digests, the
program cache (accounting, bounded LRU eviction, invalidation by a
plan-affecting session knob, zero-compile replay across fresh servers),
session confs, admission control (queueing, timeouts, memory
backpressure), ``POST /sql`` and a toy run of the concurrency
differential gate — plus parity with the JAX package's serving layer:
``plan_cache_key`` and ``_json_rows`` give the reference's values on the
same input; for q3, q34, q46, q65, q96 and q5a the port's ``SqlServer``
answers equal the JAX ``SqlServer``'s over the same frames (floats at rel
1e-6, everything else exact, as ``test_torch_sqlgate.py`` compares); a
refused conf key and an unsupported text give the reference's
``QueryError`` message.

The reference's over-wide mesh refusal (``sql.shuffle.partitions`` past
the device count) becomes a width the port's ``make_mesh`` refuses (0):
the port's mesh is logical partitions of one card.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from auron_tpu_torch.models import sqlgate
from auron_tpu_torch.serve import (
    AdmissionController,
    AdmissionTimeout,
    PlanCache,
    QueryError,
    SqlServer,
)
from auron_tpu_torch.serve.cache import plan_cache_key
from auron_tpu_torch.sql.catalog import frames_of
from auron_tpu_torch.utils.config import (
    SERVE_MAX_CONCURRENT,
    SERVE_QUEUE_TIMEOUT_S,
    SQL_SHUFFLE_PARTITIONS,
    Configuration,
)

TOY_SF = 0.02
PARITY = ["q3", "q34", "q46", "q65", "q96", "q5a"]


@pytest.fixture(scope="module", autouse=True)
def _leak_canary():
    """The port's task runtimes, resource map and obs rings are as this
    module found them (suite-spawned threads owning a ring have exited)."""
    import time

    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.obs import core

    with api._lock:
        base_rt, base_res = set(api._runtimes), set(api._resources)
    base_threads = {t.ident for t in threading.enumerate()}
    yield
    with api._lock:
        assert set(api._runtimes) <= base_rt, "leaked task runtimes"
        assert set(api._resources) <= base_res, "leaked resource-map entries"
    deadline = time.monotonic() + 5.0
    while True:
        live = {t.ident for t in threading.enumerate()}
        with core._reg_lock:
            stuck = [r.tname for r in core._rings
                     if r.ident in live and r.ident not in base_threads]
        if not stuck or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not stuck, f"live suite threads still own obs rings: {stuck}"


@pytest.fixture(scope="module")
def tables():
    return sqlgate.gate_tables(TOY_SF)


@pytest.fixture(scope="module")
def frames(tables):
    return frames_of(tables)


@pytest.fixture(scope="module")
def server(tables):
    srv = SqlServer(sqlgate.gate_catalog(), tables, n_parts=2, device="cpu")
    yield srv
    # in-flight upload events: every entry still resident must have
    # released its waiters
    with srv._res_lock:
        stuck = [k for k, ent in srv._res_cache.items()
                 if not ent["done"].is_set() or ent["val"] is None]
    assert not stuck, f"resource-map entries with unreleased waiters: {stuck}"


def _sql(name):
    return sqlgate.case_by_name(name).sql


# ---------------------------------------------------------------------------
# plan digests
# ---------------------------------------------------------------------------


def test_digest_normalizes_whitespace_comments_case():
    from auron_tpu_torch.sql.digest import plan_digest

    a = plan_digest("select d_year from date_dim where d_moy = 11")
    b = plan_digest(
        "SELECT  d_year\n FROM date_dim -- comment\n WHERE D_MOY = 11")
    c = plan_digest("select d_year from date_dim where d_moy = 12")
    assert a == b
    assert a != c


def test_digest_distinguishes_string_literals_from_bare_tokens():
    from auron_tpu_torch.sql.digest import plan_digest

    assert plan_digest("select '1' from t") != plan_digest("select 1 from t")
    assert (plan_digest("select a from t where s = 'NAME'")
            != plan_digest("select a from t where s = NAME"))
    assert (plan_digest("select 'o''k' from t")
            == plan_digest("select  'o''k'  from t"))


def _json_rows_frame():
    import numpy as np
    import pandas as pd

    return pd.DataFrame({
        "d": pd.to_datetime(["2020-01-01", None]),
        "x": [np.int64(7), np.int64(8)],
        "f": [1.5, float("nan")],
        "s": ["a", None],
    })


def test_json_rows_serializes_datetimes_and_nulls():
    from auron_tpu_torch.serve.server import _json_rows

    rows = _json_rows(_json_rows_frame())
    json.dumps(rows)  # must be JSON-safe
    assert rows[0][0].startswith("2020-01-01") and rows[1][0] is None
    assert rows[0][1] == 7 and rows[1][2] is None and rows[1][3] is None


def test_json_rows_equals_the_reference(server):
    from auron_tpu.serve.server import _json_rows as ref_rows
    from auron_tpu_torch.serve.server import _json_rows

    df = _json_rows_frame()
    assert _json_rows(df) == ref_rows(df)
    answer, _ = server.submit(_sql("q34"), tenant="rows")
    assert len(answer) and json.dumps(_json_rows(answer)) == json.dumps(ref_rows(answer))


def test_digest_distinguishes_quoted_identifiers():
    from auron_tpu_torch.sql.digest import plan_digest

    assert (plan_digest('select "a b" from t')
            != plan_digest("select a b from t"))
    assert (plan_digest('select "from" from t')
            != plan_digest("select from from t"))
    assert (plan_digest('select  "a b"  from t')
            == plan_digest('select "a b" from t'))


def test_failing_query_does_not_leak_task_runtimes(server, monkeypatch):
    """A query whose collect-stage drain fails still finalizes its
    TaskRuntime."""
    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.sql.digest import plan_digest

    before = set(api._runtimes)

    def boom(h):
        raise RuntimeError("injected drain failure")

    monkeypatch.setattr(api, "next_batch", boom)
    with pytest.raises(RuntimeError, match="injected"):
        server.submit(_sql("q3"), tenant="leak")  # q3 has a collect stage
    monkeypatch.undo()
    assert set(api._runtimes) == before
    a = plan_digest("select X from t", fold_ident_case=False)
    b = plan_digest("select x from t", fold_ident_case=False)
    assert a != b


def test_plan_cache_key_includes_plan_knobs():
    conf2 = Configuration().set(SQL_SHUFFLE_PARTITIONS, 2)
    conf4 = Configuration().set(SQL_SHUFFLE_PARTITIONS, 4)
    sql = _sql("q96")
    assert plan_cache_key(sql, conf2) != plan_cache_key(sql, conf4)
    assert plan_cache_key(sql, conf2) == plan_cache_key(sql, conf2)


def test_plan_cache_key_splits_on_fusion_and_host_sort_knobs():
    from auron_tpu_torch.utils.config import (
        FUSE_AGG_INPUTS,
        FUSE_ENABLE,
        FUSE_MIN_OPS,
        FUSE_PROBE,
        FUSE_SHUFFLE,
        HOST_SORT_MODE,
    )

    sql = _sql("q96")
    for knob, a, b in (
        (FUSE_ENABLE, "on", "off"),
        (FUSE_PROBE, "on", "off"),
        (FUSE_SHUFFLE, "on", "off"),
        (FUSE_MIN_OPS, 2, 9),
        (FUSE_AGG_INPUTS, True, False),
        (HOST_SORT_MODE, "on", "off"),
    ):
        ka = plan_cache_key(sql, Configuration().set(knob, a))
        kb = plan_cache_key(sql, Configuration().set(knob, b))
        assert ka != kb, f"{knob.key} does not split the plan cache"
    assert plan_cache_key(sql, Configuration()) == plan_cache_key(
        sql, Configuration())


@pytest.mark.parametrize("knobs", [
    {}, {"sql.shuffle.partitions": 4}, {"exec.fuse.enable": "off"},
    {"case.sensitive": "true", "exec.host.sort": "on"}, {"exec.fuse.min.ops": 9},
])
@pytest.mark.parametrize("name", ["q3", "q96", "q5a"])
def test_plan_cache_key_equals_the_reference(name, knobs):
    from auron_tpu.serve.cache import plan_cache_key as ref_key
    from auron_tpu.utils.config import Configuration as RefConfiguration

    assert plan_cache_key(_sql(name), Configuration(dict(knobs))) == \
        ref_key(_sql(name), RefConfiguration(dict(knobs)))


def test_plan_knobs_single_source_of_truth():
    from auron_tpu_torch.serve import cache
    from auron_tpu_torch.sql import digest

    assert cache.PLAN_KNOBS is digest.PLAN_KNOBS
    assert {k.key for k in digest.PLAN_KNOBS} >= {
        "sql.shuffle.partitions",
        "exec.fuse.enable",
        "exec.host.sort",
    }


# ---------------------------------------------------------------------------
# program cache: accounting, eviction, invalidation, zero-compile replay
# ---------------------------------------------------------------------------


def test_plan_cache_hit_miss_accounting():
    c = PlanCache(capacity=8)
    assert c.lookup("k1") is None
    c.insert("k1", "plan1")
    assert c.lookup("k1") == "plan1"
    s = c.stats()
    assert (s["hits"], s["misses"], s["entries"]) == (1, 1, 1)


def test_plan_cache_eviction_is_lru_and_bounded():
    c = PlanCache(capacity=2)
    c.insert("a", 1)
    c.insert("b", 2)
    assert c.lookup("a") == 1
    c.insert("c", 3)
    assert c.lookup("b") is None
    assert c.lookup("a") == 1 and c.lookup("c") == 3
    s = c.stats()
    assert s["evictions"] == 1 and s["entries"] == 2


def test_server_cache_hit_and_knob_invalidation(server):
    sql = _sql("q96")
    df1, r1 = server.submit(sql, tenant="a")
    df2, r2 = server.submit(sql, tenant="b")
    assert not r1["cache_hit"] and r2["cache_hit"]
    assert r1["digest"] == r2["digest"]
    assert df1.equals(df2)
    df3, r3 = server.submit(sql, session={"sql.shuffle.partitions": 4},
                            tenant="c")
    assert not r3["cache_hit"]
    assert r3["digest"] != r1["digest"]
    assert df3.equals(df1)
    _, r4 = server.submit(sql, tenant="d")
    assert r4["cache_hit"]


def test_replay_adds_no_compiles_across_fresh_server_sessions(tables):
    from auron_tpu_torch.utils.profiling import EngineCounters

    counters = EngineCounters.install()
    sql = _sql("q3")
    warm = SqlServer(sqlgate.gate_catalog(), tables, n_parts=2, device="cpu")
    df1, _ = warm.submit(sql)
    before = counters.compiles
    fresh = SqlServer(sqlgate.gate_catalog(), tables, n_parts=2, device="cpu")
    df2, rec = fresh.submit(sql)
    assert not rec["cache_hit"]
    assert counters.compiles == before
    assert df1.equals(df2)


def test_cuda_server_without_a_card_raises(tables):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: tests/test_torch_cuda.py serves on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        SqlServer(sqlgate.gate_catalog(), tables, n_parts=2)


@pytest.mark.parametrize("groups", [1, 7, 1000, 1 << 16])
def test_fixed_order_sums_equal_the_sequential_index_add(groups):
    """The card's fixed-order float sums (``ops/segments.add_at_``) add each
    index's values in their order: on the CPU, bit-equal to ``index_add_``,
    which adds sequentially."""
    import numpy as np
    import torch

    from auron_tpu_torch.ops import segments as S

    rng = np.random.default_rng(groups)
    n = 1 << 16
    idx = torch.from_numpy(rng.integers(0, groups, n))
    vals = torch.from_numpy(rng.normal(0, 1e6, n))
    want = torch.zeros(groups + 1, dtype=torch.float64).index_add_(0, idx, vals)
    got = S.fixed_order_sums(idx, vals, groups + 1)
    assert torch.equal(got, want)
    assert got[groups] == 0  # an index no value names sums to 0


# ---------------------------------------------------------------------------
# session confs
# ---------------------------------------------------------------------------


def test_session_conf_rejects_unknown_and_process_global_keys(server):
    with pytest.raises(QueryError):
        server.session_conf({"no.such.key": "1"})
    for denied in ("obs.mode", "http.service.enable",
                   "serve.admission.max.concurrent"):
        with pytest.raises(QueryError):
            server.session_conf({denied: "1"})
    conf = server.session_conf({"batch.size": 4096})
    from auron_tpu_torch.utils.config import BATCH_SIZE

    assert conf.get(BATCH_SIZE) == 4096


def test_sql_diagnostics_surface_as_query_errors(server):
    err0 = server.stats()["queries_err"]
    with pytest.raises(QueryError):
        server.execute_json({"sql": "select definitely from"})
    with pytest.raises(QueryError):
        server.execute_json({"nope": 1})
    with pytest.raises(QueryError):
        server.submit(_sql("q96"), session={"obs.mode": "off"})
    with pytest.raises(QueryError, match="sql.shuffle.partitions=0"):
        server.submit(_sql("q96"), session={"sql.shuffle.partitions": 0})
    # refused requests COUNT on /serve; the malformed-body refusal raises
    # before submit, so 3 of the 4
    assert server.stats()["queries_err"] >= err0 + 3


def _ref_server(frames):
    from auron_tpu.models import sqlgate as RG
    from auron_tpu.serve import SqlServer as RefServer

    return RefServer(RG.gate_catalog(), frames, n_parts=2)


def test_query_error_messages_equal_the_reference(server, frames):
    from auron_tpu.serve import QueryError as RefQueryError

    ref = _ref_server(frames)
    name, (text, _construct) = next(iter(sqlgate.UNSUPPORTED.items()))
    for body in ({"sql": _sql("q96"), "conf": {"obs.mode": "off"}},
                 {"sql": _sql("q96"), "conf": {"no.such.key": 1}},
                 {"sql": text}, {"sql": "select definitely from"}, {"nope": 1}):
        with pytest.raises(QueryError) as got:
            server.execute_json(body)
        with pytest.raises(RefQueryError) as want:
            ref.execute_json(body)
        assert str(got.value) == str(want.value), (name, body)


@pytest.mark.parametrize("name", PARITY)
def test_answers_equal_the_jax_server(server, frames, name):
    from auron_tpu_torch.models.compare import compare_frames

    got, rec = server.submit(_sql(name), tenant="parity")
    want, ref_rec = _ref_server(frames).submit(_sql(name), tenant="parity")
    assert rec["digest"] == ref_rec["digest"]
    assert len(want) and list(got.columns) == list(want.columns)
    assert [str(t) for t in got.dtypes] == [str(t) for t in want.dtypes]
    assert compare_frames(got, want, 1e-6, sorted_rows=True) is None


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def _adm(max_concurrent=1, timeout_s=0.3, mem_fraction=0.9):
    from auron_tpu_torch.utils.config import SERVE_ADMIT_MEM_FRACTION

    conf = (Configuration()
            .set(SERVE_MAX_CONCURRENT, max_concurrent)
            .set(SERVE_QUEUE_TIMEOUT_S, timeout_s)
            .set(SERVE_ADMIT_MEM_FRACTION, mem_fraction))
    return AdmissionController(conf)


def test_admission_queues_beyond_the_slot_bound():
    adm = _adm(max_concurrent=1, timeout_s=5.0)
    order = []
    gate = threading.Event()

    def worker(i):
        with adm.admit():
            order.append(i)
            if i == 0:
                gate.wait(2.0)

    t0 = threading.Thread(target=worker, args=(0,))
    t0.start()
    while not order:
        pass
    t1 = threading.Thread(target=worker, args=(1,))
    t1.start()
    t1.join(0.2)
    assert t1.is_alive()
    gate.set()
    t0.join(3.0)
    t1.join(3.0)
    st = adm.stats()
    assert st["peak_running"] == 1 and st["queued"] >= 1
    assert order == [0, 1]


def test_admission_timeout_answers_instead_of_hanging():
    adm = _adm(max_concurrent=1, timeout_s=0.15)
    with adm.admit():
        with pytest.raises(AdmissionTimeout):
            with adm.admit():
                pass
    assert adm.stats()["timeouts"] == 1
    with adm.admit():
        pass


def test_admission_memory_backpressure_queues_then_admits():
    from auron_tpu_torch.memory.memmgr import MemManager

    mgr = MemManager.get()

    class Hog:
        name = "test_admission_hog"

        def __init__(self, nbytes):
            self.nbytes = nbytes

        def mem_used(self):
            return self.nbytes

        def spill(self):
            return 0

    hog = Hog(int(mgr.budget * 1.5) + (1 << 20))
    adm = _adm(max_concurrent=4, timeout_s=0.2)
    mgr.register(hog, spillable=False)
    try:
        with pytest.raises(AdmissionTimeout):
            with adm.admit():
                pass
    finally:
        mgr.unregister(hog)
    with adm.admit():
        pass
    st = adm.stats()
    assert st["timeouts"] == 1 and st["admitted"] == 1


# ---------------------------------------------------------------------------
# POST /sql front door
# ---------------------------------------------------------------------------


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sql", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            return e.code, json.loads(body)
        except ValueError:
            return e.code, {"error": body.decode(errors="replace")}


def test_post_sql_endpoint(server, frames):
    from auron_tpu_torch.serve.server import _json_rows
    from auron_tpu_torch.utils import httpsvc

    port = httpsvc.start(0)
    httpsvc.install_sql_server(server)
    try:
        code, resp = _post(port, {"sql": _sql("q1a"), "tenant": "http"})
        assert code == 200
        assert resp["columns"] == ["cnt", "total", "mean"]
        assert len(resp["rows"]) == 1 and resp["rows"][0][0] > 0
        assert resp["digest"] and "trace_id" in resp
        want, _ = sqlgate.oracle_answer(sqlgate.case_by_name("q1a"), frames)
        assert resp["rows"][0][0] == _json_rows(want)[0][0]
        code, resp = _post(port, {"sql": "select broken from"})
        assert code == 400 and "error" in resp
        code, resp = _post(port, {"sql": _sql("q1a"),
                                  "conf": {"obs.mode": "off"}})
        assert code == 400
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/serve", timeout=30
        ) as r:
            stats = json.loads(r.read())
        assert stats["plan_cache"]["misses"] >= 1
        assert stats["queries_err"] >= 2
    finally:
        httpsvc.stop()


def test_post_sql_404_without_server():
    from auron_tpu_torch.utils import httpsvc

    port = httpsvc.start(0)
    try:
        code, _ = _post(port, {"sql": "select 1"})
        assert code == 404
    finally:
        httpsvc.stop()


# ---------------------------------------------------------------------------
# the concurrency differential gate, toy scale
# ---------------------------------------------------------------------------


def test_servegate_toy_bit_identity_and_zero_compiles(tables):
    from auron_tpu_torch.models import servegate

    rec = servegate.run_gate(sf=TOY_SF, clients=3, tables=tables,
                             names=["q3", "q96", "q5a"], min_speedup=0.0,
                             device="cpu")
    assert rec["ok"], rec["failures"]
    assert rec["replay_compiles"] == 0
    assert rec["concurrent_compiles"] == 0
    assert rec["concurrent"]["p50_ms"] is not None
    assert rec["trace_ids"] == 3 + 3 * 3
    assert set(rec["launches"]["serial"]) == {"q3", "q96", "q5a"}


def test_servegate_detects_divergence(tables):
    """Teeth: a server returning wrong rows must FAIL the gate."""
    from auron_tpu_torch.models import servegate

    srv = SqlServer(sqlgate.gate_catalog(), tables, n_parts=2, device="cpu")
    real_submit = srv.submit

    def flaky(sql, session=None, tenant=None):
        df, rec = real_submit(sql, session=session, tenant=tenant)
        if tenant == "client0" and len(df):
            df = df.iloc[::-1].reset_index(drop=True)  # reordered rows
        return df, rec

    srv.submit = flaky
    rec = servegate.run_gate(sf=TOY_SF, clients=2, names=["q3"],
                             min_speedup=0.0, server=srv)
    assert not rec["ok"]
    assert any("diverged" in f for f in rec["failures"])


def test_servegate_counts_a_client_error_as_a_failure(tables):
    from auron_tpu_torch.models import servegate

    srv = SqlServer(sqlgate.gate_catalog(), tables, n_parts=2, device="cpu")
    real_submit = srv.submit

    def failing(sql, session=None, tenant=None):
        if tenant == "client1":
            raise RuntimeError("injected client failure")
        return real_submit(sql, session=session, tenant=tenant)

    srv.submit = failing
    rec = servegate.run_gate(sf=TOY_SF, clients=2, names=["q96"],
                             min_speedup=0.0, server=srv)
    assert not rec["ok"]
    assert any("injected client failure" in f for f in rec["failures"])
