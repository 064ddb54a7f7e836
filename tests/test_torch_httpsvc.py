"""The port's observability HTTP service (``auron_tpu_torch/utils/httpsvc.py``)
on an ephemeral loopback port, on the CPU.

Every case of ``tests/test_httpsvc.py`` on the port's task runtimes, plus:
``POST /stream`` answers 404 (the port has no stream server yet), and a
subprocess imports ``auron_tpu_torch.serve``, ``.obs``, ``.utils.httpsvc``
and ``.utils.profiling`` and serves ``/healthz``, ``/metrics``,
``/metrics.prom``, ``/trace`` and ``/queries`` around a live task with
jax, ``auron_tpu``, pyarrow, pandas and ``google.protobuf`` blocked.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from auron_tpu_torch import types as T
from auron_tpu_torch.bridge import api
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exprs.ir import col
from auron_tpu_torch.plan import builders as B
from auron_tpu_torch.utils import httpsvc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = T.Schema((T.Field("v", T.INT64),))


@pytest.fixture(scope="module", autouse=True)
def _leak_canary():
    """The port's task runtimes, resource map and obs rings are as this
    module found them (suite-spawned threads owning a ring have exited)."""
    import time

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


@pytest.fixture()
def svc():
    port = httpsvc.start(0)
    yield port
    httpsvc.stop()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read().decode()


def _rows(n: int) -> Batch:
    return Batch.from_numpy([np.arange(n, dtype=np.int64)], SCHEMA, device="cpu")


def _sum_task(rid: str) -> bytes:
    plan = B.hash_agg(B.memory_scan(SCHEMA, rid), [], [("sum", col(0), "s")], "partial")
    return B.task(plan).SerializeToString()


def test_healthz_and_conf(svc):
    code, body = _get(svc, "/healthz")
    assert code == 200 and body == "ok\n"
    code, body = _get(svc, "/conf")
    conf = json.loads(body)
    assert "exchange.mode" in conf and "batch.size" in conf


def test_metrics_expose_live_tasks(svc):
    api.put_resource("http_rows", [[_rows(100)]])
    try:
        h = api.call_native(_sum_task("http_rows"), device="cpu")
        code, body = _get(svc, "/metrics")
        payload = json.loads(body)
        assert code == 200
        assert str(h) in payload["tasks"]
        assert "budget_bytes" in payload["memory"]
        while api.next_batch(h) is not None:
            pass
        api.finalize_native(h)
    finally:
        api.remove_resource("http_rows")


def test_stacks_dump(svc):
    code, body = _get(svc, "/stacks")
    assert code == 200
    assert "--- thread" in body and "MainThread" in body


# ---------------------------------------------------------------------------
# full endpoint sweep during a LIVE query (old and new endpoints)
# ---------------------------------------------------------------------------

_PROM_LINE = re.compile(
    r"^(?:# (?:HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^{}]*\})? -?[0-9.eE+-]+(?:nan|inf)?)$"
)


def _parse_prom(body: str) -> dict[str, list[str]]:
    """Validate Prometheus 0.0.4 text exposition; returns family->lines."""
    families: dict[str, list[str]] = {}
    declared: list[str] = []
    for ln in body.splitlines():
        if not ln.strip():
            continue
        assert _PROM_LINE.match(ln), f"bad exposition line: {ln!r}"
        if ln.startswith("# TYPE "):
            name = ln.split()[2]
            assert name not in declared, f"duplicate family {name}"
            declared.append(name)
        elif not ln.startswith("#"):
            name = ln.split("{")[0].split()[0]
            families.setdefault(name, []).append(ln)
    for name in families:
        assert name in declared, f"sample without TYPE: {name}"
    for name, lines in families.items():
        series = [ln.rsplit(" ", 1)[0] for ln in lines]
        assert len(series) == len(set(series)), f"duplicate series in {name}"
    return families


def test_every_endpoint_during_live_query(svc):
    from auron_tpu_torch import obs
    from auron_tpu_torch.utils.profiling import EngineCounters

    EngineCounters.install()
    api.put_resource("http_live", [[_rows(5000)] * 4])
    try:
        with obs.query_trace("http_live_query") as qt:
            h = api.call_native(_sum_task("http_live"), device="cpu")
            for path in ("/healthz", "/metrics", "/metrics.prom", "/stacks",
                         "/conf", "/trace", "/trace?last=60", "/queries"):
                code, body = _get(svc, path)
                assert code == 200, (path, body[:200])
            code, prom = _get(svc, "/metrics.prom")
            fams = _parse_prom(prom)
            assert "auron_engine_batches_total" in prom
            while api.next_batch(h) is not None:
                pass
            api.finalize_native(h)
        code, body = _get(svc, "/queries")
        assert code == 200
        qs = json.loads(body)
        assert any(q["trace_id"] == qt.trace.id for q in qs)
        code, body = _get(svc, f"/trace?trace={qt.trace.id}")
        ct = json.loads(body)
        xs = [e for e in ct["traceEvents"] if e["ph"] == "X"]
        assert xs and all(e["pid"] == qt.trace.id for e in xs)
        assert any(e["cat"] == "pump" for e in xs)  # the pump's batches
        assert fams
    finally:
        api.remove_resource("http_live")


def test_prom_label_escaping_and_single_family():
    from auron_tpu_torch.obs.export import render_prometheus

    body = render_prometheus(
        tasks={
            "1": {"stage": 0, "partition": 0,
                  "ops": {'We"ird\\Op\n': {"elapsed_compute": 5}}},
            "2": {"stage": 1, "partition": 1,
                  "ops": {'We"ird\\Op\n': {"elapsed_compute": 7}}},
        },
        counters={"compiles": 1, "host_syncs": 2},
        memory={"budget_bytes": 10, "num_spills": 0,
                "consumers": [{"name": "dup", "mem_used": 3},
                              {"name": "dup", "mem_used": 4}]},
        queries=0,
    )
    fams = _parse_prom(body)
    assert len(fams["auron_op_metric"]) == 2
    assert fams["auron_memory_consumer_bytes"] == [
        'auron_memory_consumer_bytes{consumer="dup"} 7'
    ]
    assert '\\"' in body and "\\\\" in body and "\\n" in body


def test_handler_exception_500s_but_never_kills_service_or_task(svc, monkeypatch):
    def boom() -> dict:
        raise RuntimeError("kaboom")

    monkeypatch.setattr(httpsvc, "_metrics_payload", boom)
    api.put_resource("http_boom", [[_rows(100)]])
    try:
        h = api.call_native(_sum_task("http_boom"), device="cpu")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(svc, "/metrics")
        assert ei.value.code == 500
        code, _ = _get(svc, "/healthz")
        assert code == 200
        out = []
        while (b := api.next_batch(h)) is not None:
            out.append(b)
        assert sum(next(iter(b.to_pydict().values()))[0] for b in out) == sum(range(100))
        api.finalize_native(h)
    finally:
        api.remove_resource("http_boom")


def test_metrics_snapshot_hammer_under_mutation(svc):
    from auron_tpu_torch.exec.metrics import MetricNode

    node = MetricNode("root")
    stop = threading.Event()

    def mutate():
        i = 0
        while not stop.is_set():
            node.add(f"m{i % 997}", 1)
            node.child(i % 7).add("elapsed_compute", 1)
            i += 1

    t = threading.Thread(target=mutate, daemon=True)
    t.start()
    try:
        for _ in range(300):
            snap = node.snapshot()
            assert "values" in snap
    finally:
        stop.set()
        t.join()


def test_keepalive_connection_reused_across_requests(svc):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", svc, timeout=10)
    try:
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and not r.will_close
        r.read()
        sock = conn.sock
        assert sock is not None
        for _ in range(3):
            conn.request("GET", "/conf")
            r = conn.getresponse()
            assert r.status == 200
            json.loads(r.read())
            assert conn.sock is sock
    finally:
        conn.close()


def test_keepalive_post_sql_drains_body_on_early_return_paths(svc):
    import http.client

    class _Srv:
        def execute_json(self, body):
            return {"echo": body.get("sql")}

        def stats(self):
            return {}

    httpsvc.install_sql_server(_Srv())
    conn = http.client.HTTPConnection("127.0.0.1", svc, timeout=10)
    try:
        conn.request("POST", "/sql", body=json.dumps({"sql": "q1"}))
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["echo"] == "q1"
        sock = conn.sock
        conn.request("POST", "/nope", body=b"x" * 4096)
        r = conn.getresponse()
        assert r.status == 404
        r.read()
        assert conn.sock is sock
        conn.request("POST", "/sql", body=json.dumps({"sql": "q2"}))
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["echo"] == "q2"
        assert conn.sock is sock
    finally:
        conn.close()
        httpsvc.install_sql_server(None)


def test_post_stream_404s_without_a_stream_server(svc):
    """The port has no stream server: POST /stream answers 404 and drains
    its body (the connection stays usable)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", svc, timeout=10)
    try:
        conn.request("POST", "/stream", body=json.dumps({"action": "list"}))
        r = conn.getresponse()
        assert r.status == 404
        r.read()
        sock = conn.sock
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and r.read() == b"ok\n"
        assert conn.sock is sock
    finally:
        conn.close()
    assert not hasattr(httpsvc, "install_stream_server")


def test_keepalive_unacceptable_content_length_400s_and_closes(svc):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", svc, timeout=10)
    try:
        conn.putrequest("POST", "/sql")
        conn.putheader("Content-Length", str(httpsvc._MAX_BODY + 1))
        conn.endheaders()
        r = conn.getresponse()
        assert r.status == 400
        assert r.will_close
        r.read()
    finally:
        conn.close()


def test_conf_gated_autostart():
    from auron_tpu_torch.utils.config import Configuration

    assert httpsvc.maybe_start_from_conf(Configuration()) is None
    port = httpsvc.maybe_start_from_conf(
        Configuration().set(httpsvc.HTTP_SERVICE_ENABLE, True)
    )
    try:
        assert port is not None
        code, _ = _get(port, "/healthz")
        assert code == 200
    finally:
        httpsvc.stop()


def test_task_conf_starts_the_service():
    """The bridge starts the service on a task whose conf enables it."""
    api.put_resource("http_auto", [[_rows(10)]])
    try:
        plan = B.hash_agg(B.memory_scan(SCHEMA, "http_auto"), [], [("sum", col(0), "s")],
                          "partial")
        task = B.task(plan, conf={"http.service.enable": "true"}).SerializeToString()
        h = api.call_native(task, device="cpu")
        try:
            assert httpsvc._port is not None
            code, _ = _get(httpsvc._port, "/healthz")
            assert code == 200
        finally:
            while api.next_batch(h) is not None:
                pass
            api.finalize_native(h)
    finally:
        api.remove_resource("http_auto")
        httpsvc.stop()


def test_serving_modules_import_without_jax_arrow_pandas_or_protobuf():
    script = textwrap.dedent("""
        import json, sys, urllib.request
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "jaxlib", "auron_tpu"):
            sys.modules[m] = None  # any import of them raises ImportError
        import numpy as np
        import auron_tpu_torch.serve, auron_tpu_torch.obs
        import auron_tpu_torch.utils.httpsvc as httpsvc
        import auron_tpu_torch.utils.profiling, auron_tpu_torch.models.servegate
        from auron_tpu_torch import obs, types as T
        from auron_tpu_torch.bridge import api
        from auron_tpu_torch.columnar.batch import Batch
        from auron_tpu_torch.exprs.ir import col
        from auron_tpu_torch.plan import builders as B
        auron_tpu_torch.utils.profiling.EngineCounters.install()
        schema = T.Schema((T.Field("v", T.INT64),))
        api.put_resource("r", [[Batch.from_numpy([np.arange(1000)], schema, device="cpu")] * 3])
        plan = B.hash_agg(B.memory_scan(schema, "r"), [], [("sum", col(0), "s")], "partial")
        port = httpsvc.start(0)
        with obs.query_trace("noimports"):
            h = api.call_native(B.task(plan).SerializeToString(), device="cpu")
            for path in ("/healthz", "/metrics", "/metrics.prom", "/trace?last=60",
                         "/queries"):
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
                    assert r.status == 200, path
            total = 0
            while (b := api.next_batch(h)) is not None:
                total += next(iter(b.to_pydict().values()))[0]
            api.finalize_native(h)
        assert total == 3 * sum(range(1000)), total
        httpsvc.stop()
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "auron_tpu", "pandas")
               or m.startswith(("pyarrow", "google.protobuf"))]
        assert not [m for m in bad if sys.modules[m] is not None], bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
