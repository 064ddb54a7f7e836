"""Serving continuous queries on the port (``auron_tpu_torch/serve/streams.py``,
``StreamTaskRuntime``, ``POST /stream``) on the CPU, beside the JAX
package's server.

Every case of ``tests/test_stream_serve.py`` on the port: register a
CREATE STREAMING VIEW against a registered topic and it runs as a
background stream under admission control (a hard cap answered 429:
streams never finish on their own, so there is nothing to queue behind);
inspect reads live watermark and emission progress; cancel stops the pump
and returns the final status; a checkpointed registration resumes. The
HTTP cases go through a real loopback socket. Where the reference's server
serves the same view over the same records, the port's collected
emissions equal its, bit for bit, and a refused request gives its message.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from auron_tpu_torch import types as T
from auron_tpu_torch.exec.streaming import MockKafkaSource
from auron_tpu_torch.serve.streams import StreamBusy, StreamError, StreamServer
from auron_tpu_torch.utils import httpsvc
from auron_tpu_torch.utils.config import (
    STREAM_CHECKPOINT_INTERVAL,
    STREAM_POLL_MAX_RECORDS,
    STREAM_SERVE_MAX_STREAMS,
    Configuration,
)

SCHEMA = T.Schema.of(T.Field("k", T.STRING), T.Field("v", T.FLOAT64), T.Field("ts", T.INT64))

VIEW = """
CREATE STREAMING VIEW orders_1s
  WATERMARK FOR ts AS ts - INTERVAL '1' SECOND
AS SELECT k, window_start, SUM(v) AS total, COUNT(*) AS n
   FROM orders
   GROUP BY k, TUMBLE(ts, INTERVAL '1' SECOND)
"""


def _records(n=600, seed=11):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        recs.append(json.dumps({
            "k": "kab"[int(rng.integers(0, 3))],
            "v": round(float(rng.random()) * 10, 3),
            "ts": int(i * 13),
        }).encode())
    return [recs[: n // 2], recs[n // 2:]]


def _factory(parts, mod=None):
    cls = MockKafkaSource if mod is None else mod.MockKafkaSource
    return lambda mode, offsets: cls(parts, startup_mode=mode, start_offsets=offsets)


class _IdleSource:
    """Never-ending, never-producing source: keeps a stream alive for the
    admission-cap cases without burning CPU on data."""

    def poll(self, max_records):
        time.sleep(0.002)
        return []

    def offsets(self):
        return {}

    def close(self):
        pass


def _conf(**overrides):
    c = Configuration()
    c.set(STREAM_POLL_MAX_RECORDS, 64)
    c.set(STREAM_CHECKPOINT_INTERVAL, 2)
    for opt, v in overrides.items():
        c.set(globals()[opt], v)
    return c


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


@pytest.fixture()
def server():
    srv = StreamServer(conf=_conf(), device="cpu")
    srv.register_topic("orders", SCHEMA, _factory(_records()))
    yield srv
    srv.shutdown()


def _reference_served(records) -> list[str]:
    """The JAX package's StreamServer over the same records, drained the
    same way: its collected emissions."""
    from auron_tpu import types as JT
    from auron_tpu.exec import streaming as JS
    from auron_tpu.serve.streams import StreamServer as JServer
    from auron_tpu.utils import config as jconfig

    c = jconfig.Configuration()
    c.set(jconfig.STREAM_POLL_MAX_RECORDS, 64)
    c.set(jconfig.STREAM_CHECKPOINT_INTERVAL, 2)
    srv = JServer(conf=c)
    srv.register_topic("orders", JT.Schema.of(JT.Field("k", JT.STRING), JT.Field("v", JT.FLOAT64),
                                              JT.Field("ts", JT.INT64)), _factory(records, JS))
    try:
        srv.register(VIEW)
        assert _wait(lambda: srv.inspect("orders_1s")["exhausted"], 120)
        sink = srv._get("orders_1s")["sink"]
        srv.cancel("orders_1s", drain=True)
        return [e.to_json() for e in sink.emissions]
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# the in-process server
# ---------------------------------------------------------------------------


def test_register_inspect_cancel(server):
    out = server.register(VIEW)
    assert out == {"stream": "orders_1s", "status": "running"}
    # the mock topic is finite: the pump drains it and parks as exhausted
    assert _wait(lambda: server.inspect("orders_1s")["exhausted"])
    st = server.inspect("orders_1s")
    assert st["steps"] > 0 and st["error"] is None
    assert st["watermark_ms"] is not None and st["emit_seq"] > 0
    assert st["emissions"] == st["emit_seq"] and len(st["tail"]) == 3
    sink = server._get("orders_1s")["sink"]
    final = server.cancel("orders_1s", drain=True)
    assert final["status"] == "cancelled"
    # drain force-closed the windows still inside the watermark delay
    assert final["final"]["open_groups"] == 0
    assert final["final"]["emit_seq"] > st["emit_seq"]
    with pytest.raises(StreamError, match="no stream"):
        server.inspect("orders_1s")
    assert [e.to_json() for e in sink.emissions] == _reference_served(_records())


def test_duplicate_name_refused(server):
    server.register(VIEW)
    with pytest.raises(StreamError, match="already running"):
        server.register(VIEW)


def test_unknown_topic_is_a_request_error(server):
    with pytest.raises(StreamError, match="unknown source topic"):
        server.register(VIEW.replace("FROM orders", "FROM nope"))


def test_sql_diagnostics_surface_as_request_errors(server):
    from auron_tpu.serve.streams import StreamError as JError
    from auron_tpu.serve.streams import StreamServer as JServer

    bad = "CREATE STREAMING VIEW x AS SELECT k, COUNT(*) AS n FROM orders GROUP BY k"
    with pytest.raises(StreamError, match="TUMBLE") as got:
        server.register(bad)
    jsrv = JServer()
    from auron_tpu import types as JT

    jsrv.register_topic("orders", JT.Schema.of(JT.Field("k", JT.STRING), JT.Field("v", JT.FLOAT64),
                                               JT.Field("ts", JT.INT64)), lambda m, o: None)
    with pytest.raises(JError) as want:
        jsrv.register(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(StreamError, match='"sql"'):
        server.execute_json({"action": "register"})
    with pytest.raises(StreamError, match="unknown action"):
        server.execute_json({"action": "explode"})


def test_session_conf_denial(server):
    for bad in ("serve.plan.cache.capacity", "obs.mode", "stream.serve.max.streams"):
        with pytest.raises(StreamError, match="not stream-settable"):
            server.register(VIEW, conf={bad: "1"})
    with pytest.raises(StreamError, match="unknown conf key"):
        server.register(VIEW, conf={"no.such.knob": "1"})
    # stream runtime knobs ARE session-settable
    server.register(VIEW, conf={"stream.poll.max.records": "32"})
    assert server.inspect("orders_1s")["name"] == "orders_1s"


def test_admission_cap_refuses_not_queues():
    srv = StreamServer(conf=_conf(STREAM_SERVE_MAX_STREAMS=1), device="cpu")
    srv.register_topic("orders", SCHEMA, lambda mode, off: _IdleSource())
    try:
        srv.register(VIEW)
        with pytest.raises(StreamBusy, match="stream.serve.max.streams=1"):
            srv.register(VIEW.replace("orders_1s", "orders_1s_b"))
        # cancelling the live stream frees the slot
        srv.cancel("orders_1s")
        out = srv.register(VIEW.replace("orders_1s", "orders_1s_b"))
        assert out["status"] == "running"
    finally:
        srv.shutdown()


def test_checkpoint_resume_through_serving(server, tmp_path):
    ck = str(tmp_path / "ck")
    server.register(VIEW, checkpoint_dir=ck)
    assert _wait(lambda: server.inspect("orders_1s")["exhausted"])
    first = server.cancel("orders_1s")["final"]
    assert first["checkpoints"] > 0
    # a new registration against the same dir resumes, not replays: the
    # restored pipeline starts at the checkpointed sequence
    server.register(VIEW, checkpoint_dir=ck)
    assert _wait(lambda: server.inspect("orders_1s")["exhausted"])
    st = server.inspect("orders_1s")
    assert st["steps"] <= first["steps"]
    assert st["emit_seq"] >= first["emit_seq"]
    server.cancel("orders_1s")
    # drifting the micro-batch size against the checkpoint is refused
    with pytest.raises(StreamError, match="poll.max.records"):
        server.register(VIEW, conf={"stream.poll.max.records": "16"}, checkpoint_dir=ck)


# ---------------------------------------------------------------------------
# POST /stream over a real socket
# ---------------------------------------------------------------------------


def _post(port, body, path="/stream"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        raw = e.read().decode()
        try:
            return e.code, json.loads(raw)
        except ValueError:
            return e.code, {"error": raw}


@pytest.fixture()
def http_stream(server):
    port = httpsvc.start(0)
    httpsvc.install_stream_server(server)
    yield port
    httpsvc.stop()


def test_http_stream_lifecycle(http_stream, server):
    port = http_stream
    code, out = _post(port, {"action": "register", "sql": VIEW})
    assert code == 200 and out["status"] == "running"
    assert _wait(lambda: server.inspect("orders_1s")["exhausted"])
    code, st = _post(port, {"action": "inspect", "stream": "orders_1s"})
    assert code == 200 and st["emit_seq"] > 0
    code, ls = _post(port, {"action": "list"})
    assert code == 200 and [s["stream"] for s in ls["streams"]] == ["orders_1s"]
    code, fin = _post(port, {"action": "cancel", "stream": "orders_1s", "drain": True})
    assert code == 200 and fin["status"] == "cancelled"
    code, ls = _post(port, {"action": "list"})
    assert code == 200 and ls == {"streams": []}


def test_http_stream_error_codes(http_stream):
    port = http_stream
    code, out = _post(port, {"action": "inspect", "stream": "ghost"})
    assert code == 400 and "no stream" in out["error"]
    code, out = _post(port, {"action": "register", "sql": "SELECT 1"})
    assert code == 400 and "error" in out
    # no server installed -> 404, not 500
    httpsvc.install_stream_server(None)
    code, out = _post(port, {"action": "list"})
    assert code == 404


def test_http_stream_429_when_full():
    srv = StreamServer(conf=_conf(STREAM_SERVE_MAX_STREAMS=1), device="cpu")
    srv.register_topic("orders", SCHEMA, lambda mode, off: _IdleSource())
    port = httpsvc.start(0)
    httpsvc.install_stream_server(srv)
    try:
        code, _ = _post(port, {"action": "register", "sql": VIEW})
        assert code == 200
        code, out = _post(port, {"action": "register",
                                 "sql": VIEW.replace("orders_1s", "orders_1s_b")})
        assert code == 429 and "max.streams" in out["error"]
    finally:
        httpsvc.stop()
        srv.shutdown()


def test_served_stream_runs_under_its_own_trace(http_stream, server):
    """The pump runs the whole stream under one ``stream.<view>`` trace:
    its summary lands on /queries when the stream ends."""
    from auron_tpu_torch import obs

    prev = obs.mode_name()
    obs.set_mode("recorder")
    try:
        server.register(VIEW)
        assert _wait(lambda: server.inspect("orders_1s")["exhausted"])
        server.cancel("orders_1s")
        with urllib.request.urlopen(f"http://127.0.0.1:{http_stream}/queries", timeout=30) as r:
            names = [q["name"] for q in json.loads(r.read().decode())]
        assert "stream.orders_1s" in names
    finally:
        obs.set_mode(prev)


def test_a_cuda_stream_server_without_a_card_raises():
    """No fallback: a stream server on ``cuda`` without a card raises when
    it is made (and so does a pipeline)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA server is real here")
    with pytest.raises(RuntimeError, match="cuda"):
        StreamServer(conf=_conf())
    from auron_tpu_torch.exec.streaming import JsonRowDeserializer
    from auron_tpu_torch.stream import CollectSink, StreamPipeline, lower_streaming_view

    with pytest.raises(RuntimeError, match="cuda"):
        StreamPipeline(lower_streaming_view(VIEW, SCHEMA), MockKafkaSource(_records()),
                       JsonRowDeserializer(SCHEMA), CollectSink(), conf=_conf())
