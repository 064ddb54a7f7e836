"""In-process observability HTTP service (port of
``auron_tpu/utils/httpsvc.py``).

Analog of the reference's feature-gated HTTP service exposing CPU pprof
and heap profiles (auron/src/http/mod.rs:10-95, http/pprof.rs,
http/memory_profiling.rs). The engine's equivalents:

- /metrics      — JSON metric trees of every live task runtime plus the
                  memory manager's budget/consumer state
- /metrics.prom — the same state as Prometheus 0.0.4 text exposition
                  (MetricNode.flat_totals + EngineCounters with
                  task/stage/partition/operator labels; obs/export.py)
- /trace        — the flight recorder's rings as Chrome/Perfetto
                  trace-event JSON; ``?last=<seconds>`` limits to the
                  recent window, ``?trace=<id>`` to one query trace
- /queries      — recent finished query-trace summaries (newest first)
- /stacks       — all-thread python stack dump (the flamegraph source:
                  feed repeated samples to any folded-stack tool)
- /conf         — the resolved configuration registry
- /healthz      — liveness

With a SQL server installed (install_sql_server) the service is also the
query front door:

- POST /sql     — execute one query: body {"sql": ..., "conf": {...}?,
                  "tenant": ...?} -> {"columns", "rows", digest,
                  cache_hit, trace_id, timings}. 400 on bad requests
                  (unknown conf key, SQL diagnostics), 503 when the
                  admission queue's bound fires, 500 otherwise.
- /serve        — server stats: plan-cache hit/miss/eviction counts,
                  admission occupancy/queue, per-server query counters.

With a stream server installed (install_stream_server) the service
also fronts continuous queries:

- POST /stream  — {"action": "register"|"cancel"|"inspect"|"list",
                  ...}: register a CREATE STREAMING VIEW, cancel or
                  inspect a running stream. 400 on bad requests, 429
                  when stream.serve.max.streams streams already run
                  (streams never finish on their own, so the admission
                  bound refuses instead of queueing).

Gated by ``http.service.enable`` (off by default, like the reference's
feature flag); the bridge starts it lazily on the first task when
enabled (``bridge/api.call_native``). A handler exception answers 500 and never propagates into task
threads — observability must not fail queries.

The service speaks HTTP/1.1 with persistent connections: serving
clients send many ``POST /sql`` requests over one socket instead of
paying TCP setup per query. Request bodies are always drained before a
response (keep-alive framing), bounded by ``_MAX_BODY``.
"""

from __future__ import annotations

import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from auron_tpu_torch.utils.config import bool_conf, int_conf

HTTP_SERVICE_ENABLE = bool_conf(
    "http.service.enable", False, "observability",
    "serve /metrics /stacks /conf /healthz from an in-process HTTP "
    "service (auron/src/http feature analog)",
)
HTTP_SERVICE_PORT = int_conf(
    "http.service.port", 0, "observability",
    "port for the observability service (0 = ephemeral)",
)

_lock = threading.Lock()
_server: ThreadingHTTPServer | None = None
_port: int | None = None
#: Configuration snapshotted at start(): handler threads must not read
#: the thread-local active_conf() — they'd see whatever conf the SERVING
#: thread happens to carry, not the conf the service was started under
_conf = None
#: installed SqlServer (serve/server.py); POST /sql and /serve 404 until
#: a host installs one — observability endpoints never depend on it
_sql_server = None
#: installed StreamServer (serve/streams.py); POST /stream 404s until
#: a host installs one
_stream_server = None


def install_sql_server(server) -> None:
    """Install (or with None, uninstall) the SqlServer behind POST /sql."""
    global _sql_server
    with _lock:
        _sql_server = server


def install_stream_server(server) -> None:
    """Install (or with None, uninstall) the StreamServer behind
    POST /stream."""
    global _stream_server
    with _lock:
        _stream_server = server


def _metrics_payload() -> dict:
    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.memory.memmgr import MemManager

    with api._lock:
        runtimes = dict(api._runtimes)
    tasks = {}
    for h, rt in runtimes.items():
        tasks[str(h)] = {
            "stage": rt.ctx.stage_id,
            "partition": rt.ctx.partition_id,
            "metrics": rt.ctx.metrics.snapshot(),
        }
    return {
        "tasks": tasks,
        "memory": MemManager.get().mem_snapshot(),
    }


def _stacks_payload() -> str:
    import sys

    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


#: bound on the POST /sql body the handler will drain before answering:
#: keep-alive framing requires consuming the body even on early-return
#: paths, and an unbounded Content-Length would let one request park the
#: handler thread on a multi-GB read
_MAX_BODY = 64 << 20


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1: connections persist across requests so serving clients
    # stop paying per-request TCP setup (every response carries
    # Content-Length via _send, which 1.1 framing requires)
    protocol_version = "HTTP/1.1"
    #: idle keep-alive connections release their handler thread after
    #: this many seconds (handle_one_request treats the socket timeout
    #: as close_connection) — without it an abandoned client parks a
    #: ThreadingHTTPServer thread forever
    timeout = 60

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, body: bytes, content_type: str, code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            # tell the client, not just the socket: without the header a
            # 1.1 client would assume keep-alive and race our close
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        try:
            from urllib.parse import parse_qs, urlsplit

            parts = urlsplit(self.path)
            path, qs = parts.path, parse_qs(parts.query)
            if path == "/healthz":
                self._send(b"ok\n", "text/plain")
            elif path == "/metrics":
                self._send(
                    json.dumps(_metrics_payload(), indent=2).encode(),
                    "application/json",
                )
            elif path == "/metrics.prom":
                from auron_tpu_torch.obs import export

                self._send(
                    export.prometheus_text().encode(),
                    "text/plain; version=0.0.4",
                )
            elif path == "/trace":
                from auron_tpu_torch.obs import export

                last = qs.get("last", [None])[0]
                trace = qs.get("trace", [None])[0]
                payload = export.chrome_trace(
                    last_s=float(last) if last is not None else None,
                    trace_id=int(trace) if trace is not None else None,
                )
                self._send(json.dumps(payload).encode(), "application/json")
            elif path == "/queries":
                from auron_tpu_torch import obs

                self._send(
                    json.dumps(obs.recent_queries(), indent=2).encode(),
                    "application/json",
                )
            elif path == "/serve":
                srv = _sql_server
                if srv is None:
                    self._send(b"no sql server installed\n", "text/plain", 404)
                else:
                    self._send(
                        json.dumps(srv.stats(), indent=2).encode(),
                        "application/json",
                    )
            elif path == "/stacks":
                self._send(_stacks_payload().encode(), "text/plain")
            elif path == "/conf":
                from auron_tpu_torch.utils.config import _REGISTRY, Configuration

                conf = _conf if _conf is not None else Configuration()
                payload = {
                    k: repr(conf.get(o)) for k, o in sorted(_REGISTRY.items())
                }
                self._send(
                    json.dumps(payload, indent=2).encode(), "application/json"
                )
            else:
                self._send(b"not found\n", "text/plain", 404)
        except Exception as e:  # noqa: BLE001 — observability must not crash tasks
            self._send(f"error: {e}\n".encode(), "text/plain", 500)

    def do_POST(self):  # noqa: N802 — http.server API
        try:
            # drain the body FIRST, before any early-return response:
            # with keep-alive, unread body bytes would be parsed as the
            # start of the NEXT request and corrupt the connection
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except (ValueError, TypeError):
                n = -1
            if n < 0 or n > _MAX_BODY:
                self.close_connection = True
                self._send(b"bad request body: unacceptable "
                           b"Content-Length\n", "text/plain", 400)
                return
            raw = self.rfile.read(n)
            path = self.path.split("?", 1)[0]
            if path == "/stream":
                self._post_stream(raw)
                return
            if path != "/sql":
                self._send(b"not found\n", "text/plain", 404)
                return
            srv = _sql_server
            if srv is None:
                self._send(b"no sql server installed\n", "text/plain", 404)
                return
            # serve imports AFTER the 404 checks and INSIDE the try: a
            # stray POST to an observability-only service must not pay
            # (or crash the handler on) the serve import — the contract
            # is "a handler exception answers 500"
            from auron_tpu_torch.serve.admission import AdmissionTimeout
            from auron_tpu_torch.serve.server import QueryError

            try:
                body = json.loads(raw or b"{}")
            except (ValueError, TypeError) as e:
                self._send(f"bad request body: {e}\n".encode(),
                           "text/plain", 400)
                return
            try:
                payload = srv.execute_json(body)
            except QueryError as e:
                self._send(
                    json.dumps({"error": str(e)}).encode(),
                    "application/json", 400)
                return
            except AdmissionTimeout as e:
                # queue-don't-die's bound: busy, retry later
                self._send(
                    json.dumps({"error": str(e)}).encode(),
                    "application/json", 503)
                return
            self._send(json.dumps(payload).encode(), "application/json")
        except Exception as e:  # noqa: BLE001 — the service must survive
            # conservative: after an arbitrary handler failure the
            # request-stream position is not trustworthy for reuse
            self.close_connection = True
            self._send(f"error: {e}\n".encode(), "text/plain", 500)

    def _post_stream(self, raw: bytes) -> None:
        srv = _stream_server
        if srv is None:
            self._send(b"no stream server installed\n", "text/plain", 404)
            return
        from auron_tpu_torch.serve.streams import StreamBusy, StreamError

        try:
            body = json.loads(raw or b"{}")
        except (ValueError, TypeError) as e:
            self._send(f"bad request body: {e}\n".encode(), "text/plain", 400)
            return
        try:
            payload = srv.execute_json(body)
        except StreamError as e:
            self._send(json.dumps({"error": str(e)}).encode(), "application/json", 400)
            return
        except StreamBusy as e:
            # the stream admission bound: refuse, never queue — a stream
            # would hold its queue slot forever
            self._send(json.dumps({"error": str(e)}).encode(), "application/json", 429)
            return
        self._send(json.dumps(payload).encode(), "application/json")


def start(port: int = 0, conf=None) -> int:
    """Start (or return) the service; returns the bound port. ``conf`` is
    snapshotted for the handler threads (/conf endpoint)."""
    global _server, _port, _conf
    with _lock:
        # record the conf even when the server is already running: a
        # conf-less start() (tests, manual bring-up) followed by the
        # bridge's maybe_start_from_conf must not leave /conf serving
        # defaults for the rest of the process
        if conf is not None and _conf is None:
            _conf = conf
        if _server is not None:
            return _port
        _server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        _port = _server.server_address[1]
        t = threading.Thread(
            target=_server.serve_forever, daemon=True, name="auron-http-svc"
        )
        t.start()
        return _port


def stop() -> None:
    global _server, _port, _conf, _sql_server, _stream_server
    with _lock:
        if _server is not None:
            _server.shutdown()
            _server.server_close()
            _server = None
            _port = None
            _conf = None
        # full teardown regardless of whether the service was running: a
        # stale installed server must not resurface on the next start()
        _sql_server = None
        _stream_server = None


def maybe_start_from_conf(conf) -> int | None:
    """Lazy conf-gated start (called by the bridge on task entry)."""
    if not conf.get(HTTP_SERVICE_ENABLE):
        return None
    return start(conf.get(HTTP_SERVICE_PORT), conf=conf)
