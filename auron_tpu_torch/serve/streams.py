"""Continuous-query serving: the POST /stream implementation (port of
``auron_tpu/serve/streams.py``).

The streaming sibling of serve/server.py's SqlServer: register a
``CREATE STREAMING VIEW`` against a registered source topic and it runs
as a long-lived :class:`StreamTaskRuntime` under its own query trace;
cancel stops the pump; inspect reads live progress (watermark, emit
sequence, lag). Admission is a hard cap — ``stream.serve.max.streams``
concurrent streams, refused loudly with 429 (a stream is not a query:
it never finishes on its own, so queue-don't-die would queue forever).

Topics bind source factories with the KafkaScanExec resource
convention: ``factory(startup_mode, offsets)`` — which is exactly what
the crash-resume path needs to seek a replacement source. Every stream
runs on the server's ``device`` (default ``cuda``; a CUDA server without
a card raises when it is made).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from auron_tpu_torch import types as T
from auron_tpu_torch.device import resolve_device
from auron_tpu_torch.exec.streaming import JsonRowDeserializer
from auron_tpu_torch.runtime.task import StreamTaskRuntime
from auron_tpu_torch.stream.lowering import lower_streaming_view
from auron_tpu_torch.stream.pipeline import StreamPipeline
from auron_tpu_torch.stream.sink import CollectSink, make_sink
from auron_tpu_torch.utils.config import (
    STREAM_SERVE_MAX_STREAMS,
    Configuration,
    active_conf,
)

#: keys a /stream request may not override (mirrors SqlServer's list)
_SESSION_DENIED_PREFIXES = ("obs.", "http.service.", "serve.",
                            "stream.serve.")


class StreamError(RuntimeError):
    """Request-level error: HTTP 400."""


class StreamBusy(RuntimeError):
    """Admission refusal: HTTP 429."""


class StreamServer:
    """In-process stream serving front end (POST /stream)."""

    def __init__(self, conf: Optional[Configuration] = None, device: str = "cuda"):
        self.device = str(resolve_device(device))
        self.conf = (conf or active_conf()).copy()
        self._lock = threading.Lock()
        self._topics: dict[str, tuple[T.Schema, Callable]] = {}
        self._streams: dict[str, dict] = {}

    # -- topology ------------------------------------------------------------

    def register_topic(self, name: str, schema: T.Schema,
                       source_factory: Callable) -> None:
        """``source_factory(startup_mode, offsets)`` builds a poll-able
        source for ``FROM <name>``."""
        with self._lock:
            self._topics[name.lower()] = (schema, source_factory)

    # -- request conf --------------------------------------------------------

    def _session_conf(self, overrides: dict | None) -> Configuration:
        from auron_tpu_torch.utils.config import _REGISTRY

        conf = self.conf.copy()
        for k, v in (overrides or {}).items():
            if any(k.startswith(p) for p in _SESSION_DENIED_PREFIXES):
                raise StreamError(
                    f"conf key {k!r} is not stream-settable (process-wide "
                    "or server-level state)")
            if k not in _REGISTRY:
                raise StreamError(f"unknown conf key {k!r}")
            conf = conf.set(k, str(v))
        return conf

    # -- actions -------------------------------------------------------------

    def register(self, sql: str, sink_spec: str = "collect",
                 conf: dict | None = None,
                 checkpoint_dir: str | None = None) -> dict:
        from auron_tpu_torch.sql.diagnostics import SqlDiagnostic

        session = self._session_conf(conf)
        try:
            view = lower_streaming_view(
                sql, self._topic_schema_probe(sql))
        except SqlDiagnostic as e:
            raise StreamError(str(e)) from None
        with self._lock:
            if view.name in self._streams:
                raise StreamError(f"stream {view.name!r} already running")
            live = sum(1 for s in self._streams.values()
                       if s["runtime"]._thread.is_alive())
            limit = self.conf.get(STREAM_SERVE_MAX_STREAMS)
            if live >= limit:
                raise StreamBusy(
                    f"{live} streams running, stream.serve.max.streams="
                    f"{limit}: cancel one first")
            schema, factory = self._topics[view.source_table.lower()]
            try:
                sink = make_sink(sink_spec)
            except ValueError as e:
                raise StreamError(str(e)) from None
            if checkpoint_dir:
                try:
                    pipeline = StreamPipeline.restore(
                        view, factory, JsonRowDeserializer(schema), sink,
                        checkpoint_dir, conf=session, device=self.device)
                except ValueError as e:
                    # checkpoint/conf drift (poll size, view name): the
                    # request is wrong, not the server
                    raise StreamError(str(e)) from None
            else:
                pipeline = StreamPipeline(
                    view, factory("earliest", {}),
                    JsonRowDeserializer(schema), sink, conf=session,
                    device=self.device)
            runtime = StreamTaskRuntime(pipeline, name=view.name)
            self._streams[view.name] = {"runtime": runtime, "sink": sink}
        return {"stream": view.name, "status": "running"}

    def _topic_schema_probe(self, sql: str) -> T.Schema:
        """Resolve the FROM topic's schema before the real lowering —
        a parse-only pass so unknown topics answer 400, not a KeyError."""
        from auron_tpu_torch.sql import sqlast as A
        from auron_tpu_torch.sql.diagnostics import SqlDiagnostic
        from auron_tpu_torch.sql.parser import parse_streaming_view

        try:
            v = parse_streaming_view(sql)
        except SqlDiagnostic as e:
            raise StreamError(str(e)) from None
        sel = v.query.body
        if isinstance(sel, A.Select) and len(sel.from_) == 1 \
                and isinstance(sel.from_[0], A.TableName):
            name = sel.from_[0].name.lower()
            with self._lock:
                if name not in self._topics:
                    raise StreamError(
                        f"unknown source topic {name!r} "
                        f"(registered: {sorted(self._topics)})")
                return self._topics[name][0]
        raise StreamError("streaming FROM must name one registered topic")

    def _get(self, name: str) -> dict:
        with self._lock:
            if name not in self._streams:
                raise StreamError(f"no stream named {name!r}")
            return self._streams[name]

    def cancel(self, name: str, drain: bool = False) -> dict:
        entry = self._get(name)
        try:
            final = entry["runtime"].stop(drain=drain)
        finally:
            with self._lock:
                self._streams.pop(name, None)
        return {"stream": name, "status": "cancelled", "final": final}

    def inspect(self, name: str) -> dict:
        entry = self._get(name)
        out = {"stream": name, **entry["runtime"].status()}
        sink = entry["sink"]
        if isinstance(sink, CollectSink):
            out["emissions"] = len(sink.emissions)
            out["tail"] = [e.to_json() for e in sink.emissions[-3:]]
        return out

    def list_streams(self) -> dict:
        with self._lock:
            names = sorted(self._streams)
        return {"streams": [self.inspect(n) for n in names]}

    # -- the POST /stream contract ------------------------------------------

    def execute_json(self, body: dict) -> dict:
        """``{"action": "register"|"cancel"|"inspect"|"list", ...}`` —
        register takes ``sql`` (+ ``sink``/``conf``/``checkpoint_dir``),
        cancel/inspect take ``stream``."""
        if not isinstance(body, dict):
            raise StreamError("body must be a JSON object")
        action = body.get("action", "register")
        if action == "register":
            if not isinstance(body.get("sql"), str):
                raise StreamError('register needs a "sql" string')
            return self.register(
                body["sql"], sink_spec=body.get("sink", "collect"),
                conf=body.get("conf"),
                checkpoint_dir=body.get("checkpoint_dir"))
        if action == "cancel":
            return self.cancel(str(body.get("stream", "")),
                               drain=bool(body.get("drain", False)))
        if action == "inspect":
            return self.inspect(str(body.get("stream", "")))
        if action == "list":
            return self.list_streams()
        raise StreamError(f"unknown action {action!r}")

    def shutdown(self) -> None:
        with self._lock:
            names = list(self._streams)
        for n in names:
            try:
                self.cancel(n)
            except RuntimeError:
                pass
