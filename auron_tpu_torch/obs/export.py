"""Exporters: Chrome/Perfetto trace JSON, Prometheus text, query ring
(port of ``auron_tpu/obs/export.py``). They read the port's task
runtimes (``bridge/api._runtimes``), ``MemManager`` and
``EngineCounters``; the Prometheus text is the reference's but for the
help of ``auron_engine_compiles_total``: a compile here is a CUDA graph
capture or a kernel build (``utils/profiling.py``).

Three views of the same recorded state:

- ``chrome_trace()``   — the flight recorder's rings as Chrome
  trace-event JSON (loadable in Perfetto / chrome://tracing): one
  "process" per trace id (pid = trace, so per-query attribution is the
  grouping), one "thread" row per recorder ring, complete ("X") events
  for spans/timers and the compile/sync/spill/harvest event stream.
- ``prometheus_text()`` — ``MetricNode.flat_totals`` of every LIVE task
  plus the process-wide ``EngineCounters`` rendered as Prometheus 0.0.4
  text exposition with task/stage/partition/operator labels
  (``/metrics.prom``).
- the recent-queries ring (obs/span.py) served at ``/queries``.
"""

from __future__ import annotations

import json

from auron_tpu_torch.obs import core

# ---------------------------------------------------------------------------
# Chrome / Perfetto trace-event JSON
# ---------------------------------------------------------------------------


def chrome_trace(last_s: float | None = None,
                 trace_id: int | None = None) -> dict:
    """Trace-event JSON object for the recorder's current contents."""
    groups = core.snapshot_events(last_s=last_s, trace_id=trace_id)
    events: list[dict] = []
    named: set = set()
    for ring, evs in groups:
        tid = ring["tid"]
        for (ts, dur, kind, name, tr, sp, parent, arg) in evs:
            if (tr, tid) not in named:
                named.add((tr, tid))
                events.append({
                    "ph": "M", "name": "thread_name", "pid": tr, "tid": tid,
                    "args": {"name": ring["name"]},
                })
            if isinstance(arg, dict):
                args = dict(arg)
            elif kind == "op":
                # carry op + raw metric name so consumers can re-derive
                # per-op totals under the MetricNode.op_seconds rules
                args = {"op": arg, "metric": name}
            elif arg is not None:
                args = {"arg": arg}
            else:
                args = {}
            if sp:
                args["span"] = sp
            if parent:
                args["parent"] = parent
            events.append({
                "ph": "X",
                "name": f"{arg}.{name}" if kind == "op" and arg else name,
                "cat": kind,
                "ts": ts / 1e3,        # trace-event time unit is us
                "dur": max(dur / 1e3, 0.001),
                "pid": tr,
                "tid": tid,
                "args": args,
            })
    for tr_id, tr_name in _trace_names():
        events.append({
            "ph": "M", "name": "process_name", "pid": tr_id,
            "args": {"name": tr_name},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _trace_names() -> list[tuple[int, str]]:
    # NOTE: the module is fetched via sys.modules — ``from auron_tpu_torch.obs
    # import span`` would resolve to the re-exported span CLASS
    import sys

    _span = sys.modules["auron_tpu_torch.obs.span"]
    out = [(0, "untraced")]
    with _span._traces_lock:
        out += [(t.id, f"{t.kind}:{t.name}") for t in _span._traces.values()]
    with _span._recent_lock:
        out += [(s["trace_id"], f"{s['kind']}:{s['name']}")
                for s in _span._recent]
    return out


def write_chrome_trace(path: str, last_s: float | None = None,
                       trace_id: int | None = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(last_s=last_s, trace_id=trace_id), f)
    return path


def trace_out_arg(argv, env_key: str) -> str | None:
    """THE ``--trace-out[=]PATH`` scanner of the scripts that write a
    trace (``env_key`` is each script's fallback variable)."""
    import os

    for i, a in enumerate(argv):
        if a.startswith("--trace-out="):
            return a.split("=", 1)[1]
        if a == "--trace-out" and i + 1 < len(argv):
            return argv[i + 1]
    return os.environ.get(env_key) or None


# ---------------------------------------------------------------------------
# Prometheus text exposition (0.0.4)
# ---------------------------------------------------------------------------


def _label_escape(v) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels(d: dict) -> str:
    return "{" + ",".join(
        f'{k}="{_label_escape(v)}"' for k, v in d.items()
    ) + "}"


def render_prometheus(tasks: dict, counters: dict | None,
                      memory: dict | None, queries: int) -> str:
    """Pure renderer (unit-testable with crafted label values). Each
    family is emitted exactly once with one HELP/TYPE block — the
    duplicate-family pitfall — and label values are escaped."""
    fams: list[tuple[str, str, str, list[str]]] = []

    def fam(name: str, typ: str, help_: str, lines: list[str]) -> None:
        if lines:
            fams.append((name, typ, help_, lines))

    if counters:
        for key, typ, help_ in (
            ("compiles", "counter", "CUDA graph captures and kernel builds"),
            ("compile_s", "counter", "seconds spent compiling"),
            ("host_syncs", "counter", "blocking device->host syncs"),
            ("host_sync_s", "counter", "seconds blocked in host syncs"),
            ("async_reads", "counter", "async-window harvests"),
            ("async_read_s", "counter", "seconds harvesting async reads"),
            ("batches", "counter", "batches pumped through task runtimes"),
        ):
            if key in counters:
                fam(f"auron_engine_{key}_total", typ, help_,
                    [f"auron_engine_{key}_total {counters[key]}"])
    if memory:
        fam("auron_memory_budget_bytes", "gauge", "memory-manager budget",
            [f"auron_memory_budget_bytes {memory.get('budget_bytes', 0)}"])
        fam("auron_memory_spills_total", "counter", "spills dispatched",
            [f"auron_memory_spills_total {memory.get('num_spills', 0)}"])
        by_name: dict[str, int] = {}
        for c in memory.get("consumers", ()):  # same name may repeat: sum
            by_name[c["name"]] = by_name.get(c["name"], 0) + int(c["mem_used"])
        fam("auron_memory_consumer_bytes", "gauge",
            "registered consumer memory by name",
            [f"auron_memory_consumer_bytes{_labels({'consumer': n})} {v}"
             for n, v in sorted(by_name.items())])

    from auron_tpu_torch.exec.metrics import MetricNode

    op_lines: list[str] = []
    sec_lines: list[str] = []
    for task, t in sorted(tasks.items()):
        base = {"task": task, "stage": t["stage"], "partition": t["partition"]}
        for op, tot in sorted(t["ops"].items()):
            for metric, val in sorted(tot.items()):
                op_lines.append(
                    "auron_op_metric"
                    + _labels({**base, "op": op, "metric": metric})
                    + f" {val}"
                )
            sec_lines.append(
                "auron_op_seconds" + _labels({**base, "op": op})
                + f" {round(MetricNode.op_seconds(tot), 6)}"
            )
    fam("auron_op_metric", "gauge",
        "per-operator MetricNode totals of live tasks (raw units)", op_lines)
    fam("auron_op_seconds", "gauge",
        "per-operator timer seconds of live tasks (MetricNode.op_seconds)",
        sec_lines)
    fam("auron_obs_recent_queries", "gauge",
        "finished query traces in the /queries ring",
        [f"auron_obs_recent_queries {queries}"])

    out = []
    for name, typ, help_, lines in fams:
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {typ}")
        out.extend(lines)
    return "\n".join(out) + "\n"


def gather_tasks() -> dict:
    """Live task runtimes -> per-operator metric rollups (snapshot()s are
    retry-tolerant against concurrent operator mutation; exec/metrics)."""
    from auron_tpu_torch.bridge import api
    from auron_tpu_torch.exec.metrics import MetricNode

    with api._lock:
        runtimes = dict(api._runtimes)
    tasks = {}
    for h, rt in runtimes.items():
        ops: dict[str, dict[str, int]] = {}
        MetricNode.accumulate_op_totals(rt.ctx.metrics.snapshot(), ops)
        tasks[str(h)] = {
            "stage": rt.ctx.stage_id,
            "partition": rt.ctx.partition_id,
            "ops": ops,
        }
    return tasks


def prometheus_text() -> str:
    from auron_tpu_torch.memory.memmgr import MemManager
    from auron_tpu_torch.obs.span import _recent, _recent_lock  # noqa: F401
    from auron_tpu_torch.utils.profiling import EngineCounters

    counters = (EngineCounters._installed.snapshot()
                if EngineCounters._installed is not None else None)
    memory = MemManager.get().mem_snapshot()
    with _recent_lock:
        nq = len(_recent)
    return render_prometheus(gather_tasks(), counters, memory, nq)
