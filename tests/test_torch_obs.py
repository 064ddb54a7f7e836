"""The port's query-scoped tracing (``auron_tpu_torch/obs``) on the CPU.

Every case of ``tests/test_obs.py`` on the port, plus parity with the
JAX package's ``obs``:

- the gate-class trace: the port's q3 class (``run_q3_class`` from
  TaskDefinition bytes, 2 map x 2 reduce) under full tracing, with a
  forced spill dispatched by a foreign thread, a blocking read on a
  foreign thread, a kernel build (nvcc's place taken by a script that
  writes the library, since this machine has no nvcc) and an
  async-window harvest, exports a Perfetto-loadable trace whose
  per-operator span totals agree with ``MetricNode.op_seconds`` within
  5 %, every event attributed to the query's trace;
- ``render_prometheus`` gives the reference's text from the same task
  snapshot, counters and memory state (but for the help of
  ``auron_engine_compiles_total``, which names what the port compiles);
  ``chrome_trace`` events carry the reference's keys and phases for the
  same recorded events; ``op_seconds_skew`` stays inside the reference's
  5 % bound.
"""

import json
import os
import stat
import threading

import numpy as np
import pytest
import torch

from auron_tpu_torch import obs
from auron_tpu_torch.exec.metrics import MetricNode
from auron_tpu_torch.obs import core, export
from auron_tpu_torch.utils.profiling import EngineCounters


@pytest.fixture(scope="module", autouse=True)
def _leak_canary():
    """The port's task runtimes, resource map and obs rings are as this
    module found them (suite-spawned threads owning a ring have exited)."""
    import time

    from auron_tpu_torch.bridge import api

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


@pytest.fixture(autouse=True)
def _restore_mode():
    prev = obs.mode()
    yield
    obs.set_mode(prev)


def _events(trace_id=None, kind=None):
    out = []
    for _ring, evs in core.snapshot_events(trace_id=trace_id):
        for ev in evs:
            if kind is None or ev[2] == kind:
                out.append(ev)
    return out


# ---------------------------------------------------------------------------
# span model
# ---------------------------------------------------------------------------


def test_mode_off_short_circuits_everything():
    obs.set_mode("off")
    with obs.query_trace("off_query") as qt:
        assert qt.trace is None
        with obs.span("x") as sp:
            assert sp is None
        obs.note_op("Op", "elapsed_compute", 123)
    assert qt.summary is None


def test_span_nesting_and_contextvar():
    obs.set_mode("trace")
    with obs.query_trace("nest") as qt:
        root = obs.current_span()
        assert root is not None and root.trace is qt.trace
        with obs.span("child") as c:
            assert c.parent_id == root.span_id
            assert obs.current_span() is c
        assert obs.current_span() is root
    assert obs.current_span() is None
    evs = _events(trace_id=qt.trace.id, kind="span")
    assert {e[3] for e in evs} >= {"child", "nest"}


def test_use_span_hands_off_across_threads_and_none_clears():
    obs.set_mode("trace")
    seen = {}
    with obs.query_trace("hop") as qt:
        sp = obs.current_span()

        def foreign():
            with obs.use_span(sp):
                seen["inside"] = obs.current_span()
                obs.note_op("ForeignOp", "elapsed_compute", 1000)
            seen["after"] = obs.current_span()

        t = threading.Thread(target=foreign)
        t.start()
        t.join()
    assert seen["inside"] is sp and seen["after"] is None
    assert qt.trace.span_op_seconds().get("ForeignOp") == pytest.approx(1e-6)
    with obs.span("ambient"):
        with obs.use_span(None):
            assert obs.current_span() is None


def test_ring_is_bounded_and_wraps():
    obs.set_mode("recorder")
    core.set_ring_capacity(256)
    try:
        done = []

        def burst():
            for i in range(1000):
                core.record("t", f"e{i}", 0, 0, 0, 0, None)
            r = core._tls.ring
            done.append((r.idx, r.cap, sum(1 for x in r.buf if x)))

        t = threading.Thread(target=burst)  # fresh thread -> fresh ring
        t.start()
        t.join()
        idx, cap, filled = done[0]
        assert cap == 256 and idx == 1000 and filled == 256
    finally:
        core.set_ring_capacity(32768)


def test_recorder_mode_rings_only_no_per_event_lock():
    obs.set_mode("recorder")
    with obs.query_trace("rec_mode") as qt:
        obs.note_op("SomeExec", "elapsed_compute", 5_000_000)
        obs.note_sync(100_000, False)
    assert _events(trace_id=qt.trace.id, kind="op")
    assert qt.trace.span_op_ns == {}
    assert qt.summary["host_syncs"] == 0
    assert qt.summary["trace_id"] == qt.trace.id
    obs.set_mode("trace")
    with obs.query_trace("trace_mode") as qt2:
        obs.note_op("SomeExec", "elapsed_compute", 5_000_000)
    assert qt2.trace.span_op_seconds()["SomeExec"] == pytest.approx(0.005)


def test_apply_conf_ignores_env_only_mode(monkeypatch):
    from auron_tpu_torch.utils.config import Configuration

    monkeypatch.setenv("AURON_TPU_OBS_MODE", "off")
    obs.set_mode("trace")
    obs.apply_conf(Configuration())          # env-only: no-op
    assert obs.mode() == obs.MODE_TRACE
    obs.apply_conf(Configuration().set(obs.OBS_MODE, "recorder"))
    assert obs.mode() == obs.MODE_RECORDER   # session-set: applies


def test_query_trace_summary_lands_in_recent_ring():
    obs.set_mode("trace")
    with obs.query_trace("ringed") as qt:
        obs.note_op("AggExec", "elapsed_compute", 2_000_000)
        obs.note_sync(500_000, False)
    recent = obs.recent_queries()
    assert recent and recent[0]["trace_id"] == qt.trace.id
    assert recent[0]["host_syncs"] == 1
    assert recent[0]["name"] == "ringed"


def test_sql_compile_emits_parse_bind_lower_spans():
    from auron_tpu_torch.sql import compile_text

    obs.set_mode("trace")
    with obs.query_trace("sqlspans") as qt:
        compile_text(
            "select ss_item_sk, sum(ss_ext_sales_price) s from store_sales "
            "group by ss_item_sk"
        )
    names = {e[3] for e in _events(trace_id=qt.trace.id, kind="span")}
    assert {"sql.parse", "sql.bind", "sql.lower"} <= names


# ---------------------------------------------------------------------------
# the acceptance teeth
# ---------------------------------------------------------------------------


def _fake_kernel_build(tmp_path, monkeypatch):
    """One real pass through ``cuda_build``'s build path with nvcc's place
    taken by a script that writes the output file (no nvcc here)."""
    from auron_tpu_torch.ops import cuda_build

    src = tmp_path / "csrc"
    src.mkdir()
    (src / "fake.cu").write_text("// a kernel source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "SRC_DIR", str(src))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "SOURCES", {"fake": "fake.cu"})
    monkeypatch.setattr(cuda_build, "BUILD_SECONDS", {})
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {})
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(nvcc))
    cuda_build.build_all()
    assert os.path.exists(cuda_build.lib_path("fake"))


def test_gate_class_trace_is_complete_and_agrees(tmp_path, monkeypatch):
    from auron_tpu_torch.memory.memmgr import MemManager
    from auron_tpu_torch.models import tpcds
    from auron_tpu_torch.runtime.transfer import TransferWindow, blocking_read

    counters = EngineCounters.install()
    obs.set_mode("trace")
    spilled = threading.Event()

    class _Consumer:
        name = "teeth_consumer"

        def mem_used(self):
            return 0 if spilled.is_set() else (4 << 20)

        def spill(self):
            spilled.set()
            return 4 << 20

    data = tpcds.generate(sf=0.1, seed=3)
    compiles0 = counters.compiles
    with obs.query_trace("gate.q3") as qt:
        # --- the gate-class replay itself (every task from bytes)
        got = tpcds.run_q3_class(data, n_map=2, n_reduce=2, device="cpu",
                                 work_dir=str(tmp_path / "q3"))
        # --- forced spill: consumer registered under the OWNING trace,
        # spill dispatched by a FOREIGN thread with no span installed
        mm = MemManager(budget_bytes=0)
        mm.register(_Consumer())
        t = threading.Thread(target=lambda: mm.acquire(_Consumer(), 1 << 20))
        t.start()
        t.join()
        assert spilled.is_set()
        # --- forced blocking read on a foreign thread, span threaded
        # explicitly (the hand-off recipe)
        sp = obs.current_span()
        x = torch.arange(1 << 16)

        def foreign_sync():
            with obs.use_span(sp):
                blocking_read(None, x + 1)

        t = threading.Thread(target=foreign_sync)
        t.start()
        t.join()
        # --- a compile inside the trace: one kernel build
        _fake_kernel_build(tmp_path, monkeypatch)
        # --- an async-transfer harvest inside the trace
        w = TransferWindow(1)
        for i in range(3):
            w.push((torch.tensor([i]),), i)
        list(w.drain())
    want = tpcds.q3_class_oracle(data)
    for k in ("d_year", "i_brand_id"):
        assert got[k].tolist() == want[k].tolist()
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)
    assert counters.compiles == compiles0 + 1

    out = str(tmp_path / "trace.json")
    export.write_chrome_trace(out, trace_id=qt.trace.id)
    with open(out) as f:
        ct = json.load(f)

    xs = [e for e in ct["traceEvents"] if e["ph"] == "X"]
    assert xs
    for e in xs:
        assert {"name", "cat", "ts", "dur", "pid", "tid"} <= set(e)
        assert e["pid"] == qt.trace.id  # every event attributed

    kinds = {e["cat"] for e in xs}
    assert {"op", "span", "sync", "compile", "spill", "transfer"} <= kinds
    spill_evs = [e for e in xs if e["cat"] == "spill"
                 and e["args"].get("consumer") == "teeth_consumer"]
    assert spill_evs, "forced foreign-thread spill missing from the trace"
    assert any(e["name"] == "harvest" for e in xs if e["cat"] == "transfer")
    assert any(e["name"] == "host_sync" for e in xs if e["cat"] == "sync")
    assert any(e["name"] == "nvcc_build" for e in xs if e["cat"] == "compile")
    assert any(e["name"].startswith("task s") for e in xs if e["cat"] == "span")

    # per-operator span totals FROM THE EXPORTED FILE agree with the
    # MetricNode.op_seconds rollup within 5%
    from_file: dict[str, float] = {}
    for e in xs:
        if e["cat"] != "op":
            continue
        metric = e["args"]["metric"]
        if metric in MetricNode.NESTED_TIMERS:
            continue
        op = e["args"]["op"]
        from_file[op] = from_file.get(op, 0.0) + e["dur"] / 1e6
    metric_ops = qt.trace.metric_op_seconds()
    assert metric_ops, "no finalize-time metric rollup reached the trace"
    for op, secs in metric_ops.items():
        if secs < 0.01:
            continue  # sub-10ms ops: rounding noise dominates percentages
        assert from_file.get(op, 0.0) == pytest.approx(secs, rel=0.05), (
            op, from_file.get(op), secs
        )
    assert qt.trace.op_seconds_skew()["ok"]
    # not vacuous: the operators past 1 ms agree as well
    skew = qt.trace.op_seconds_skew(min_s=0.001)
    assert skew["ok"] and skew["max_skew_pct"] <= 5.0 and skew["compared"] >= 3, skew


def test_spill_container_attributes_via_conf_trace_id():
    """A spill container carries the owning conf; a write on a foreign
    thread attributes through obs.trace.id with NO live span anywhere."""
    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.memory.memmgr import make_spill
    from auron_tpu_torch.utils.config import active_conf

    obs.set_mode("trace")
    with obs.query_trace("conf_attr") as qt:
        conf = active_conf().copy()  # carries obs.trace.id
    spill = make_spill(conf=conf)
    schema = T.Schema((T.Field("v", T.INT64),))
    b = Batch.from_numpy([np.arange(100, dtype=np.int64)], schema, device="cpu")

    def foreign_write():
        spill.write_batch(b)

    t = threading.Thread(target=foreign_write)
    t.start()
    t.join()
    evs = _events(trace_id=qt.trace.id, kind="spill")
    assert any(e[3] == "write" for e in evs)
    spill.release()


def test_chrome_trace_last_window_filters_old_events():
    import time as _t

    obs.set_mode("recorder")
    core.record("t", "old_event_marker", 0, 0, 0, 0, None)
    _t.sleep(0.05)
    core.record("t", "new_event_marker", 0, 0, 0, 0, None)
    ct = export.chrome_trace(last_s=0.03)
    names = {e["name"] for e in ct["traceEvents"] if e["ph"] == "X"}
    assert "new_event_marker" in names and "old_event_marker" not in names


# ---------------------------------------------------------------------------
# parity with the JAX package's obs
# ---------------------------------------------------------------------------

_PROM_INPUT = dict(
    tasks={
        "1": {"stage": 0, "partition": 0,
              "ops": {"FilterExec": {"elapsed_compute": 5_000_000, "output_rows": 7},
                      'We"ird\\Op\n': {"merge_time": 3, "merge_path_s": 2}}},
        "2": {"stage": 1, "partition": 1,
              "ops": {"HashAggExec": {"elapsed_compute": 12_345_678}}},
    },
    counters={"compiles": 3, "compile_s": 0.5, "host_syncs": 2, "host_sync_s": 0.1,
              "async_reads": 9, "async_read_s": 0.01, "batches": 40},
    memory={"budget_bytes": 10, "num_spills": 1,
            "consumers": [{"name": "dup", "mem_used": 3},
                          {"name": "dup", "mem_used": 4},
                          {"name": "sort", "mem_used": 1}]},
    queries=5,
)


def test_render_prometheus_equals_the_reference():
    from auron_tpu.obs.export import render_prometheus as ref_render

    got = export.render_prometheus(**_PROM_INPUT)
    want = ref_render(**_PROM_INPUT)
    assert "# HELP auron_engine_compiles_total CUDA graph captures and kernel builds" in got
    assert got == want.replace("# HELP auron_engine_compiles_total XLA program compiles",
                               "# HELP auron_engine_compiles_total CUDA graph captures "
                               "and kernel builds")


def _shape(ct: dict) -> list:
    """A chrome trace's events without their times, thread and trace ids
    and span ids (each package counts its own): the keys of each event
    and of its args, every other value as is."""
    out = []
    for e in ct["traceEvents"]:
        if e["ph"] == "M" and e["name"] == "process_name":
            continue
        ev = {k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}
        ev["keys"] = sorted(e)
        if e["ph"] == "M":
            ev["args"] = {}  # the recording thread's name
        else:
            ev["args"] = {k: (v if k not in ("span", "parent") else 0)
                          for k, v in e["args"].items()}
        out.append(json.dumps(ev, sort_keys=True))
    return sorted(out)


def test_chrome_trace_events_have_the_reference_keys_and_phases():
    from auron_tpu import obs as robs
    from auron_tpu.obs import core as rcore
    from auron_tpu.obs import export as rexport

    prev = robs.mode()
    views = []
    try:
        for o, c, ex in ((obs, core, export), (robs, rcore, rexport)):
            o.set_mode("trace")

            def record(o=o, c=c):
                c.reset_for_tests()
                with o.query_trace("parity") as qt:
                    o.note_op("ParityExec.3", "parity_time", 1000)
                    o.note_sync(2000, False)
                    o.note_sync(3000, True)
                    o.note_transfer_start(2)
                    o.note_harvest(2, 4000)
                    o.note_pump_batch()
                    with o.span("parity_span", cat="parity", arg={"k": 1}):
                        pass
                return qt.trace.id

            box = []
            t = threading.Thread(target=lambda: box.append(record()))
            t.start()
            t.join()
            views.append(ex.chrome_trace(trace_id=box[0]))
    finally:
        robs.set_mode(prev)
    port, ref = views
    # op, sync, async, transfer start, harvest, pump batch, the span, the root
    assert len([e for e in port["traceEvents"] if e["ph"] == "X"]) == 8
    assert _shape(port) == _shape(ref)


def test_op_seconds_skew_inside_the_reference_bound():
    from auron_tpu.obs.span import Trace as RefTrace

    snap = {"name": "HashAggExec.0", "values": {"elapsed_compute": 80_000_000,
                                               "merge_path_s": 9_000_000},
            "children": [{"name": "FilterExec.1", "values": {"filter_time": 60_000_000},
                          "children": []}]}
    results = []
    for trace in (obs.Trace("skew"), RefTrace("skew")):
        trace.add_task_metrics(snap)
        trace.note_op("HashAggExec.0", "elapsed_compute", 78_000_000)
        trace.note_op("FilterExec.1", "filter_time", 60_000_000)
        results.append(trace.op_seconds_skew())
    assert results[0] == results[1]
    assert results[0]["ok"] and results[0]["compared"] == 2
    assert results[0]["max_skew_pct"] == pytest.approx(2.5)
