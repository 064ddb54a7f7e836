"""The host boundary end to end: the same plan protos (``auron_tpu.plan.
builders``) through ``auron_tpu.bridge.api`` and ``auron_tpu_torch.bridge.
api`` give equal rows (exact; float sums at rel 1e-9 where the summation
order may differ):

- ffi_reader -> filter -> ``next_batch_c`` (C structs both ways);
- ffi_reader -> partial + final aggregate -> ``next_batch_ipc``;
- ffi_reader -> ipc_writer, the blocks decoded by both packages'
  ``decode_block``/``decode_blocks``;
- the ``rid.<pid>`` keys, callable exporters and one-shot streams;

and the port's bridge runners of q42 and q93 equal their oracles; the
bridge's C-ABI helpers (metrics sink, JSON finalize, on_exit, the cleanup
of a failed ``call_native``); the port's boundary modules import without
pyarrow. Inputs come from a seeded numpy generator."""

import ctypes
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu import types as JT
from auron_tpu.bridge import api as japi
from auron_tpu.exec.shuffle import format as jf
from auron_tpu.exprs.ir import BinaryOp, col, lit
from auron_tpu.plan import builders as B

from auron_tpu_torch import types as T
from auron_tpu_torch.bridge import api as papi
from auron_tpu_torch.columnar import arrow_c as C
from auron_tpu_torch.exec.shuffle import format as pf
from auron_tpu_torch.models import tpcds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.02


def _input(n: int = 700, seed: int = 12) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    return pa.RecordBatch.from_pydict({
        "x": pa.array(np.arange(n, dtype=np.int64)),
        "k": pa.array(rng.integers(0, 9, n), mask=rng.random(n) < 0.1),
        "s": pa.array([f"t{v}" for v in rng.integers(0, 5, n)]),
        "v": pa.array(np.round(rng.random(n) * 100, 2)),
    })


def _schema(rb: pa.RecordBatch) -> JT.Schema:
    return JT.Schema.from_arrow(rb.schema)


def _c_stream(batches: list, schema: pa.Schema) -> C.ArrowArrayStream:
    """A pyarrow reader exported into an ArrowArrayStream (the JVM's side)."""
    st = C.ArrowArrayStream()
    pa.RecordBatchReader.from_batches(schema, batches)._export_to_c(ctypes.addressof(st))
    return st


def _drain_c(api, h) -> list[dict]:
    rows = []
    while True:
        arr, sch = C.ArrowArray(), C.ArrowSchema()
        rc = api.next_batch_c(h, ctypes.addressof(arr), ctypes.addressof(sch))
        assert rc in (0, 1)
        if rc == 0:
            return rows
        rows += pa.RecordBatch._import_from_c(ctypes.addressof(arr),
                                              ctypes.addressof(sch)).to_pylist()


def _task(plan, **kw) -> bytes:
    return B.task(plan, **kw).SerializeToString()


def _run_c(api, task: bytes, **kw) -> list[dict]:
    h = api.call_native(task, **kw)
    try:
        return _drain_c(api, h)
    finally:
        api.finalize_native(h)


def test_ffi_reader_filter_next_batch_c_equals_reference():
    rb = _input()
    plan = B.filter_(B.ffi_reader(_schema(rb), "cffi_src"), [BinaryOp("lt", col(1), lit(4))])
    out = {}
    for name, api, kw in (("jax", japi, {}), ("port", papi, {"device": "cpu"})):
        st = _c_stream([rb.slice(0, 300), rb.slice(300)], rb.schema)
        api.put_resource_c_stream("cffi_src", ctypes.addressof(st))
        try:
            out[name] = _run_c(api, _task(plan), **kw)
        finally:
            api.remove_resource("cffi_src")
    assert out["port"] == out["jax"]
    assert out["port"] == [r for r in rb.to_pylist() if r["k"] is not None and r["k"] < 4]


def test_ffi_reader_aggregate_next_batch_ipc_equals_reference():
    rb = _input()
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as w:
        w.write_batch(rb.slice(0, 350))
        w.write_batch(rb.slice(350))
    scan = B.ffi_reader(_schema(rb), "ipc_src")
    aggs = [("sum", col(3), "s"), ("count_star", None, "n")]
    partial = B.hash_agg(scan, [(col(2), "g")], aggs, "partial")
    final = B.hash_agg(partial, [(col(0), "g")], [("sum", col(1), "s"), ("count", col(2), "n")],
                       "final")
    out = {}
    for name, api, kw in (("jax", japi, {}), ("port", papi, {"device": "cpu"})):
        api.put_resource_ipc("ipc_src", sink.getvalue())
        h = api.call_native(_task(final), **kw)
        rows = []
        try:
            while (ipc := api.next_batch_ipc(h)) is not None:
                with pa.ipc.open_stream(ipc) as r:
                    for b in r:
                        rows += b.to_pylist()
        finally:
            api.finalize_native(h)
            api.remove_resource("ipc_src")
        out[name] = sorted((r["g"], r["s"], r["n"]) for r in rows)
    assert [(g, n) for g, _, n in out["port"]] == [(g, n) for g, _, n in out["jax"]]
    for (_, ps, _), (_, js, _) in zip(out["port"], out["jax"]):
        assert ps == pytest.approx(js, rel=1e-9)
    assert len(out["port"]) == 5


def _blocks_rows(blocks: list, schema: T.Schema) -> list[tuple]:
    """Rows of length-prefixed blocks through the port's decode_block."""
    rows = []
    for blk in blocks:
        for payload in pf.iter_block_payloads(blk):
            n, cols = pf.decode_block(payload, schema)
            host = []
            for f, (vals, valid) in zip(schema, cols):
                v = [vals.vocab[c] for c in vals.codes] if isinstance(vals, pf.DictCodes) \
                    else vals.tolist()
                m = [True] * n if valid is None else valid.tolist()
                host.append([x if ok else None for x, ok in zip(v, m)])
            rows += list(zip(*host))
    return rows


def test_ipc_writer_blocks_decode_in_both_packages():
    """The port's blocks read in the JAX ``decode_blocks`` and the port's
    ``decode_block``; the reference's (uncompressed v1) blocks in the
    port's; every reading gives the filtered rows."""
    rb = _input()
    plan = B.ipc_writer(B.filter_(B.ffi_reader(_schema(rb), "w_src"),
                                  [BinaryOp("gt", col(3), lit(30.0))]), "w_out")
    want = [tuple(r.values()) for r in rb.to_pylist() if r["v"] > 30.0]
    blocks = {}
    for name, api, kw in (("jax", japi, {}), ("port", papi, {"device": "cpu"})):
        st = _c_stream([rb.slice(0, 200), rb.slice(200)], rb.schema)
        api.put_resource_c_stream("w_src", ctypes.addressof(st))
        chan: list = []
        try:
            h = api.call_native(_task(plan, conf={"spill.compression.codec": "none"}),
                                {"w_out": chan}, **kw)
            try:
                assert api.next_batch(h) is None
            finally:
                api.finalize_native(h)
        finally:
            api.remove_resource("w_src")
        blocks[name] = chan
    assert len(blocks["port"]) == 2 and len(blocks["jax"]) == 2
    schema = T.Schema.from_arrow(rb.schema)
    jax_read = [tuple(r.values()) for b in jf.decode_blocks(b"".join(blocks["port"]))
                for r in b.to_pylist()]
    assert jax_read == want
    assert _blocks_rows(blocks["port"], schema) == want
    assert _blocks_rows(blocks["jax"], schema) == want


def test_partition_keys_callable_exporters_and_one_shot_streams():
    """``rid.<pid>`` first, then ``rid``; a callable gets the partition; an
    imported stream yields its batches once (a second task reads nothing)."""
    rb = _input(90)
    parts = [rb.slice(0, 30), rb.slice(30, 30), rb.slice(60)]
    scan = B.ffi_reader(_schema(rb), "p_src")
    out = {}
    for name, api, kw in (("jax", japi, {}), ("port", papi, {"device": "cpu"})):
        s1 = _c_stream([parts[1]], rb.schema)
        shared = _c_stream([parts[0]], rb.schema)
        api.put_resource_c_stream("p_src.1", ctypes.addressof(s1))
        api.put_resource_c_stream("p_src", ctypes.addressof(shared))
        try:
            got = [[r["x"] for r in _run_c(api, _task(scan, partition_id=p), **kw)]
                   for p in (1, 0, 2)]
        finally:
            api.remove_resource("p_src.1")
            api.remove_resource("p_src")
        api.put_resource("p_cb", lambda p: [parts[p]] if name == "jax"
                         else [C.import_from(parts[p])])
        try:
            got += [[r["x"] for r in _run_c(api, _task(B.ffi_reader(_schema(rb), "p_cb"),
                                                       partition_id=p), **kw)]
                    for p in (2, 0)]
        finally:
            api.remove_resource("p_cb")
        out[name] = got
    assert out["port"] == out["jax"]
    assert out["port"] == [list(range(30, 60)), list(range(30)), [], list(range(60, 90)),
                           list(range(30))]


def test_q42_bridge_equals_oracle_and_the_device_runner():
    d = tpcds.generate(SF, 42)
    st: dict = {}
    got = tpcds.run_q42_bridge(d, device="cpu", stats=st)
    want = tpcds.q42_class_oracle(d)
    np.testing.assert_array_equal(got["brand"], want["brand"])
    np.testing.assert_allclose(got["rev"], want["rev"], rtol=1e-9)
    on_card = tpcds.run_q42_class(d, device="cpu")
    np.testing.assert_array_equal(got["brand"], on_card["brand"])
    np.testing.assert_array_equal(got["rev"], on_card["rev"])
    # the fact's 5 planes and the item's 5, in one batch each
    assert st["zerocopy_planes"] + st["copied_planes"] == 10
    assert st["ingest_bytes"] > d.fact_rows() * 36 and st["egress_s"] > 0
    assert st["timers"]["IpcWriterExec.egress_time"] >= st["timers"]["IpcWriterExec.encode_time"]


def test_q93_bridge_equals_oracle():
    d = tpcds.generate(SF, 42)
    st: dict = {}
    got = tpcds.run_q93_bridge(d, n_map=4, n_reduce=4, device="cpu", stats=st)
    want = tpcds.q93_class_oracle(d)
    np.testing.assert_array_equal(got["k_null"], want["k_null"])
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["matched"], want["matched"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9)
    assert sum(st["partition_rows"]) == d.fact_rows()
    assert st["copied_planes"] + st["zerocopy_planes"] == 4 * 5 + 4 * 2  # 4 fact + 4 cust
    assert set(st["stage_s"]) == {"map", "reduce"} and st["egress_s"] > 0


def test_metrics_sink_json_and_on_exit():
    rb = _input(50)
    snaps: list = []
    papi.set_metrics_sink(snaps.append)
    try:
        papi.put_resource_ipc("m_src", _pa_bytes(rb))
        task = _task(B.ffi_reader(_schema(rb), "m_src"))
        h = papi.call_native(task, device="cpu")
        assert papi.next_batch(h).num_rows() == 50
        tree = json.loads(papi.finalize_native_json(h))
        assert tree["name"] == "FFIReaderExec" and snaps == [tree]
        live = [papi.call_native(task, device="cpu") for _ in range(2)]
        papi.on_exit()
        assert not any(h in papi._runtimes for h in live) and len(snaps) == 3
    finally:
        papi.set_metrics_sink(None)
        papi.remove_resource("m_src")


def _pa_bytes(rb: pa.RecordBatch) -> bytes:
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as w:
        w.write_batch(rb)
    return sink.getvalue()


def test_call_native_finalizes_the_runtime_when_publishing_fails(monkeypatch):
    started = []

    class Recording(papi.TaskRuntime):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            started.append(self)

    class Broken:
        def __next__(self):
            raise RuntimeError("no handle")

    rb = _input(20)
    monkeypatch.setattr(papi, "TaskRuntime", Recording)
    monkeypatch.setattr(papi, "_next_handle", Broken())
    with pytest.raises(RuntimeError, match="no handle"):
        papi.call_native(_task(B.ffi_reader(_schema(rb), "gone")), device="cpu")
    (rt,) = started
    assert rt._finalized and not rt._thread.is_alive()


def test_boundary_modules_import_and_run_without_pyarrow():
    """No pyarrow, pandas, protobuf, jax or auron_tpu at import; the port's
    C stream producer and importer, ingest and export run without pyarrow."""
    script = textwrap.dedent("""
        import ctypes, sys
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "auron_tpu"):
            sys.modules[m] = None  # any import of them raises ImportError
        import numpy as np
        from auron_tpu_torch import types as T
        from auron_tpu_torch.bridge import api
        from auron_tpu_torch.columnar import arrow_c, arrow_ipc
        from auron_tpu_torch.columnar.batch import Batch
        from auron_tpu_torch.exec import scan, sink
        schema = T.Schema((T.Field("x", T.INT64), T.Field("s", T.STRING)))
        hb = arrow_c.HostBatch.from_numpy(
            [np.arange(5), np.array(list("abcab"), dtype=object)], schema)
        (got,) = list(arrow_c.stream_of([hb]))
        b = Batch.from_host_arrow(got, device="cpu")
        back = arrow_ipc.read_stream(arrow_ipc.write_stream([b.to_host_arrow()]))
        assert back[0].to_pydict() == {"x": [0, 1, 2, 3, 4], "s": list("abcab")}
        bad = sorted(m for m in sys.modules if sys.modules[m] is not None and
                     m.split(".")[0] in ("pyarrow", "pandas", "jax", "auron_tpu")
                     or m.startswith("google.protobuf") and sys.modules[m] is not None)
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
