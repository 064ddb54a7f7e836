"""Slice 18: the host callbacks (``bridge/udf.py``) of the port against the
JAX package, on the CPU.

- the reference's UDF cases (``exclaim``, ``add2``) through ``ProjectExec``,
  one Python function registered with both packages;
- the ``ngrams`` UDTF through ``GenerateExec`` with and without ``outer``;
- the geometric-mean UDAF (``register_udaf``) PARTIAL -> FINAL and its
  accumulator form (``register_udaf_accumulator``) PARTIAL -> PARTIAL_MERGE
  -> FINAL over several input batches (floats at rel 1e-12);
- a ``__hive:`` UDF through the port's C library (``auron_register_udf_callback``
  with a ctypes evaluator answers 0), from the converter's fallback plan;
- the converter's fallback plan (a registered function the converter
  cannot translate, wrapped as ``host_udf``) evaluated by both packages;
- the C channel with pyarrow unimportable (a subprocess): the port's own
  Arrow IPC carries the columns both ways;
- ``expr_capture_safe`` refuses a ``HostUDF`` as ``expr_trace_safe`` does."""

import base64
import ctypes
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu import types as JT
from auron_tpu.bridge import udf as judf
from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.exec.agg_exec import AggExpr as JAgg, HashAggExec as JHashAgg
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan, ProjectExec as JProject
from auron_tpu.exec.generate_exec import GenerateExec as JGen
from auron_tpu.exprs import ir as jir
from auron_tpu.plan import fusion as jfusion

from auron_tpu_torch import types as PT
from auron_tpu_torch.bridge import udf as pudf
from auron_tpu_torch.exec.agg_exec import AggExpr as PAgg, HashAggExec as PHashAgg
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan, ProjectExec as PProject
from auron_tpu_torch.exec.generate_exec import GenerateExec as PGen
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.plan import fusion as pfusion
from torch_carry import canon, carry, rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(rb: pa.RecordBatch):
    jb = JBatch.from_arrow(rb)
    return jb, carry(jb)


def _run_both(jop, pop):
    want = list(jop.execute(0, JCtx()))
    got = list(pop.execute(0, PCtx(device="cpu")))
    return rows(got), rows(want)


def _exclaim(args, n):
    a = args[0].to_pylist()
    return pa.array([(s.upper() + "!" if s is not None else None) for s in a], type=pa.string())


def _add2(args, n):
    import pyarrow.compute as pc

    return pc.add(args[0], args[1])


def _register(name, fn):
    judf.register_udf(name, fn)
    pudf.register_udf(name, fn)


def test_host_udf_exclaim_equals_the_reference():
    _register("exclaim", _exclaim)
    jb, pb = _both(pa.record_batch({"s": pa.array(["hi", None, "yo"])}))
    got, want = _run_both(
        JProject(JScan.single([jb]), [jir.HostUDF("exclaim", (jir.col(0),), JT.STRING)], ["e"]),
        PProject(PScan([[pb]], pb.schema), [pir.HostUDF("exclaim", (pir.col(0),), PT.STRING)],
                 ["e"]))
    assert got == want == [("HI!",), (None,), ("YO!",)]


def test_host_udf_numeric_equals_the_reference():
    _register("add2", _add2)
    jb, pb = _both(pa.record_batch({"x": pa.array([1, 2]), "y": pa.array([10, None])}))
    got, want = _run_both(
        JProject(JScan.single([jb]),
                 [jir.HostUDF("add2", (jir.col(0), jir.col(1)), JT.INT64)], ["z"]),
        PProject(PScan([[pb]], pb.schema),
                 [pir.HostUDF("add2", (pir.col(0), pir.col(1)), PT.INT64)], ["z"]))
    assert got == want == [(11,), (None,)]


def test_host_udf_sees_every_slot_and_keeps_the_selection():
    seen = {}

    def count(args, n):
        seen["n"] = n
        seen["len"] = len(args[0])
        return pa.array([1] * n, pa.int64())

    pudf.register_udf("slots", count)
    jb, pb = _both(pa.record_batch({"x": pa.array(np.arange(5, dtype=np.int64))}))
    out = list(PProject(PScan([[pb]], pb.schema),
                        [pir.HostUDF("slots", (pir.col(0),), PT.INT64)], ["c"])
               .execute(0, PCtx(device="cpu")))
    assert seen["n"] == seen["len"] == pb.capacity > 5
    assert rows(out) == [(1,)] * 5


def _ngrams(s):
    return [(s[i:i + 2], i) for i in range(len(s) - 1)] if s else []


@pytest.mark.parametrize("outer", [False, True])
def test_host_udtf_ngrams_equals_the_reference(outer):
    judf.register_udtf("ngrams", _ngrams,
                       JT.Schema.of(JT.Field("gram", JT.STRING), JT.Field("ofs", JT.INT32)))
    pudf.register_udtf("ngrams", _ngrams,
                       PT.Schema((PT.Field("gram", PT.STRING), PT.Field("ofs", PT.INT32))))
    jb, pb = _both(pa.record_batch({"id": pa.array([1, 2, 3, 4]),
                                    "s": pa.array(["abc", "x", None, "wxyz"])}))
    jg = JGen(JScan.single([jb]), "host_udtf", jir.col(1), required_cols=[0], udtf="ngrams",
              outer=outer)
    pg = PGen(PScan([[pb]], pb.schema), "host_udtf", pir.col(1), required_cols=[0],
              udtf="ngrams", outer=outer)
    assert [f.name for f in pg.schema] == [f.name for f in jg.schema] == ["id", "gram", "ofs"]
    got, want = _run_both(jg, pg)
    assert got == want
    if outer:
        assert [r[0] for r in got] == [1, 1, 2, 3, 4, 4, 4]
        assert got[2] == (2, None, None)
    else:
        assert got[:2] == [(1, "ab", 0), (1, "bc", 1)]


def _geomean(vals):
    vs = [v for v in vals if v is not None]
    return float(np.exp(np.mean(np.log(vs)))) if vs else None


def _geo_acc(pkg_types):
    return dict(init=lambda: (0.0, 0), update=lambda st, v: (st[0] + np.log(v), st[1] + 1),
                merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
                finish=lambda st: float(np.exp(st[0] / st[1])) if st[1] else None,
                out_dtype=pkg_types.FLOAT64)


def _agg_chain(pkg, batches, schema, modes, udaf):
    """PARTIAL over the batches, then each later mode over the previous
    stage's output (one simulated exchange a stage)."""
    Scan, Agg, AE, HA, ir, ctx = pkg
    op = Scan([batches], schema) if Scan is PScan else Scan.single(batches)
    out = None
    for mode in modes:
        keys = [(ir.col(0), "k")]
        aggs = [(AE("host_udaf", ir.col(1), udaf=udaf), "g")]
        op = HA(op, keys, aggs, mode)
        out = list(op.execute(0, ctx()))
        if mode != "final":
            op = Scan([out], op.schema) if Scan is PScan else Scan.single(out)
    return out


@pytest.mark.parametrize("form", ["register_udaf", "accumulator"])
def test_host_udaf_equals_the_reference(form):
    if form == "register_udaf":
        judf.register_udaf("geo", _geomean, JT.FLOAT64)
        pudf.register_udaf("geo", _geomean, PT.FLOAT64)
        modes = ["partial", "final"]
    else:
        judf.register_udaf_accumulator("geo", **_geo_acc(JT))
        pudf.register_udaf_accumulator("geo", **_geo_acc(PT))
        modes = ["partial", "partial_merge", "final"]
    rng = np.random.default_rng(3)
    rbs = [pa.record_batch({"k": pa.array(rng.integers(0, 7, 300).astype(np.int32)),
                            "v": pa.array(rng.uniform(0.5, 9.0, 300),
                                          mask=rng.random(300) < 0.1)}) for _ in range(3)]
    jbs = [JBatch.from_arrow(rb) for rb in rbs]
    pbs = [carry(b) for b in jbs]
    want = canon(rows(_agg_chain((JScan, None, JAgg, JHashAgg, jir, JCtx), jbs, jbs[0].schema,
                                 modes, "geo")))
    got = canon(rows(_agg_chain((PScan, None, PAgg, PHashAgg, pir,
                                 lambda: PCtx(device="cpu")), pbs, pbs[0].schema, modes, "geo")))
    assert [r[0] for r in got] == [r[0] for r in want] == list(range(7))
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=1e-12)
    k = np.concatenate([rb.column(0).to_numpy() for rb in rbs])
    v = np.concatenate([rb.column(1).to_numpy(zero_copy_only=False) for rb in rbs])
    for key, g in got:
        sel = (k == key) & ~np.isnan(v)
        assert g == pytest.approx(float(np.exp(np.log(v[sel]).mean())), rel=1e-12)


# ---------------------------------------------------------------------------
# the converter's fallback plan, and the C channel
# ---------------------------------------------------------------------------


def _fallback_plan():
    return {"op": "ProjectExec", "schema": [["r", "long", True]],
            "args": {"projections": [{"kind": "call", "name": "my_weird_fn", "type": "long",
                                      "children": [{"kind": "attr", "index": 1, "name": ""}]}]},
            "children": [{"op": "LocalTableScanExec",
                          "schema": [["k", "long", True], ["v", "long", True]],
                          "args": {"resource_id": "t"}, "children": []}]}


def test_converter_fallback_plan_evaluates_in_both_packages():
    from auron_tpu.convert import convert_plan as jconvert
    from auron_tpu.convert.converters import NativeSegment as JSeg
    from auron_tpu.plan.planner import plan_from_proto as jplan
    from auron_tpu_torch.convert.converters import NativeSegment as PSeg, convert_plan
    from auron_tpu_torch.plan.planner import plan_from_proto as pplan

    def twice(args, n):
        import pyarrow.compute as pc

        return pc.multiply(args[0], 2)

    _register("my_weird_fn", twice)
    jres = jconvert(_fallback_plan(), udf_registry={"my_weird_fn": twice})
    pres = convert_plan(_fallback_plan(), udf_registry={"my_weird_fn": twice})
    assert isinstance(jres.root, JSeg) and isinstance(pres.root, PSeg)
    assert pres.root.plan.SerializeToString() == jres.root.plan.SerializeToString()
    rb = pa.record_batch({"k": pa.array([1, 2, 3], pa.int64()),
                          "v": pa.array([10, None, 30], pa.int64())})
    jb, pb = _both(rb)
    want = rows(jplan(jres.root.plan).execute(0, JCtx(resources={"t": [[jb]]})))
    got = rows(pplan(pres.root.plan).execute(0, PCtx(device="cpu", resources={"t": [[pb]]})))
    assert got == want == [(20,), (None,), (60,)]


_EVAL = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t))


def _hive_plan(tag: bytes) -> dict:
    return {"op": "ProjectExec", "schema": [["s", "string", True], ["u", "string", True]],
            "args": {"projections": [
                {"kind": "attr", "index": 0},
                {"kind": "call", "name": "__hive_udf__", "udf_blob": base64.b64encode(tag).decode(),
                 "type": "string", "children": [{"kind": "attr", "index": 0}]}]},
            "children": [{"op": "FlinkStreamInput", "schema": [["s", "string", True]],
                          "args": {}, "children": []}]}


def test_hive_udf_through_the_port_c_library(monkeypatch):
    """``auron_register_udf_callback`` of the port's C library (loaded into
    this process) answers 0 with a ctypes evaluator of the
    ``auron_udf_eval_fn`` signature; the converted ``__hive_udf__`` plan then
    evaluates through it: the argument column goes out as the port's Arrow
    IPC, pyarrow reads it, the result comes back as one column."""
    import io

    from auron_tpu_torch import proto as pb
    from auron_tpu_torch.bridge import api, host as phost
    from auron_tpu_torch.convert.service import convert_host_plan_json

    monkeypatch.setenv("AURON_TORCH_DEVICE", "cpu")
    state = {"calls": 0, "buf": None}

    @_EVAL
    def host_eval(blob_ptr, blob_len, args_ptr, args_len, out_ptr, out_len):
        tag = ctypes.string_at(blob_ptr, blob_len).decode()
        with pa.ipc.open_stream(io.BytesIO(ctypes.string_at(args_ptr, args_len))) as r:
            col = r.read_all().column(0).to_pylist()
        result = pa.table({"r": pa.array([f"{v.upper()}#{tag}" if isinstance(v, str) else None
                                          for v in col], pa.string())})
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, result.schema) as w:
            w.write_table(result)
        payload = sink.getvalue()
        state["buf"] = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
        out_ptr[0] = ctypes.cast(state["buf"], ctypes.POINTER(ctypes.c_uint8))
        out_len[0] = len(payload)
        state["calls"] += 1
        return 0

    lib = phost.CLibrary("cpu")._lib
    lib.auron_register_udf_callback.argtypes = [ctypes.c_void_p]
    assert lib.auron_register_udf_callback(ctypes.cast(host_eval, ctypes.c_void_p).value) == 0
    try:
        assert pudf.host_callback_installed()
        resp = json.loads(convert_host_plan_json(json.dumps(_hive_plan(b"7")).encode()))
        assert resp["converted"] is True, resp.get("error")
        rid = resp["root"]["inputs"][0]["resource_id"]
        node = pb.PhysicalPlanNode.FromString(base64.b64decode(resp["root"]["plan_b64"]))
        vals = ["ab", None, "cd", "efg"] * 25
        jb = JBatch.from_arrow(pa.record_batch({"s": pa.array(vals, pa.string())}))
        task = pb.TaskDefinition(plan=node, partition_id=0).SerializeToString()
        with api.native_task(task, {f"{rid}.0": [carry(jb)]}, "cpu") as h:
            got = [r for b in iter(lambda: api.next_batch(h), None) for r in rows([b])]
        assert got == [(v, f"{v.upper()}#7" if v else None) for v in vals]
        assert state["calls"] >= 1
    finally:
        assert lib.auron_register_udf_callback(None) == 0
        assert not pudf.host_callback_installed()


def test_c_channel_needs_no_pyarrow():
    """With pyarrow, pandas, protobuf and JAX unimportable, a ``__hive:`` UDF
    evaluates through a ctypes evaluator that reads and writes the port's
    own Arrow IPC."""
    script = textwrap.dedent("""
        import base64, ctypes, sys
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "jaxlib", "auron_tpu"):
            sys.modules[m] = None
        sys.path.insert(0, %r)
        import numpy as np
        from auron_tpu_torch import types as T
        from auron_tpu_torch.bridge import api, udf
        from auron_tpu_torch.columnar import arrow_ipc
        from auron_tpu_torch.columnar.arrow_c import HostBatch, array_from_pylist
        from auron_tpu_torch.columnar.batch import Batch
        from auron_tpu_torch.exprs import ir
        from auron_tpu_torch.exprs.eval import Evaluator
        EVAL = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t))
        keep = {}
        @EVAL
        def ev(bp, bl, ap, al, op, ol):
            (hb,) = arrow_ipc.read_stream(ctypes.string_at(ap, al))
            xs = hb.columns[0].to_pylist()
            out = [None if x is None else x * int(ctypes.string_at(bp, bl)) for x in xs]
            sch = T.Schema((T.Field("r", T.INT64, True),))
            payload = arrow_ipc.write_stream(
                [HostBatch(sch, len(out), (array_from_pylist(out, T.INT64),))])
            keep["b"] = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
            op[0] = ctypes.cast(keep["b"], ctypes.POINTER(ctypes.c_uint8))
            ol[0] = len(payload)
            return 0
        api.install_udf_callback(ctypes.cast(ev, ctypes.c_void_p).value)
        schema = T.Schema((T.Field("x", T.INT64, True),))
        b = Batch.from_numpy([np.arange(6)], schema, [np.arange(6) != 2], device="cpu")
        e = ir.HostUDF("__hive:" + base64.b64encode(b"3").decode(), (ir.col(0),), T.INT64)
        (cv,) = Evaluator(schema).evaluate(b, [e])
        v, m = cv.values[:6].tolist(), cv.validity[:6].tolist()
        assert v == [0, 3, 0, 9, 12, 15] and m == [True, True, False, True, True, True], (v, m)
        assert "pyarrow" not in [k for k, x in sys.modules.items() if x is not None]
        print("OK")
    """ % REPO)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr[-2000:]


def test_host_udf_is_refused_by_capture_like_trace():
    jschema = JT.Schema.of(JT.Field("x", JT.INT64))
    pschema = PT.Schema((PT.Field("x", PT.INT64, True),))
    for make in (lambda ir, t: ir.HostUDF("f", (ir.col(0),), t.INT64),
                 lambda ir, t: ir.BinaryOp("add", ir.HostUDF("f", (ir.col(0),), t.INT64),
                                           ir.col(0)),
                 lambda ir, t: ir.IsNull(ir.HostUDF("f", (ir.col(0),), t.INT64))):
        assert jfusion.expr_trace_safe(make(jir, JT), jschema) is False
        assert pfusion.expr_capture_safe(make(pir, PT), pschema) is False


def test_udf_class_equals_its_oracle(monkeypatch):
    """``run_udf_class``'s four paths (a Python UDF in q42's converted host
    plan, a Hive UDF through the C library's callback, the geometric-mean
    UDAF over a 4 x 4 file shuffle, the bigram UDTF) equal the numpy
    oracle."""
    from auron_tpu_torch.bridge import host as phost
    from auron_tpu_torch.models import tpcds as pt

    monkeypatch.setenv("AURON_TORCH_DEVICE", "cpu")
    d = pt.generate(0.02, 42)
    st = {}
    try:
        got = pt.run_udf_class(d, device="cpu", stats=st, install="library")
    finally:
        lib = phost.CLibrary("cpu")._lib
        lib.auron_register_udf_callback.argtypes = [ctypes.c_void_p]
        assert lib.auron_register_udf_callback(None) == 0
    assert pt.udf_mismatch(got, pt.udf_class_oracle(d)) is None
    assert st["register_rc"] == 0 and st["udf"]["calls"] >= 2 and st["udf"]["seconds"] > 0
    assert set(st["walls"]) == {"net_q42", "hive", "geo", "ngrams"}
    assert st["geo"]["shuffle_bytes"] > 0
