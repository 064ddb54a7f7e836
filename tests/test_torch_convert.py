"""Conversion parity: the port's host-plan converters (``auron_tpu_torch/
convert/``) against the reference's (``auron_tpu/convert/``).

Every host plan of ``tests/torch_convert_corpus.py`` (the plans of
test_convert.py, test_jvm_contract.py and test_flink_front.py, and the
TPC-DS host plans), plus an expression-coverage set, goes through both
packages' ``convert_host_plan_json`` (or ``_response(convert_plan(...))``
where a conf or a UDF registry is given). The two responses are equal JSON
with the stage namespace fixed in both (``_namespace``): tags with their
reasons, paths, schemas, stage templates, ``ffi_input_ids`` and
``task_partitions``. Every ``plan_b64`` is compared by message, both
decoded with the reference's ``plan_pb2``; where the plan holds no map
field the bytes are equal too (the reference's serializer does not order
map entries). Malformed JSON, an unsupported column type and a disabled
operator flag give the reference's response.
"""

import base64
import json

import pytest

from auron_tpu.convert import service as jservice
from auron_tpu.convert.converters import convert_plan as jconvert
from auron_tpu.proto import plan_pb2
from auron_tpu.utils.config import Configuration as JConf

from auron_tpu_torch.bridge import api as papi
from auron_tpu_torch.convert import service as pservice
from auron_tpu_torch.convert.converters import convert_plan as pconvert
from auron_tpu_torch.utils.config import Configuration as PConf

from torch_convert_corpus import _attr, _call, _lit, _scan, corpus

CORPUS = corpus()
SCHEMA = [["k", "long", True], ["v", "long", True], ["s", "string", True],
          ["d", "date", True], ["m", "decimal(9,2)", True], ["b", "binary", True],
          ["a", "array<long>", True]]


def _project(*exprs, schema=None):
    return {"op": "ProjectExec", "schema": schema or [[f"c{i}", "long", True]
                                                      for i in range(len(exprs))],
            "args": {"projections": list(exprs)}, "children": [_scan(SCHEMA)]}


#: one projection per expression family of convert/exprs.py
EXPRS = {
    "binops": [_call(n, _attr(0), _attr(1)) for n in (
        "add", "subtract", "multiply", "divide", "remainder", "pmod", "equalto", "lessthan",
        "lessthanorequal", "greaterthan", "greaterthanorequal")],
    "logic": [_call("and", _call("not", _call("isnull", _attr(0))),
                    _call("or", _call("isnotnull", _attr(1)), _lit(True, "boolean")))],
    "cast_ok": [_call("cast", _attr(0), to="int", **{"from": "long"}),
                _call("cast", _lit("1.5", "string"), to="decimal(5,2)", **{"try": True})],
    "cast_refused": [_call("cast", _attr(6), to="int", **{"from": "array<long>"})],
    "cast_literal_source": [_call("cast", _lit(1, "int"), to="array<int>")],
    "if_case_coalesce": [_call("if", _call("lessthan", _attr(0), _lit(3, "long")), _attr(0),
                               _attr(1)),
                         _call("casewhen", branches=[[_call("equalto", _attr(0), _lit(1, "long")),
                                                      _lit(10, "long")]],
                               **{"else": _attr(1)}),
                         _call("casewhen", branches=[[_lit(False, "boolean"), _attr(0)]]),
                         _call("coalesce", _attr(0), _attr(1), _lit(0, "long"))],
    "casewhen_without_branches": [_call("casewhen", _attr(0))],
    "like": [_call("like", _attr(2), pattern="a%_b", escape="!"),
             _call("like", _attr(2), pattern="x%", negated=True)],
    "in_lists": [_call("in", _attr(0), values=[1, None, 3], value_type="long"),
                 _call("in", _attr(3), values=[18000, 18001], value_type="date"),
                 _call("in", _attr(4), values=["1.50", "2.25"], value_type="decimal(9,2)"),
                 _call("in", _attr(5), values=[base64.b64encode(b"ab").decode()],
                       value_type="binary"),
                 _call("in", _attr(2), values=["a", "b"], value_type="string", negated=True),
                 _call("in", _attr(0), values=[1.0, 2.5], value_type="double"),
                 _call("in", _attr(0), values=[1, 0], value_type="boolean")],
    "task_context": [_call("sparkpartitionid"), _call("monotonicallyincreasingid"),
                     _call("scalarsubquery", resource_id="sq0", type="decimal(12,2)")],
    "literals": [_lit(None, "long"), _lit(base64.b64encode(b"\x00\x01").decode(), "binary"),
                 _lit("1.25", "decimal(9,2)"), _lit(2.5, "double"), _lit(19000, "date")],
    "functions": [_call("upper", _attr(2)), _call("stringtrim", _attr(2)),
                  _call("dayofmonth", _attr(3)), _call("dateadd", _attr(3), _lit(2, "int")),
                  _call("abs", _attr(0)), _call("makearray", _attr(0), _attr(1))],
    "deferred_map_struct": [_call("createnamedstruct", _lit("a", "string"), _attr(0)),
                            _call("map_keys", _attr(0)), _call("str_to_map", _attr(2))],
    "hive_udf": [_call("__hive_udf__", _attr(0), udf_blob="AAEC", type="long")],
    "unknown_function": [_call("no_such_fn", _attr(0))],
    "unknown_kind": [{"kind": "lambda"}],
    "unbound": [_attr(-1)],
}

EXPR_PLANS = [(f"exprs_{k}", _project(*v), None, None) for k, v in EXPRS.items()]
EXPR_PLANS += [
    ("exprs_hive_udf_fallback_off", _project(*EXPRS["hive_udf"]),
     {"udf.fallback.enable": False}, None),
    ("exprs_udf_registered", _project(_call("no_such_fn", _attr(0), type="double")), None,
     {"no_such_fn": abs}),
]


@pytest.fixture(autouse=True)
def fixed_namespace(monkeypatch):
    """Both services' stage namespace fixed: the pid-and-counter salt is the
    one part of a response that differs between two conversions."""
    monkeypatch.setattr(jservice, "_namespace", lambda: "cNS_")
    monkeypatch.setattr(pservice, "_namespace", lambda: "cNS_")


def _has_map(msg) -> bool:
    for fd, value in msg.ListFields():
        if fd.message_type is not None and fd.message_type.GetOptions().map_entry:
            return True
        if fd.message_type is not None:
            items = [value] if hasattr(value, "ListFields") else list(value)
            if any(_has_map(m) for m in items):
                return True
    return False


def _split_plans(node, out: list):
    """Replace every plan_b64 in a response by its index in ``out``."""
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "plan_b64":
                out.append(base64.b64decode(v))
                node[k] = len(out) - 1
            else:
                _split_plans(v, out)
    elif isinstance(node, list):
        for v in node:
            _split_plans(v, out)


def assert_same_response(ref: bytes, port: bytes) -> dict:
    r, p = json.loads(ref), json.loads(port)
    rplans, pplans = [], []
    _split_plans(r, rplans)
    _split_plans(p, pplans)
    assert p == r
    assert len(pplans) == len(rplans)
    for rb, pb_ in zip(rplans, pplans):
        rm = plan_pb2.PhysicalPlanNode.FromString(rb)
        assert plan_pb2.PhysicalPlanNode.FromString(pb_) == rm
        if not _has_map(rm):
            assert pb_ == rb
    return r


def _both(plan, conf, udfs) -> tuple[bytes, bytes]:
    if conf is None and udfs is None:
        payload = plan if isinstance(plan, str) else json.dumps(plan)
        return (jservice.convert_host_plan_json(payload),
                pservice.convert_host_plan_json(payload))
    return (json.dumps(jservice._response(jconvert(plan, JConf(conf or {}), udfs))).encode(),
            json.dumps(pservice._response(pconvert(plan, PConf(conf or {}), udfs))).encode())


@pytest.mark.parametrize("name,plan,conf,udfs", CORPUS + EXPR_PLANS,
                         ids=[c[0] for c in CORPUS + EXPR_PLANS])
def test_response_equals_the_reference(name, plan, conf, udfs):
    ref, port = _both(plan, conf, udfs)
    resp = assert_same_response(ref, port)
    assert "error" not in resp, resp


def test_the_corpus_converts_what_the_reference_tests_expect():
    """A few of the owning tests' verdicts, read off the port's responses."""
    got = {name: json.loads(_both(plan, conf, udfs)[1]) for name, plan, conf, udfs in CORPUS}
    assert got["mixed_plan"]["root"]["kind"] == "segment"
    assert got["enable_flag_off"]["root"]["kind"] == "host"
    assert got["udf_registered"]["root"]["kind"] == "segment"
    assert got["range_exchange_no_bounds"]["root"]["kind"] == "host"
    assert "bounds" in got["range_exchange_no_bounds"]["tags"][0][2]
    assert len(got["jvm_two_stage"]["root"]["stages"]) == 2
    for name in ("tpcds_q42", "tpcds_q93", "tpcds_q3", "tpcds_range_sort"):
        assert got[name]["converted"] and got[name]["root"]["inputs"] == [], name
        assert all(ok for _, ok, _ in got[name]["tags"]), got[name]["tags"]
    assert [len(got[n]["root"]["stages"]) for n in ("tpcds_q42", "tpcds_q93", "tpcds_q3",
                                                    "tpcds_range_sort")] == [1, 2, 2, 2]


@pytest.mark.parametrize("payload", [b"{not json", b"{}", b'{"op": "ProjectExec"}',
                                     b'{"op": "ProjectExec", "schema": [["k", "long"]]}',
                                     b"\xff\xfe", b"[]"])
def test_malformed_payloads_give_the_reference_error(payload):
    ref, port = jservice.convert_host_plan_json(payload), pservice.convert_host_plan_json(payload)
    assert json.loads(port)["converted"] is False
    assert port == ref
    assert papi.convert_plan_json(payload) == port


def test_disabled_flag_and_unsupported_type_through_the_service(monkeypatch):
    plans = {name: plan for name, plan, _, _ in CORPUS}
    monkeypatch.setenv("AURON_TPU_CONVERT_ENABLE_PROJECT", "false")
    monkeypatch.setenv("AURON_TPU_CONVERT_ENABLE_SHUFFLE_EXCHANGE", "false")
    for name in ("enable_flag_on", "mixed_plan", "tpcds_q93", "unsupported_column_type"):
        ref, port = _both(plans[name], None, None)
        resp = assert_same_response(ref, port)
        assert any("disabled by convert.enable" in (why or "") for _, _, why in resp["tags"]) \
            or name == "unsupported_column_type"


def test_the_bridge_entry_is_the_service():
    plan = json.dumps(CORPUS[0][1]).encode()
    assert papi.convert_plan_json(plan) == pservice.convert_host_plan_json(plan)


def test_host_udf_decodes_and_evaluates_through_the_registry():
    import numpy as np

    from auron_tpu_torch import proto as pb
    from auron_tpu_torch import types as T
    from auron_tpu_torch.columnar.batch import Batch
    from auron_tpu_torch.exprs import ir
    from auron_tpu_torch.exprs.eval import Evaluator
    from auron_tpu_torch.plan import builders as B
    from auron_tpu_torch.plan.planner import expr_from_proto

    e = ir.HostUDF("my_fn", (ir.col(0),), T.FLOAT64)
    wire = B.expr_to_proto(e).SerializeToString()
    from auron_tpu.exprs import ir as jir
    from auron_tpu import types as JT
    from auron_tpu.plan import builders as JB

    assert JB.expr_to_proto(jir.HostUDF("my_fn", (jir.col(0),), JT.FLOAT64)) \
        .SerializeToString() == wire
    back = expr_from_proto(pb.PhysicalExprNode.FromString(wire))
    assert back == e
    schema = T.Schema((T.Field("x", T.INT64, True),))
    b = Batch.from_numpy([np.arange(4)], schema, device="cpu")
    from auron_tpu_torch.bridge import udf

    def half(args, n):
        import pyarrow.compute as pc

        return pc.divide(pc.cast(args[0], "double"), 2.0)

    udf.register_udf("my_fn", half)
    (cv,) = Evaluator(schema).evaluate(b, [back])
    assert cv.dtype == T.FLOAT64
    assert cv.values[:4].tolist() == [0.0, 0.5, 1.0, 1.5] and cv.validity[:4].all()


def test_the_conversion_path_needs_no_pyarrow_pandas_protobuf_or_jax():
    """With those packages unimportable, the corpus converts (the range
    bounds included) and converted q42 and the range sort run on the CPU;
    no module of convert/ imports them."""
    import os
    import subprocess
    import sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = textwrap.dedent("""
        import json, sys
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "jaxlib", "auron_tpu"):
            sys.modules[m] = None  # any import of them raises ImportError
        import pkgutil
        import auron_tpu_torch.convert as conv
        for m in pkgutil.walk_packages(conv.__path__, "auron_tpu_torch.convert."):
            __import__(m.name)
        from auron_tpu_torch.bridge import api
        from auron_tpu_torch.models import tpcds
        d = tpcds.generate(0.002, 3)
        for plan in (tpcds.q42_host_plan(), tpcds.q93_host_plan(), tpcds.q3_host_plan(),
                     tpcds.range_sort_host_plan(d)):
            resp = json.loads(api.convert_plan_json(json.dumps(plan).encode()))
            assert resp["converted"] and all(t[1] for t in resp["tags"]), resp
        got = tpcds.run_q42_converted(d, device="cpu")
        assert got["brand"].tolist() == tpcds.q42_class_oracle(d)["brand"].tolist()
        parts = tpcds.run_range_sort_converted(d, device="cpu")
        assert tpcds.range_sort_mismatch(parts, tpcds.range_sort_oracle(d)) is None
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", script], cwd=repo,
                       env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert "OK" in r.stdout


@pytest.mark.parametrize("t", ["boolean", "TINYINT", "smallint", "Integer", "bigint", "float",
                               "double", "string", "binary", "date", "timestamp", "null",
                               "decimal", "decimal(38,10)", "decimal(0,0)", "array<decimal(9,2)>",
                               "map<string,array<int>>", "struct<A:int,b:map<long,string>>",
                               "map<int>", "interval", "iceberg:{}"])
def test_parse_type_equals_the_reference(t):
    from auron_tpu.convert.hostplan import parse_type as jparse

    from auron_tpu_torch.convert.hostplan import parse_type as pparse
    from auron_tpu_torch.convert.service import _type_name

    try:
        want = jparse(t)
    except ValueError as e:
        with pytest.raises(ValueError, match=__import__("re").escape(str(e))):
            pparse(t)
        return
    got = pparse(t)
    assert repr(got) == repr(want)
    assert _type_name(got) == jservice._type_name(want)
