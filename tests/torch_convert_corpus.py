"""The host-plan corpus the conversion parity tests run through both
packages' converters: every host plan of tests/test_convert.py (with the
serializer-shaped coverage, the range exchange with bounds and the typed
IN list), the plans of tests/test_jvm_contract.py, the Flink calc fragment
of tests/test_flink_front.py and its Kafka source node, and the TPC-DS host
plans of ``auron_tpu_torch.models.tpcds``. Each entry is (name, plan,
conf, udf registry); ``conf`` and the registry are None where the test
that owns the plan converts with the defaults."""

from __future__ import annotations


def _attr(i, name=""):
    return {"kind": "attr", "index": i, "name": name}


def _lit(v, t):
    return {"kind": "lit", "value": v, "type": t}


def _call(name, *children, **extra):
    return {"kind": "call", "name": name, "children": list(children), **extra}


def _scan(schema, rid="t"):
    return {"op": "LocalTableScanExec", "schema": schema, "args": {"resource_id": rid},
            "children": []}


def _sort_field(e, asc=True, nf=True):
    return {"expr": e, "asc": asc, "nulls_first": nf}


SCHEMA = [["k", "long", True], ["v", "long", True], ["s", "string", True]]
KV = [["k", "long", True], ["v", "long", True]]
INTER = [["k", "long", True], ["s#sum", "long", True]]


def _python_map(child, schema=SCHEMA):
    return {"op": "PythonMapExec", "schema": schema, "args": {},
            "children": [child] if child else []}


def _two_stage(n, leaf):
    return {
        "op": "HashAggregateExec", "schema": INTER,
        "args": {"mode": "final", "groupings": [{"expr": _attr(0), "name": "k"}],
                 "aggs": [{"fn": "sum", "expr": _attr(1), "name": "s"}]},
        "children": [{
            "op": "ShuffleExchangeExec", "schema": INTER,
            "args": {"partitioning": {"kind": "hash", "exprs": [_attr(0)], "num_partitions": n}},
            "children": [{
                "op": "HashAggregateExec", "schema": INTER,
                "args": {"mode": "partial", "groupings": [{"expr": _attr(0), "name": "k"}],
                         "aggs": [{"fn": "sum", "expr": _attr(1), "name": "s"}]},
                "children": [leaf],
            }],
        }],
    }


def _test_convert_plans() -> list:
    out = []
    mixed = {"op": "ProjectExec", "schema": [["k", "long", True]],
             "args": {"projections": [_attr(0)]},
             "children": [{"op": "FilterExec", "schema": SCHEMA,
                           "args": {"predicates": [_call("greaterthan", _attr(1),
                                                         _lit(0, "long"))]},
                           "children": [_python_map(_scan(SCHEMA))]}]}
    out.append(("mixed_plan", mixed, None, None))
    proj = {"op": "ProjectExec", "schema": [["k", "long", True]],
            "args": {"projections": [_attr(0)]}, "children": [_scan(SCHEMA)]}
    out.append(("enable_flag_on", proj, None, None))
    out.append(("enable_flag_off", proj, {"convert.enable.project": False}, None))
    udf = {"op": "ProjectExec", "schema": [["r", "long", True]],
           "args": {"projections": [_call("my_weird_fn", _attr(1), type="long")]},
           "children": [_scan(SCHEMA)]}
    out.append(("udf_no_registry", udf, None, None))
    out.append(("udf_registered", udf, None, {"my_weird_fn": len}))
    out.append(("udf_fallback_off", udf, {"udf.fallback.enable": False}, {"my_weird_fn": len}))
    agg_over_py = {
        "op": "HashAggregateExec", "schema": [["k", "long", True], ["c#count", "long", False]],
        "args": {"mode": "partial", "groupings": [{"expr": _attr(0), "name": "k"}],
                 "aggs": [{"fn": "count_star", "expr": None, "name": "c"}]},
        "children": [_python_map(_scan(SCHEMA))]}
    out.append(("agg_over_python", agg_over_py, None, None))
    sandwich = _python_map({"op": "SortExec", "schema": SCHEMA,
                            "args": {"order": [{"expr": _attr(0), "asc": True}]},
                            "children": [_python_map(_scan(SCHEMA))]})
    out.append(("sort_sandwich", sandwich, None, None))
    out.append(("scan_under_host_parent", _python_map(
        {"op": "FileSourceScanExec", "schema": SCHEMA, "args": {"files": ["/tmp/x.parquet"]},
         "children": []}), None, None))
    out.append(("two_stage_mesh", _two_stage(8, _scan(KV, rid="conv_fact")), None, None))
    out.append(("ffi_boundary", {
        "op": "ProjectExec", "schema": [["doubled", "long", True]],
        "args": {"projections": [_call("multiply", _attr(1), _lit(2, "long"))]},
        "children": [_python_map(None, KV)]}, None, None))
    files = [{"path": f"/data/y{y}.parquet", "partition": {"year": y}, "record_count": 10}
             for y in (2022, 2023, 2024)]
    iceberg = {"op": "IcebergScanExec", "schema": [["year", "int", True], ["v", "long", True]],
               "args": {"files": files, "filters": [_call("greaterthanorequal", _attr(0),
                                                          _lit(2023, "int"))]},
               "children": []}
    out.append(("table_format_prunes", iceberg, None, None))
    out.append(("table_format_off", iceberg, {"convert.enable.table_formats": False}, None))
    out.append(("table_format_in_pipeline", {
        "op": "HashAggregateExec", "schema": [["year", "int", True], ["c#count", "long", False]],
        "args": {"mode": "partial", "groupings": [{"expr": _attr(0), "name": "year"}],
                 "aggs": [{"fn": "count_star", "expr": None, "name": "c"}]},
        "children": [{"op": "PaimonScanExec",
                      "schema": [["year", "int", True], ["v", "long", True]],
                      "args": {"files": [], "filters": []}, "children": []}]}, None, None))
    for i, bad in enumerate((_call("in", _attr(0)), _call("like", _attr(0)),
                             {"kind": "attr", "index": -1}, _call("scalarsubquery"))):
        out.append((f"malformed_expr_{i}", {"op": "FilterExec", "schema": SCHEMA,
                                            "args": {"predicates": [bad]},
                                            "children": [_scan(SCHEMA)]}, None, None))
    bad_schema = [["m", "interval day to second", True]]
    out.append(("unsupported_column_type", {
        "op": "UnionExec", "schema": SCHEMA, "args": {},
        "children": [_scan(SCHEMA, rid="a"),
                     {"op": "ProjectExec", "schema": bad_schema,
                      "args": {"projections": [_attr(0)]},
                      "children": [_scan(bad_schema, rid="b")]}]}, None, None))
    ms = [["m", "map<string,int>", True], ["st", "struct<a:int,b:array<long>>", True]]
    out.append(("map_struct_types", {"op": "ProjectExec", "schema": ms,
                                     "args": {"projections": [_attr(0), _attr(1)]},
                                     "children": [_scan(ms, rid="ms")]}, None, None))
    # serializer-shaped coverage
    scan = _scan(SCHEMA, rid="t")
    out.append(("window", {
        "op": "WindowExec", "schema": SCHEMA + [["rn", "long", True]],
        "args": {"partition_by": [_attr(0)], "order": [_sort_field(_attr(1))],
                 "funcs": [{"kind": "row_number", "name": "rn"},
                           {"kind": "agg", "agg": "sum", "expr": _attr(1),
                            "frame_whole": True, "name": "s"}]},
        "children": [scan]}, None, None))
    expand = {"op": "ExpandExec", "schema": KV,
              "args": {"projections": [[_attr(0), _attr(1)], [_attr(0), _lit(None, "long")]]},
              "children": [scan]}
    union = {"op": "UnionExec", "schema": KV, "args": {}, "children": [expand, expand]}
    out.append(("take_ordered_union_expand", {
        "op": "TakeOrderedAndProjectExec", "schema": [["k", "long", True]],
        "args": {"limit": 5, "order": [_sort_field(_attr(1), asc=False)],
                 "projections": [_attr(0)]},
        "children": [union]}, None, None))
    out.append(("generate", {
        "op": "GenerateExec", "schema": KV,
        "args": {"generator": "explode", "gen_expr": _call("makearray", _attr(0), _attr(1)),
                 "required_cols": [0], "outer": False, "json_fields": []},
        "children": [scan]}, None, None))
    out.append(("data_writing", {
        "op": "DataWritingCommandExec", "schema": [],
        "args": {"format": "parquet", "path": "/tmp/out_w", "partition_by": [], "props": {}},
        "children": [scan]}, None, None))
    rng = {"op": "ShuffleExchangeExec", "schema": SCHEMA,
           "args": {"partitioning": {"kind": "range", "num_partitions": 4,
                                     "order": [_sort_field(_attr(0))],
                                     "bounds": [[{"value": 10, "type": "long"}],
                                                [{"value": 20, "type": "long"}],
                                                [{"value": 30, "type": "long"}]]}},
           "children": [_scan(SCHEMA)]}
    out.append(("range_exchange_bounds", rng, None, None))
    no_bounds = {**rng, "args": {"partitioning": {**rng["args"]["partitioning"], "bounds": []}}}
    out.append(("range_exchange_no_bounds", no_bounds, None, None))
    out.append(("in_list_typed", {
        "op": "FilterExec", "schema": [["k", "long", True]],
        "args": {"predicates": [{"kind": "call", "name": "in", "children": [_attr(0)],
                                 "values": [1, 3, 5], "value_type": "long"}]},
        "children": [_scan([["k", "long", True]], rid="inlist")]}, None, None))
    out.append(("service_shape", {"op": "ProjectExec", "schema": [["k", "long", True]],
                                  "args": {"projections": [_attr(0)]},
                                  "children": [_python_map(_scan(SCHEMA))]}, None, None))
    return out


def _jvm_contract_plans() -> list:
    lschema, rschema = KV, [["k2", "long", True], ["b", "long", True]]
    smj = {"op": "SortMergeJoinExec", "schema": lschema + rschema,
           "args": {"left_keys": [_attr(0)], "right_keys": [_attr(0)], "join_type": "inner"},
           "children": [_python_map(_scan(lschema, "l"), lschema),
                        _python_map(_scan(rschema, "r"), rschema)]}
    ffi_map = _two_stage(2, {"op": "ProjectExec", "schema": KV,
                             "args": {"projections": [_attr(0, "k"), _attr(1, "v")]},
                             "children": [_python_map(_scan(KV, "t"), KV)]})
    return [("jvm_two_stage", _two_stage(2, _scan(KV, "fact")), None, None),
            ("jvm_multi_input_join", smj, None, None),
            ("jvm_multi_stage_ffi_input", ffi_map, None, None)]


def _flink_plans() -> list:
    from test_flink_front import _flink_calc_json

    kafka = {"op": "KafkaSourceExec", "schema": [["k", "long", False], ["v", "string", True]],
             "args": {"topic": "flinktopic", "source_resource_id": "flink_kafka_flinktopic_0",
                      "startup_mode": "earliest", "start_offsets": {"0": 7},
                      "format": "json", "on_error": "skip"},
             "children": []}
    return [("flink_calc", _flink_calc_json(), None, None),
            ("flink_kafka_source", kafka, None, None)]


def _tpcds_plans() -> list:
    from auron_tpu_torch.models import tpcds

    d = tpcds.generate(0.002, 42)
    return [("tpcds_q42", tpcds.q42_host_plan(), None, None),
            ("tpcds_q93", tpcds.q93_host_plan(4), None, None),
            ("tpcds_q3", tpcds.q3_host_plan(4), None, None),
            ("tpcds_range_sort", tpcds.range_sort_host_plan(d, 4), None, None)]


def corpus() -> list:
    return _test_convert_plans() + _jvm_contract_plans() + _flink_plans() + _tpcds_plans()
