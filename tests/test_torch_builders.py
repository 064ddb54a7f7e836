"""The port's plan builders (``auron_tpu_torch/plan/builders.py``) against
the reference's (``auron_tpu/plan/builders.py``): every builder, called
with the same arguments in both packages' IR, gives the same bytes as the
reference's ``SerializeToString(deterministic=True)`` (exact); the port's
``dtype_to_proto``/``schema_to_proto`` likewise, and the planner reads back
every type it writes."""

import decimal
import math
from types import SimpleNamespace

import pytest

from auron_tpu import types as JT
from auron_tpu.exprs import ir as jir
from auron_tpu.ops.sortkeys import SortSpec as JSpec
from auron_tpu.plan import builders as JB
from auron_tpu.plan import planner as jplanner

from auron_tpu_torch import types as PT
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.ops.sortkeys import SortSpec as PSpec
from auron_tpu_torch.plan import builders as PB
from auron_tpu_torch.plan import planner as pplanner

JAX = SimpleNamespace(T=JT, ir=jir, Spec=JSpec, B=JB, planner=jplanner)
PORT = SimpleNamespace(T=PT, ir=pir, Spec=PSpec, B=PB, planner=pplanner)


def _types(T):
    lst = T.DataType(T.TypeKind.LIST, inner=(T.INT32,))
    mp = T.DataType(T.TypeKind.MAP, inner=(T.STRING, T.FLOAT64))
    st = T.DataType(T.TypeKind.STRUCT, inner=(T.INT64, lst), struct_names=("a", "b"))
    return [T.NULL, T.BOOL, T.INT8, T.INT16, T.INT32, T.INT64, T.FLOAT32, T.FLOAT64,
            T.DATE32, T.TIMESTAMP, T.STRING, T.BINARY, T.decimal(7, 2), T.decimal(38, 18),
            lst, mp, st]


def _schema(T):
    return T.Schema(tuple(T.Field(f"c{i}", t, i % 3 != 0) for i, t in enumerate(_types(T))))


def _kv(T):
    return T.Schema((T.Field("k", T.INT64, True), T.Field("v", T.FLOAT64, False),
                     T.Field("s", T.STRING, True)))


def _exprs(m):
    """One expression of each kind the builders serialize."""
    T, ir = m.T, m.ir
    c0, c1, c2 = ir.col(0, "k"), ir.col(1), ir.col(2, "s")
    d72 = T.decimal(7, 2)
    return [
        c0, ir.lit(3), ir.lit(-(2**40)), ir.lit(True), ir.lit(2.5), ir.lit(math.nan),
        ir.lit(-0.0), ir.lit("héllo"), ir.lit(b"\x00x"), ir.Literal(None, T.INT64),
        ir.Literal(19000, T.DATE32), ir.Literal(-5, T.TIMESTAMP),
        ir.Literal(decimal.Decimal("-12.34"), d72), ir.Literal(None, d72),
        ir.Cast(c1, T.INT32), ir.Cast(c2, d72, True),
        ir.BinaryOp("add", c0, ir.lit(1)), ir.BinaryOp("and", ir.IsNull(c0), ir.IsNotNull(c2)),
        ir.Not(ir.BinaryOp("lt", c1, ir.lit(0.5))),
        ir.If(ir.IsNull(c0), ir.Literal(None, T.INT64), c0),
        ir.Case(((ir.BinaryOp("eq", c0, ir.lit(1)), ir.lit("a")),), ir.lit("b")),
        ir.Case(((ir.BinaryOp("eq", c0, ir.lit(1)), ir.lit("a")),
                 (ir.BinaryOp("eq", c0, ir.lit(2)), ir.lit("c"))), None),
        ir.In(c0, (1, 2, 3), False), ir.In(c2, ("x", "y"), True),
        ir.In(ir.Cast(c1, d72), (ir.Literal(decimal.Decimal("1.25"), d72),), False),
        ir.Coalesce((c0, ir.lit(0))), ir.Like(c2, "a%_b", True, "!"),
        ir.ScalarFunc("upper", (c2,)), ir.ScalarFunc("abs", (c0,), T.INT64),
        ir.SparkPartitionId(), ir.MonotonicId(), ir.RowNum(),
        ir.ScalarSubquery("sub0", T.FLOAT64),
    ]


def _builds(m) -> dict:
    """Every builder of the reference, by name, with fixed arguments."""
    T, ir, Spec, B = m.T, m.ir, m.Spec, m.B
    kv = _kv(T)
    leaf = B.memory_scan(kv, "src")
    c0, c1 = ir.col(0), ir.col(1)
    part = B.hash_partitioning([c0, ir.col(2)], 7)
    es = _exprs(m)
    out = {f"expr_to_proto[{i}]": (lambda e=e: B.expr_to_proto(e)) for i, e in enumerate(es)}
    out.update({
        "literal_to_proto": lambda: B.literal_to_proto(decimal.Decimal("9.999"),
                                                       T.decimal(10, 3)),
        "literal_to_proto_null": lambda: B.literal_to_proto(None, T.STRING),
        "sort_field": lambda: B.sort_field(c0, Spec(asc=False, nulls_first=False)),
        "dtype_to_proto": lambda: m.planner.dtype_to_proto(_types(T)[-1]),
        "schema_to_proto": lambda: m.planner.schema_to_proto(_schema(T)),
        "memory_scan": lambda: B.memory_scan(_schema(T), "r0"),
        "ffi_reader": lambda: B.ffi_reader(kv, "r1"),
        "parquet_scan": lambda: B.parquet_scan(kv, ["/a/b.parquet", "c.parquet"],
                                               [ir.BinaryOp("gt", c0, ir.lit(3))], "fs"),
        "project": lambda: B.project(leaf, [(ir.BinaryOp("mul", c1, ir.lit(2.0)), "v2"),
                                            (c0, "k")]),
        "filter_": lambda: B.filter_(leaf, [ir.IsNotNull(c0), ir.BinaryOp("gt", c1, ir.lit(0.0))]),
        "limit": lambda: B.limit(leaf, 2**40),
        "union": lambda: B.union([leaf, B.memory_scan(kv, "src2")]),
        "rename_columns": lambda: B.rename_columns(leaf, ["a", "b", "c"]),
        "empty_partitions": lambda: B.empty_partitions(kv, 3),
        "coalesce_batches": lambda: B.coalesce_batches(leaf, 4096),
        "debug": lambda: B.debug(leaf, "t"),
        "expand": lambda: B.expand(leaf, [[c0, ir.Literal(None, T.FLOAT64)], [c0, c1]],
                                   ["k", "v"]),
        "hash_agg": lambda: B.hash_agg(
            leaf, [(c0, "k")], [("sum", c1, "s"), ("count_star", None, "n"), ("avg", c1, "a"),
                                ("min", c0, "lo"), ("max", c0, "hi"), ("first", c1, "f"),
                                ("first_ignores_null", c1, "fi"), ("count", c0, "c"),
                                ("collect_list", c0, "cl"), ("collect_set", c0, "cs"),
                                ("host_udaf", c1, "u", "my_udaf")], "partial"),
        "hash_agg_final": lambda: B.hash_agg(leaf, [], [("sum", c1, "s")], "final"),
        "hash_agg_merge": lambda: B.hash_agg(leaf, [(c0, "k")], [("sum", c1, "s")],
                                             "partial_merge"),
        "sort": lambda: B.sort(leaf, [(c1, Spec(asc=False)), (c0, Spec())], fetch=10),
        "sort_nofetch": lambda: B.sort(leaf, [(c0, Spec(nulls_first=False))]),
        "sort_merge_join": lambda: B.sort_merge_join(
            leaf, B.memory_scan(kv, "r"), [c0], [c0], "left_anti",
            ir.BinaryOp("lt", c1, ir.col(4))),
        "hash_join": lambda: B.hash_join(leaf, B.memory_scan(kv, "r"), [c0, ir.col(2)],
                                         [c0, ir.col(2)], "full", build_side="left",
                                         cached_build_id="b0"),
        "hash_join_existence": lambda: B.hash_join(leaf, B.memory_scan(kv, "r"), [c0], [c0],
                                                   "existence"),
        "hash_partitioning": lambda: part,
        "shuffle_writer": lambda: B.shuffle_writer(leaf, part, "/w/x.data", "/w/x.index"),
        "mesh_exchange": lambda: B.mesh_exchange(leaf, part, "ex0"),
        "rss_shuffle_writer": lambda: B.rss_shuffle_writer(leaf, part, "rss0"),
        "ipc_reader": lambda: B.ipc_reader(kv, "ex0"),
        "window": lambda: B.window(
            leaf, [ir.col(2)], [(c1, Spec(asc=False))],
            [("rank", None, None, 1, False, "r"), ("lag", None, c0, 2, False, "l"),
             ("agg", "sum", c1, 0, True, "w"), ("lead", None, c0, -3, False, "ld")]),
        "generate": lambda: B.generate(leaf, "json_tuple", ir.col(2), [0, 1], outer=True,
                                       json_fields=["a", "b"], elem_name="e", pos_name="p"),
        "parquet_sink": lambda: B.parquet_sink(leaf, "/out", {"z": "1", "a": "", "aa": "x"},
                                               ["k"]),
        "ipc_writer": lambda: B.ipc_writer(leaf, "out0"),
        "kafka_scan": lambda: B.kafka_scan(
            kv, "topic", "src", startup_mode="offsets",
            start_offsets={3: 10, 0: 2**64 - 1, "7": 5, 2**32 - 1: 0}, data_format="protobuf",
            on_error="null", pb_field_ids=[1, 2, 3], max_batch_records=500,
            zigzag_cols=[0]),
        "task": lambda: B.task(B.sort(leaf, [(c0, Spec())], fetch=3), stage_id=2,
                               partition_id=5, conf={"b": 1, "a": "x", "auron.smj": True,
                                                     "": "e"}),
    })
    return out


CASES = sorted(_builds(JAX))


@pytest.mark.parametrize("name", CASES)
def test_builder_bytes_equal_the_reference(name):
    want = _builds(JAX)[name]().SerializeToString(deterministic=True)
    got = _builds(PORT)[name]()
    assert got.SerializeToString() == want


def test_every_reference_builder_has_a_case():
    """Each public builder of the reference is exercised above and exists in
    the port."""
    import inspect

    names = {n for n, f in inspect.getmembers(JB, inspect.isfunction)
             if f.__module__ == JB.__name__ and not n.startswith("_")}
    covered = {c.split("[")[0] for c in CASES} | {"hash_agg", "sort"}
    assert names <= covered | {"hash_agg_final", "hash_agg_merge"}, names - covered
    for n in names:
        assert callable(getattr(PB, n)), n


@pytest.mark.parametrize("i", range(len(_types(PT))))
def test_dtype_round_trip(i):
    t = _types(PT)[i]
    assert pplanner.dtype_from_proto(pplanner.dtype_to_proto(t)) == t
    assert pplanner.schema_from_proto(pplanner.schema_to_proto(_schema(PT))) == _schema(PT)
