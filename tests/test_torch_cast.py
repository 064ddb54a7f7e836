"""The port's casts (``auron_tpu_torch/exprs/cast.py`` and the evaluator's
cast paths) against the JAX package's (``auron_tpu/exprs/cast.py``): the
cases of ``tests/test_cast.py`` without the list, struct and map ones, each
run through both packages and held against each other (and the Spark value
the reference test names), plus decimal casts over seeded numpy columns:
decimal <-> decimal, decimal <-> int, decimal <-> float (HALF_UP ties of
both signs, precision boundaries), string -> decimal, decimal64 <-> wide.
Values compare exactly; decimals as Decimals."""

import datetime as dt
import decimal as pydec

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu import types as JT
from auron_tpu.columnar import Batch as JBatch
from auron_tpu.exprs import cast as JC
from auron_tpu.exprs import ir as jir
from auron_tpu.exprs.eval import Evaluator as JEval

from auron_tpu_torch import types as PT
from auron_tpu_torch.exprs import cast as PC
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.exprs.eval import Evaluator as PEval
from torch_carry import carry


def _decode(o, n: int, values, validity, dict_vals) -> list:
    vals = np.asarray(values)[:n].tolist()
    mask = np.asarray(validity)[:n].tolist()
    if o.dtype.is_dict_encoded:
        return [dict_vals[v] if m else None for v, m in zip(vals, mask)]
    return [v if m else None for v, m in zip(vals, mask)]


def eval_both(data: dict, build, schema=None) -> list:
    """Evaluate ``build(ir, types)`` over one batch in both packages; assert
    the columns equal and return the port's."""
    jb = JBatch.from_pydict(data, schema=schema)
    pb = carry(jb)
    n = jb.num_rows()
    jouts = JEval(jb.schema, partition_id=0, resources={}).evaluate(jb, build(jir, JT))
    pouts = PEval(pb.schema).evaluate(pb, build(pir, PT))
    res = []
    for jo, po in zip(jouts, pouts):
        assert repr(jo.dtype) == repr(po.dtype)
        want = _decode(jo, n, jo.values, jo.validity,
                       jo.dict.to_pylist() if jo.dict is not None else None)
        got = _decode(po, n, po.values.numpy(), po.validity.numpy(), po.dict)
        assert got == want, (po.dtype, got, want)
        res.append(got)
    return res


def _both_scalar(fn: str, *args, **kw):
    want = getattr(JC, fn)(*args, **kw)
    got = getattr(PC, fn)(*args, **kw)
    assert got == want, (fn, args, got, want)
    return got


def _days(y, m, d):
    return (dt.date(y, m, d) - dt.date(1970, 1, 1)).days


def _us(y, mo, d, h=0, mi=0, s=0, us=0):
    base = dt.datetime(y, mo, d, h, mi, s, tzinfo=dt.timezone.utc)
    return int(base.timestamp()) * 1_000_000 + us


# ---------------------------------------------------------------------------
# the host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,expect", [
    ("2021-03-05", _days(2021, 3, 5)), ("2021-3-5", _days(2021, 3, 5)),
    ("2021-03", _days(2021, 3, 1)), ("2021", _days(2021, 1, 1)),
    (" 2021-01-01 ", _days(2021, 1, 1)), ("2021-01-01T12:33:00", _days(2021, 1, 1)),
    ("2021-01-01 whatever", _days(2021, 1, 1)), ("02021-01-01", _days(2021, 1, 1)),
    ("21-01-01", None), ("2021-13-01", None), ("2021-02-30", None), ("2021/01/01", None),
    ("", None), ("abc", None),
])
def test_string_to_date_lenient(s, expect):
    assert _both_scalar("spark_string_to_date", s) == expect


@pytest.mark.parametrize("s,expect", [
    ("2019-10-06 10:11:12", _us(2019, 10, 6, 10, 11, 12)),
    ("2019-10-06T10:11:12", _us(2019, 10, 6, 10, 11, 12)),
    ("2019-10-06 10:11", _us(2019, 10, 6, 10, 11)), ("2019-10-06 10", _us(2019, 10, 6, 10)),
    ("2019-10-06", _us(2019, 10, 6)), ("2019-10", _us(2019, 10, 1)), ("2019", _us(2019, 1, 1)),
    ("2019-10-06 10:11:12.345678", _us(2019, 10, 6, 10, 11, 12, 345678)),
    ("2019-10-06 10:11:12.123456789", _us(2019, 10, 6, 10, 11, 12, 123456)),
    ("2019-10-06 10:11:12.5", _us(2019, 10, 6, 10, 11, 12, 500000)),
    ("2019-10-06 10:11:12Z", _us(2019, 10, 6, 10, 11, 12)),
    ("2019-10-06 10:11:12 UTC", _us(2019, 10, 6, 10, 11, 12)),
    ("2019-10-06 10:11:12+08:00", _us(2019, 10, 6, 2, 11, 12)),
    ("2019-10-06 10:11:12-0130", _us(2019, 10, 6, 11, 41, 12)),
    ("2019-10-06 10:11:12+8", _us(2019, 10, 6, 2, 11, 12)),
    ("2019-10-06 10:11:12GMT+01:00", _us(2019, 10, 6, 9, 11, 12)),
    ("2019-10-06 25:00:00", None), ("2019-10-06 10:61:00", None),
    ("2019-10-06 10:11:12.1234567890", None), ("2019-10-06 10:11:12 NOTAZONE", None),
    ("1", None), ("", None),
])
def test_string_to_timestamp_lenient(s, expect):
    assert _both_scalar("spark_string_to_timestamp", s) == expect


def test_string_to_timestamp_fraction_requires_seconds():
    assert _both_scalar("spark_string_to_timestamp", "2019-10-06 10:11.5") is None


def test_bare_time_uses_default_date():
    got = _both_scalar("spark_string_to_timestamp", "12:30:45", default_date=dt.date(2020, 5, 4))
    assert got == _us(2020, 5, 4, 12, 30, 45)


def test_bare_time_with_leading_t_separator():
    d = dt.date(2020, 5, 4)
    assert _both_scalar("spark_string_to_timestamp", "T12:34:56", default_date=d) == \
        _us(2020, 5, 4, 12, 34, 56)
    assert _both_scalar("spark_string_to_timestamp", "T9:05", default_date=d) == \
        _us(2020, 5, 4, 9, 5, 0)
    for s in ("T", "TZ", "T+01:00"):
        assert _both_scalar("spark_string_to_timestamp", s) is None


def test_region_zone_if_zoneinfo_available():
    got = _both_scalar("spark_string_to_timestamp", "2019-01-15 12:00:00 America/New_York")
    if got is not None:
        assert got == _us(2019, 1, 15, 17, 0, 0)


@pytest.mark.parametrize("x,expect", [
    (1.0, "1.0"), (-1.5, "-1.5"), (0.0, "0.0"), (10000000.0, "1.0E7"),
    (9999999.5, "9999999.5"), (0.001, "0.001"), (0.0001, "1.0E-4"),
    (123456.789, "123456.789"), (1e100, "1.0E100"), (-2.5e-9, "-2.5E-9"),
    (float("nan"), "NaN"), (float("inf"), "Infinity"), (float("-inf"), "-Infinity"),
    (-0.0, "-0.0"),
])
def test_java_double_str(x, expect):
    assert _both_scalar("_java_fp_str", x, single=False) == expect


def test_java_float_str_shortest_for_float32():
    assert _both_scalar("_java_fp_str", 0.1, single=True) == "0.1"
    assert _both_scalar("_java_fp_str", float(np.float32(1.0) / 3), single=True) == "0.33333334"


@pytest.mark.parametrize("unscaled,scale,expect", [
    (12345, 2, "123.45"), (-12345, 2, "-123.45"), (12345, 0, "12345"), (5, 7, "5E-7"),
    (50, 7, "0.0000050"), (123, 7, "0.0000123"), (12, 9, "1.2E-8"), (0, 2, "0.00"),
    (7, 3, "0.007"),
])
def test_java_bigdecimal_str(unscaled, scale, expect):
    assert _both_scalar("_java_bigdecimal_str", unscaled, scale) == expect


def test_timestamp_to_string_trims_fraction():
    us = _us(2019, 10, 6, 10, 11, 12)
    assert _both_scalar("_timestamp_str", us) == "2019-10-06 10:11:12"
    assert _both_scalar("_timestamp_str", us + 500000) == "2019-10-06 10:11:12.5"
    assert _both_scalar("_timestamp_str", us + 123450) == "2019-10-06 10:11:12.12345"


def test_seven_digit_year_date_and_civil_days():
    assert _both_scalar("spark_string_to_date", "123456-01-01") == \
        PC._days_from_civil(123456, 1, 1)
    assert _both_scalar("spark_string_to_timestamp", "123456-01-01 00:00:01") == (
        PC._days_from_civil(123456, 1, 1) * 86400 + 1) * 1_000_000
    for y, m, d in [(1970, 1, 1), (2000, 2, 29), (1969, 12, 31), (9999, 12, 31), (1, 1, 1)]:
        assert _both_scalar("_days_from_civil", y, m, d) == _days(y, m, d)
    days = _both_scalar("spark_string_to_date", "123456-01-02")
    assert _both_scalar("_date_str", days) == "123456-01-02"
    assert _both_scalar("_civil_from_days", PC._days_from_civil(-44, 3, 15)) == (-44, 3, 15)


def test_lowercase_t_and_zone_names_with_t():
    assert _both_scalar("spark_string_to_timestamp", "2021-01-01t10:00:00") is None
    assert _both_scalar("spark_string_to_timestamp", "2021-01-01T10:00:00") is not None
    assert _both_scalar("spark_string_to_date", "2021-01-01 10:11:12 UTC") == _days(2021, 1, 1)
    assert _both_scalar("spark_string_to_date", "2021-01-01 10:11:12 EST") == _days(2021, 1, 1)


def test_can_cast_lattice():
    for a, b in [("FLOAT64", "BINARY"), ("INT64", "BINARY"), ("STRING", "BINARY"),
                 ("STRING", "TIMESTAMP"), ("INT64", "STRING"), ("DATE32", "INT32")]:
        want = JC.can_cast(getattr(JT, a), getattr(JT, b))
        assert PC.can_cast(getattr(PT, a), getattr(PT, b)) == want
    assert not PC.can_cast(PT.FLOAT64, PT.BINARY)
    lst_i = PT.DataType(PT.TypeKind.LIST, inner=(PT.INT64,))
    lst_s = PT.DataType(PT.TypeKind.LIST, inner=(PT.STRING,))
    assert PC.can_cast(lst_i, lst_s) and PC.can_cast(lst_i, PT.STRING)
    assert not PC.can_cast(lst_i, PT.INT64) and not PC.can_cast(PT.INT64, lst_i)


def test_nested_scalar_casts_name_the_type():
    """Nested casts (ROADMAP Queue 1 item 2) run as the reference's
    ``cast_scalar``: element by element, a MAP with a NULL key NULL, a
    STRUCT field by field under the target's names."""
    lst = (PT.DataType(PT.TypeKind.LIST, inner=(PT.INT64,)),
           JT.DataType(JT.TypeKind.LIST, inner=(JT.INT64,)))
    lst_s = (PT.DataType(PT.TypeKind.LIST, inner=(PT.STRING,)),
             JT.DataType(JT.TypeKind.LIST, inner=(JT.STRING,)))
    mp = (PT.DataType(PT.TypeKind.MAP, inner=(PT.STRING, PT.INT64)),
          JT.DataType(JT.TypeKind.MAP, inner=(JT.STRING, JT.INT64)))
    mp_i = (PT.DataType(PT.TypeKind.MAP, inner=(PT.INT32, PT.STRING)),
            JT.DataType(JT.TypeKind.MAP, inner=(JT.INT32, JT.STRING)))
    st = (PT.DataType(PT.TypeKind.STRUCT, inner=(PT.INT64, PT.STRING), struct_names=("a", "b")),
          JT.DataType(JT.TypeKind.STRUCT, inner=(JT.INT64, JT.STRING), struct_names=("a", "b")))
    st2 = (PT.DataType(PT.TypeKind.STRUCT, inner=(PT.STRING, PT.INT64), struct_names=("x", "y")),
           JT.DataType(JT.TypeKind.STRUCT, inner=(JT.STRING, JT.INT64), struct_names=("x", "y")))
    for v, src, dst in (([1, None, -3], lst, lst_s), ([("1", 5), ("b", None)], mp, mp_i),
                        ([("7", 5)], mp, mp_i), ({"a": 4, "b": "12"}, st, st2),
                        ([1, 2], lst, (PT.STRING, JT.STRING)), ({"a": None, "b": "q"}, st,
                                                                 (PT.STRING, JT.STRING))):
        assert PC.cast_scalar(v, src[0], dst[0]) == JC.cast_scalar(v, src[1], dst[1])
    assert PC.cast_scalar([("b", 1)], mp[0], mp_i[0]) is None


# ---------------------------------------------------------------------------
# column casts through both evaluators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data,to,expect", [
    ({"a": pa.array([1, None, -42, 1, 7], type=pa.int64())}, "STRING",
     ["1", None, "-42", "1", "7"]),
    ({"a": pa.array([1.5, 1e8, None], type=pa.float64())}, "STRING", ["1.5", "1.0E8", None]),
    ({"a": pa.array([True, False, None])}, "STRING", ["true", "false", None]),
    ({"a": pa.array([dt.date(2021, 3, 5), dt.date(1969, 12, 31), None])}, "STRING",
     ["2021-03-05", "1969-12-31", None]),
    ({"a": pa.array([pydec.Decimal("123.45"), pydec.Decimal("-0.07"), None],
                    type=pa.decimal128(10, 2))}, "STRING", ["123.45", "-0.07", None]),
    ({"s": pa.array(["2019-10-06 10", "2019-10-06 10:11:12+08:00", "nope", None])},
     "TIMESTAMP", [_us(2019, 10, 6, 10), _us(2019, 10, 6, 2, 11, 12), None, None]),
    ({"a": pa.array([pydec.Decimal("12345678901234567890.12"), None],
                    type=pa.decimal128(25, 2))}, "STRING", ["12345678901234567890.12", None]),
    ({"a": pa.array([1, -1, None], type=pa.int32())}, "BINARY",
     [b"\x00\x00\x00\x01", b"\xff\xff\xff\xff", None]),
    ({"a": pa.array([0.0, -0.0, 0.0], type=pa.float64())}, "STRING", ["0.0", "-0.0", "0.0"]),
])
def test_column_casts(data, to, expect):
    (got,) = eval_both(data, lambda ir, T: [ir.Cast(ir.col(0), getattr(T, to))])
    assert got == expect


def test_string_to_wide_decimal_roundtrip():
    (got,) = eval_both({"s": pa.array(["12345678901234567890.12", "oops"])},
                       lambda ir, T: [ir.Cast(ir.col(0), T.decimal(25, 2))])
    assert got == [pydec.Decimal("12345678901234567890.12"), None]


def test_double_and_big_int_to_wide_decimal():
    (got,) = eval_both({"a": pa.array([2.5, 1e20, None], type=pa.float64())},
                       lambda ir, T: [ir.Cast(ir.col(0), T.decimal(38, 2))])
    assert got == [pydec.Decimal("2.50"), pydec.Decimal("1E+20").quantize(pydec.Decimal("0.01")),
                   None]
    v = 5_000_000_000_000_000_000
    (got,) = eval_both({"a": pa.array([v], type=pa.int64())},
                       lambda ir, T: [ir.Cast(ir.col(0), T.decimal(38, 0))])
    assert got == [pydec.Decimal(v)]


def test_cast_null_literal_to_string():
    (got,) = eval_both({"a": pa.array([1, 2], type=pa.int64())},
                       lambda ir, T: [ir.Cast(ir.Literal(None, T.NULL), T.STRING)])
    assert got == [None, None]


def _seeded_decimals(seed: int, n: int = 500):
    """decimal(12,4) values (unscaled int64) with ties and boundaries."""
    rng = np.random.default_rng(seed)
    u = rng.integers(-(10**12) + 1, 10**12, n)
    u[:12] = [5, -5, 15, -15, 25, -25, 10**12 - 1, -(10**12) + 1, 50000, -50000, 0, 12345]
    valid = rng.random(n) > 0.1
    valid[:12] = True
    return [pydec.Decimal(int(x)).scaleb(-4) if ok else None for x, ok in zip(u, valid)]


@pytest.mark.parametrize("to", [(10, 2), (12, 4), (14, 6), (6, 0), (8, 1), (18, 10), (4, 3),
                                (38, 6), (30, 0)])
def test_decimal_to_decimal(to):
    data = {"a": pa.array(_seeded_decimals(sum(to)), type=pa.decimal128(12, 4))}
    eval_both(data, lambda ir, T: [ir.Cast(ir.col(0), T.decimal(*to))])


@pytest.mark.parametrize("to", ["INT8", "INT16", "INT32", "INT64", "FLOAT32", "FLOAT64",
                                "BOOL", "STRING"])
def test_decimal_to_other(to):
    data = {"a": pa.array(_seeded_decimals(len(to)), type=pa.decimal128(12, 4))}
    eval_both(data, lambda ir, T: [ir.Cast(ir.col(0), getattr(T, to))])


@pytest.mark.parametrize("src", ["int8", "int16", "int32", "int64"])
@pytest.mark.parametrize("to", [(18, 2), (5, 0), (9, 3), (38, 4)])
def test_int_to_decimal_checked(src, to):
    rng = np.random.default_rng(len(src) + to[0])
    info = np.iinfo(src)
    v = rng.integers(info.min, info.max, 400, dtype=src, endpoint=True)
    v[:4] = [info.min, info.max, 0, -1]
    eval_both({"a": pa.array(v)}, lambda ir, T: [ir.Cast(ir.col(0), T.decimal(*to))])


@pytest.mark.parametrize("to", [(7, 2), (18, 2), (10, 0), (4, 3), (38, 2)])
def test_float_to_decimal_half_up(to):
    rng = np.random.default_rng(to[0])
    f = np.round(rng.gamma(2.0, 25.0, 400), 2) * rng.choice([-1, 1], 400)
    f[:10] = [0.125, -0.125, 2.5, -2.5, 0.005, -0.005, 1e30, np.nan, np.inf, 99999.995]
    eval_both({"a": pa.array(f)}, lambda ir, T: [ir.Cast(ir.col(0), T.decimal(*to))])


def test_string_to_decimal64_column():
    vals = ["1.25", " 3.14159 ", "-0.005", "1e3", "abc", None, "99999999.99", "123456789012"]
    eval_both({"s": pa.array(vals)}, lambda ir, T: [ir.Cast(ir.col(0), T.decimal(10, 2)),
                                                    ir.Cast(ir.col(0), T.decimal(4, 1))])


def test_wide_decimal_to_narrow_and_int():
    vals = [pydec.Decimal("12345678901234567890.1234"), pydec.Decimal("-7.5555"),
            pydec.Decimal("99999999.9999"), None, pydec.Decimal("0.0050")]
    data = {"a": pa.array(vals, type=pa.decimal128(38, 4))}
    eval_both(data, lambda ir, T: [ir.Cast(ir.col(0), T.decimal(18, 2)),
                                   ir.Cast(ir.col(0), T.INT64), ir.Cast(ir.col(0), T.FLOAT64),
                                   ir.Cast(ir.col(0), T.decimal(30, 2))])


@pytest.mark.parametrize("op", ["gt", "eq", "lteq"])
def test_integer_against_decimal64_compares_values(op):
    """An integer operand of a decimal64 comparison or arithmetic enters at
    scale 0: INT32 gives the reference's answer; INT64 (where the
    reference compares a decimal(20,0) dictionary's codes, ROADMAP Queue
    3) gives the value Spark compares, held against Python decimals."""
    ints = [3, 5, 4, -4, 0, 2**40]
    ref = pydec.Decimal("4.00")
    cmp = {"gt": lambda a, b: a > b, "eq": lambda a, b: a == b, "lteq": lambda a, b: a <= b}[op]
    (got32, sum32) = eval_both({"a": pa.array(ints[:5], type=pa.int32())}, lambda ir, T: [
        ir.BinaryOp(op, ir.col(0), ir.Literal(ref, T.decimal(5, 2))),
        ir.BinaryOp("add", ir.col(0), ir.Literal(ref, T.decimal(5, 2)))])
    assert got32 == [cmp(pydec.Decimal(x), ref) for x in ints[:5]]
    pb = carry(JBatch.from_pydict({"a": pa.array(ints, type=pa.int64())}))
    outs = PEval(pb.schema).evaluate(pb, [
        pir.BinaryOp(op, pir.col(0), pir.Literal(ref, PT.decimal(5, 2))),
        pir.BinaryOp("mul", pir.col(0), pir.Literal(ref, PT.decimal(5, 2)))])
    n = len(ints)
    assert outs[0].values[:n].tolist() == [cmp(pydec.Decimal(x), ref) for x in ints]
    prod = outs[1]
    assert repr(prod.dtype) == "decimal(18,2)"
    assert [PT.decimal_from_unscaled(v, 2) if m else None
            for v, m in zip(prod.values[:n].tolist(), prod.validity[:n].tolist())] == \
        [x * ref if abs(x * ref) < 10**16 else None for x in ints]
    assert sum32 == [PT.unscaled_int(pydec.Decimal(x) + ref, 2) for x in ints[:5]]
