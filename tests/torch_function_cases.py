"""The scalar-function cases of the port's parity tests, without JAX or
pyarrow (tests/test_torch_functions.py holds them against the reference
on the CPU, tests/test_torch_cuda.py runs them on the card): a seeded host
frame with NULLs, empty strings, negative dates and timestamps, NaN,
+-inf and +-0.0, and per ported function name the argument tuples to call
it with."""

from __future__ import annotations

import numpy as np

N = 300

STRINGS = ["", "a", "abc", "a,b", "b,a,c", "  pad  ", "Hello World", "über,straße", "天地,😁",
           "aab", "x_y-z", "ab,ab", "ABC def", "a1b2", " lead", "trail "]
JSONS = ['{"a": 1, "b": [10, 20], "c": {"d": "x"}}', '{"a": "s", "b": []}', "not json",
         '{"c": {"d": null}}', "[1, 2]", '{"a": null}', '{"b": [1, {"e": 2}]}', ""]
NUMS = ["ff", "-12", "zz", "7fffffffffffffff", "10", "", "0", "-0", "1z", "FFFFFFFFFFFFFFFFFF",
        "abc"]
LISTS_S = [[], ["a"], ["a", "b"], ["b", "a"], ["a", None, "c"], ["c", "c", "a"], ["x", "y"],
           ["", "a"]]  # several of equal length on purpose
LISTS_I = [[], [3], [1, 2], [2, 1], [3, None, 1], [5, 5, 2], [7, 8], [-1, 0]]
LISTS_LL = [[], [[1, 2], [3]], [[], [4]], [[5], None], [[6, 7], [8, 9]]]

#: column name -> kind: i32 i64 f64 f32 str date ts dec list_s list_i list_ll bool
KINDS = {"i32": "i32", "i64": "i64", "f64": "f64", "f32": "f32", "s": "str", "d": "date",
         "ts": "ts", "dec": "dec", "ls": "list_s", "li": "list_i", "js": "str", "num": "str",
         "i32b": "i32", "f64b": "f64", "d2": "date", "s2": "str", "small": "i32",
         "li2": "list_i", "ll": "list_ll", "b": "bool", "i64s": "i64"}
COL = {n: i for i, n in enumerate(KINDS)}


def host_frame(seed: int = 7) -> dict:
    """name -> (values, validity): numpy arrays, or lists for strings and
    lists; a decimal(10,2) as int64 unscaled cents."""
    rng = np.random.default_rng(seed)

    def nulls(p):
        return ~(rng.random(N) < p)

    f64 = rng.normal(0, 50, N)
    f64[rng.integers(0, N, 20)] = np.nan
    for v in (0.0, -0.0, np.inf, -np.inf, 0.5, -0.5, 2.5, -2.5, 1e300, -1e300, 27.0, -8.0):
        f64[rng.integers(0, N)] = v
    f64b = rng.normal(0, 2, N)
    f64b[rng.integers(0, N, 10)] = np.nan
    f64b[rng.integers(0, N, 10)] = 0.0
    i32 = rng.integers(-1000, 1000, N).astype(np.int32)
    i32[rng.integers(0, N, 15)] = 0
    i32[:3] = (np.iinfo(np.int32).min, np.iinfo(np.int32).max, -5)
    i64 = rng.integers(-(2**62), 2**62, N, dtype=np.int64)
    i64[:4] = (np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1)
    small = rng.integers(-40, 40, N).astype(np.int32)
    days = rng.integers(-150_000, 60_000, N).astype(np.int32)
    days2 = rng.integers(-5000, 5000, N).astype(np.int32)
    us = rng.integers(-(10**16), 10**16, N, dtype=np.int64)
    cents = rng.integers(-10**9, 10**9, N).astype(np.int64)
    pick = lambda pool: [pool[int(i)] for i in rng.integers(0, len(pool), N)]  # noqa: E731
    with np.errstate(over="ignore"):
        f32 = f64.astype(np.float32)
    return {
        "i32": (i32, nulls(0.1)), "i64": (i64, nulls(0.1)), "f64": (f64, nulls(0.08)),
        "f32": (f32, nulls(0.08)), "s": (pick(STRINGS), nulls(0.1)), "d": (days, nulls(0.1)),
        "ts": (us, nulls(0.1)), "dec": (cents, nulls(0.1)), "ls": (pick(LISTS_S), nulls(0.1)),
        "li": (pick(LISTS_I), nulls(0.1)), "js": (pick(JSONS), nulls(0.1)),
        "num": (pick(NUMS), nulls(0.1)),
        "i32b": (rng.integers(-1000, 1000, N).astype(np.int32), nulls(0.1)),
        "f64b": (f64b, nulls(0.1)), "d2": (days2, nulls(0.1)), "s2": (pick(STRINGS), nulls(0.1)),
        "small": (small, nulls(0.1)), "li2": (pick(LISTS_I), nulls(0.1)),
        "ll": (pick(LISTS_LL), nulls(0.1)), "b": (rng.random(N) < 0.5, nulls(0.1)),
        "i64s": (rng.integers(-(10**11), 10**11, N).astype(np.int64), nulls(0.1)),
    }


def port_dtype(kind: str, T):
    """The port's (or the reference's: same names) DataType of a kind."""
    lst = lambda t: T.DataType(T.TypeKind.LIST, inner=(t,))  # noqa: E731
    return {"i32": T.INT32, "i64": T.INT64, "f64": T.FLOAT64, "f32": T.FLOAT32, "str": T.STRING,
            "date": T.DATE32, "ts": T.TIMESTAMP, "dec": T.decimal(10, 2),
            "list_s": lst(T.STRING), "list_i": lst(T.INT32), "list_ll": lst(lst(T.INT32)),
            "bool": T.BOOL}[kind]


def port_batch(frame: dict, device: str):
    """The frame as one auron_tpu_torch batch (NULL rows hold a zero, an
    empty string or an empty list)."""
    from auron_tpu_torch import types as PT
    from auron_tpu_torch.columnar.batch import Batch

    schema = PT.Schema(tuple(PT.Field(n, port_dtype(KINDS[n], PT)) for n in KINDS))
    cols, valid = [], []
    for n in KINDS:
        v, m = frame[n]
        if isinstance(v, list) and KINDS[n] == "str":
            v = np.array([x if ok else "" for x, ok in zip(v, m)], dtype=object)
        elif isinstance(v, list):
            v = [x if ok else None for x, ok in zip(v, m)]
        cols.append(v)
        valid.append(m)
    return Batch.from_numpy(cols, schema, valid, device=device)


def cases(ir, T, bloom: bytes) -> dict:
    """name -> list of argument tuples (expressions of module ``ir``)."""
    c = {n: ir.col(i, n) for n, i in COL.items()}

    def lit(v, t=None):
        return ir.Literal(v, t) if t is not None else ir.lit(v)

    fl = [(c["f64"],), (c["f32"],), (c["i32"],)]
    out = {n: fl for n in ("sqrt", "exp", "ln", "log10", "log2", "sin", "cos", "tan", "asin",
                            "acos", "atan", "sinh", "cosh", "tanh", "cbrt", "degrees", "radians",
                            "signum", "floor_f", "ceil_f")}
    out.update({
        "abs": [(c["i32"],), (c["i64"],), (c["f64"],), (c["dec"],)],
        "negative": [(c["i32"],), (c["i64"],), (c["f64"],), (c["dec"],)],
        "ceil": [(c["f64"],), (c["dec"],), (c["i32"],), (c["f32"],)],
        "floor": [(c["f64"],), (c["dec"],), (c["i32"],), (c["f32"],)],
        "pow": [(c["f64"], c["f64b"]), (c["i32"], c["f64b"])],
        "atan2": [(c["f64"], c["f64b"]), (c["i32"], c["f64"])],
        "round": [(c["f64"],), (c["f64"], lit(2)), (c["f64"], lit(-1)), (c["f32"], lit(1)),
                  (c["dec"], lit(1)), (c["dec"], lit(-1)), (c["i64s"], lit(-2)),
                  (c["i32"], lit(-1)), (c["i32"], lit(2))],
        "bround": [(c["f64"],), (c["f64"], lit(1)), (c["dec"], lit(1)), (c["dec"], lit(-1)),
                   (c["dec"], lit(3)), (c["i32"],)],
        "isnan": [(c["f64"],), (c["i32"],)],
        "nanvl": [(c["f64"], c["f64b"])],
        "null_if_zero": [(c["i32"],), (c["f64"],)],
        "normalize_nan_and_zero": [(c["f64"],), (c["f32"],)],
        "date_add": [(c["d"], lit(30)), (c["d"], c["small"])],
        "date_sub": [(c["d"], lit(30)), (c["d"], c["small"])],
        "datediff": [(c["d"], c["d2"]), (c["ts"], c["d"])],
        "months_between": [(c["d"], c["d2"]), (c["ts"], c["d"])],
        "add_months": [(c["d"], lit(1)), (c["d"], c["small"]), (c["d"], lit(-13))],
        "trunc_date": [(c["d"], lit(f)) for f in ("year", "quarter", "month", "week", "day")],
        "next_day": [(c["d"], lit("TU")), (c["d"], lit("sunday")), (c["d"], lit("xx"))],
        "unscaled_value": [(c["dec"],)],
        "make_decimal": [(c["i64s"], lit(10), lit(2)), (c["i64s"], lit(18), lit(4))],
        "check_overflow": [(c["dec"],)],
        "unix_timestamp": [(c["ts"],)],
        "from_unixtime_ts": [(c["i64s"],)],
        "least": [(c["i32"], c["i32b"]), (c["f64"], c["f64b"]), (c["s"], c["s2"]),
                  (c["i32"], lit(5), c["i32b"])],
        "greatest": [(c["i32"], c["i32b"]), (c["f64"], c["f64b"]), (c["s"], c["s2"]),
                     (c["i32"], lit(5), c["i32b"])],
        "date_format": [(c["d"], lit("yyyy-MM-dd")), (c["ts"], lit("yyyy/MM/dd HH:mm:ss"))],
        "substring": [(c["s"], lit(2)), (c["s"], lit(-3), lit(2)), (c["s"], lit(0), lit(1))],
        "starts_with": [(c["s"], lit("a"))],
        "ends_with": [(c["s"], lit("c"))],
        "contains": [(c["s"], lit("b"))],
        "repeat": [(c["s"], lit(2)), (c["s"], lit(-1))],
        "lpad": [(c["s"], lit(5)), (c["s"], lit(6), lit("xy"))],
        "rpad": [(c["s"], lit(5)), (c["s"], lit(6), lit("xy"))],
        "instr": [(c["s"], lit("b"))],
        "replace": [(c["s"], lit("a"), lit("XY"))],
        "translate": [(c["s"], lit("abc"), lit("x"))],
        "get_json_object": [(c["js"], lit("$.a")), (c["js"], lit("$.b[1]")),
                            (c["js"], lit("$.c.d")), (c["js"], lit("$.b[1].e"))],
        "get_parsed_json_object": [(c["js"], lit("$.a")), (c["js"], lit("$.c"))],
        "rlike": [(c["s"], lit("^a.*")), (c["s"], lit("[0-9]"))],
        "regexp_extract": [(c["s"], lit("(a)(b)?"), lit(1)), (c["s"], lit("([a-z]+)"), lit(0)),
                           (c["s"], lit("(x)"), lit(2)), (c["s"], lit("(a)(b)?"), lit(2))],
        "regexp_replace": [(c["s"], lit("a(b?)"), lit("<$1>")), (c["s"], lit(","), lit("\\$"))],
        "conv": [(c["num"], lit(16), lit(10)), (c["num"], lit(10), lit(-2)),
                 (c["num"], lit(36), lit(16)), (c["num"], lit(10), lit(1))],
        "hex": [(c["s"],), (c["i64"],), (c["i32"],)],
        "unhex": [(c["num"],)],
        "base64": [(c["s"],)],
        "unbase64": [(c["s"],), (c["num"],)],
        "split": [(c["s"], lit(",")), (c["s"], lit("a")), (c["s"], lit(","), lit(2))],
        "array_reverse": [(c["ls"],), (c["li"],)],
        "array_flatten": [(c["ll"],)],
        "array_union": [(c["li"], c["li2"])],
        "concat": [(c["s"], c["s2"]), (c["s"], lit("-"), c["s2"])],
        "concat_ws": [(lit(","), c["s"], c["s2"]), (lit("|"), c["s"])],
        "string_space": [(c["small"],)],
        "make_array": [(c["i32"], c["i32b"]), (c["s"], c["s2"]), (c["d"],), ()],
        "null_if": [(c["i32"], c["i32b"]), (c["s"], c["s2"])],
        "element_at": [(c["ls"], lit(1)), (c["li"], lit(-1)), (c["ls"], lit(3)),
                       (c["li"], lit(0))],
        "array_size": [(c["ls"],), (c["li"],)],
        "array_contains": [(c["ls"], lit("a")), (c["li"], lit(3))],
        "array_join": [(c["ls"], lit("-")), (c["li"], lit(","))],
        "array_distinct": [(c["ls"],), (c["li"],)],
        "sort_array": [(c["ls"],), (c["li"], lit(False)), (c["li"], lit(True))],
        "array_min": [(c["ls"],), (c["li"],)],
        "array_max": [(c["ls"],), (c["li"],)],
        "bloom_filter_might_contain": [(lit(bloom, T.BINARY), c["i64s"]),
                                       (lit(bloom, T.BINARY), c["i32"])],
    })
    for name in ("year", "month", "day", "quarter", "dayofweek", "dayofyear", "last_day",
                 "weekofyear"):
        out[name] = [(c["d"],), (c["ts"],)]
    for name in ("hour", "minute", "second"):
        out[name] = [(c["ts"],)]
    for name in ("upper", "lower", "trim", "ltrim", "rtrim", "reverse", "length", "octet_length",
                 "ascii", "initcap", "md5", "sha224", "sha256", "sha384", "sha512"):
        out[name] = [(c["s"],)]
    out["parse_json"] = [(c["js"],)]
    hashed = [(c[n],) for n in ("i32", "i64", "f64", "f32", "s", "d", "ts", "dec", "b")]
    hashed.append((c["i32"], c["s"], c["f64"], c["dec"]))
    for name in ("hash", "murmur3_hash", "xxhash64"):
        out[name] = hashed
    return out


def bloom_values() -> np.ndarray:
    """The int64 values the parity tests' bloom filters hold."""
    return np.arange(-(2**40), 2**40, 2**33, dtype=np.int64)[:200]


def entries(d) -> list:
    return d.to_pylist() if hasattr(d, "to_pylist") else list(d)


def host_result(cv):
    """(values, validity, vocabulary entries or None) of either package's
    ColumnVal on the host."""
    import torch

    vals = (cv.values.cpu().numpy() if isinstance(cv.values, torch.Tensor)
            else np.asarray(cv.values))
    mask = (cv.validity.cpu().numpy() if isinstance(cv.validity, torch.Tensor)
            else np.asarray(cv.validity))
    mask = np.broadcast_to(mask, vals.shape)
    ents = entries(cv.dict) if cv.dtype.is_dict_encoded else None
    return vals, mask.astype(bool), ents


def decoded(vals, mask, ents) -> list:
    return [ents[min(max(int(x), 0), len(ents) - 1)] for x in vals[mask]]



# ---------------------------------------------------------------------------
# the MAP and STRUCT functions: a nested frame and its cases
# (tests/test_torch_nested.py holds them against the reference on the CPU,
# tests/test_torch_cuda.py runs them on the card)
# ---------------------------------------------------------------------------

#: the reference's MAP and STRUCT functions (with ``element_at`` over a MAP
#: they have the cases of ``NESTED_CASES``)
NESTED_FUNCTIONS = ("get_map_value", "map_concat", "map_from_arrays", "map_from_entries",
                    "map_keys", "map_values", "str_to_map", "named_struct", "get_struct_field")

MAPS = [[("a", 1), ("b", None)], [], None, [("a", 5)], [("x", 2), ("y", 3), ("z", 4)],
        [("b", 7), ("a", 8)]]
STRUCTS = [{"x": 1, "s": "p", "l": [1, 2]}, None, {"x": None, "s": None, "l": None},
           {"x": 5, "s": "", "l": []}, {"x": -2, "s": "q,r", "l": [None, 3]}]


def nested_columns(T) -> dict:
    """name -> (type of module ``T``, the pool its rows are drawn from)."""
    lst = lambda t: T.DataType(T.TypeKind.LIST, inner=(t,))  # noqa: E731
    m = T.DataType(T.TypeKind.MAP, inner=(T.STRING, T.INT64))
    st = T.DataType(T.TypeKind.STRUCT, inner=(T.INT64, T.STRING, lst(T.INT32)),
                    struct_names=("x", "s", "l"))
    entry = T.DataType(T.TypeKind.STRUCT, inner=(T.STRING, T.INT64),
                       struct_names=("key", "value"))
    nested = [{"m": mp, "ls": None if mp is None else [STRUCTS[0], None]} for mp in MAPS]
    return {
        "m": (m, MAPS), "m2": (m, MAPS), "st": (st, STRUCTS),
        "nst": (T.DataType(T.TypeKind.STRUCT, inner=(m, lst(st)), struct_names=("m", "ls")),
                nested + [None]),
        "lm": (lst(m), [[x for x in MAPS if x is not None][:i] for i in range(4)] + [None]),
        "i": (T.INT64, [1, -3, None, 40, 0]),
        "s": (T.STRING, ["a:1,b:2", "k", "", None, "x:1:2,y", "a=1;b=2"]),
        "ks": (lst(T.STRING), [["a", "b"], [], ["x"], None, ["c", "c"]]),
        "vs": (lst(T.INT64), [[1, 2], [3], [], [None, 5], None]),
        "ksn": (lst(T.STRING), [["a", None], ["b"]]),
        "ent": (lst(entry), [[{"key": "a", "value": 1}, {"key": "b", "value": None}], [], None,
                             [{"key": "a", "value": 3}, {"key": "a", "value": 4}]]),
        "entn": (lst(entry), [[{"key": "a", "value": 1}, None]]),
        "entk": (lst(entry), [[{"key": None, "value": 1}]]),
    }


def nested_rows(T, n: int = 40) -> dict:
    """name -> (type, n rows drawn from its pool, seeded by its position)."""
    out = {}
    for seed, (name, (dt, pool)) in enumerate(nested_columns(T).items(), 1):
        rng = np.random.default_rng(seed)
        out[name] = (dt, [pool[int(i)] for i in rng.integers(0, len(pool), n)])
    return out


def nested_port_batch(device: str, n: int = 40):
    """The nested frame as one auron_tpu_torch batch."""
    from auron_tpu_torch import types as PT
    from auron_tpu_torch.columnar.batch import Batch

    rows = nested_rows(PT, n)
    schema = PT.Schema(tuple(PT.Field(name, dt) for name, (dt, _) in rows.items()))
    cols, valid = [], []
    for dt, vals in rows.values():
        ok = np.array([v is not None for v in vals])
        if dt.is_dict_encoded:
            cols.append(vals if dt.is_nested else np.array([v or "" for v in vals], object))
        else:
            cols.append(np.array([v if v is not None else 0 for v in vals], dt.numpy_dtype()))
        valid.append(ok)
    return Batch.from_numpy(cols, schema, valid, device=device)


#: case -> (function, arguments: frame columns by name, string literals as
#: "'<text>", int literals)
NESTED_CASES = {
    "get_map_value": ("get_map_value", "m", "'a"),
    "get_map_value_missing": ("get_map_value", "m", "'zz"),
    "map_keys": ("map_keys", "m"),
    "map_values": ("map_values", "m"),
    "map_concat": ("map_concat", "m", "m2"),
    "map_from_arrays": ("map_from_arrays", "ks", "vs"),
    "map_from_arrays_null_key": ("map_from_arrays", "ksn", "vs"),
    "map_from_entries": ("map_from_entries", "ent"),
    "map_from_entries_null_entry": ("map_from_entries", "entn"),
    "map_from_entries_null_key": ("map_from_entries", "entk"),
    "str_to_map": ("str_to_map", "s"),
    "str_to_map_delimiters": ("str_to_map", "s", "';", "'="),
    "named_struct": ("named_struct", "'a", "i", "'b", "s"),
    "named_struct_nested": ("named_struct", "'m", "m", "'st", "st", "'l", "ks"),
    "get_struct_field": ("get_struct_field", "st", "'x"),
    "get_struct_field_string": ("get_struct_field", "st", "'s"),
    "get_struct_field_list": ("get_struct_field", "st", "'l"),
    "get_struct_field_map": ("get_struct_field", "nst", "'m"),
    "element_at_map": ("element_at", "m", "'b"),
    "element_at_list_of_maps": ("element_at", "lm", 1),
}
#: the cases where the reference raises (Arrow refuses a NULL map key; Spark
#: a NULL map entry)
NESTED_RAISES = {"map_from_arrays_null_key", "map_from_entries_null_entry",
                 "map_from_entries_null_key"}


#: the nested frame's columns, in ``nested_columns`` order
NESTED_NAMES = ("m", "m2", "st", "nst", "lm", "i", "s", "ks", "vs", "ksn", "ent", "entn", "entk")


def nested_expr(ir, case: str):
    """The case's ``ScalarFunc`` (expressions of module ``ir``) over the
    nested frame's columns."""
    fn, *args = NESTED_CASES[case]
    index = {name: i for i, name in enumerate(NESTED_NAMES)}

    def arg(a):
        if isinstance(a, int):
            return ir.lit(a)
        return ir.col(index[a]) if a in index else ir.lit(a[1:])

    return ir.ScalarFunc(fn, tuple(arg(a) for a in args))
