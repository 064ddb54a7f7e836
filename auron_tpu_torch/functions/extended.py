"""Extended scalar functions (reference checklist:
datafusion-ext-functions/src/lib.rs).

Port of ``auron_tpu/functions/extended.py``. Three execution styles:
- device kernels (timestamps, decimal plumbing, bround, least/greatest,
  the hashes);
- dictionary transforms (value-dependent string, LIST, MAP and STRUCT
  functions: O(|vocab|) host work, device gathers);
- host row-wise evaluation (row-dependent builders like concat/make_array,
  ``_host_rowwise``): the argument columns come to the host in one batched
  read, the Python function runs per row, and the port's own encoder
  (``columnar.batch.column_from_pylist``) puts the result back on the
  device; no Arrow. A MAP result is checked as Arrow's conversion checks
  it in the reference (a NULL key raises ``ValueError``); a duplicate key
  stays, as there.
"""

from __future__ import annotations

import base64 as _b64
import hashlib
import json
import re as _re

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import (
    _physical_of, column_from_pylist, empty_entry, host_pylists, object_array,
)
from auron_tpu_torch.exprs import decimal_math as D
from auron_tpu_torch.functions.registry import (
    _cv, _dict_transform, _scalar_arg, civil_from_days, date_arg, days_from_civil, dict_apply,
    fdiv, gather_table, last_dom_days, registry, true_div,
)
from auron_tpu_torch.ops.uwords import lt_u64

# ---------------------------------------------------------------------------
# host row-wise evaluation
# ---------------------------------------------------------------------------


def _host_rowwise(name: str, py_fn, out_dtype_fn):
    """Register fn(*row) evaluated on the host per row."""

    @registry.register(name, out_dtype_fn)
    def _f(args, cap, device, py_fn=py_fn):
        host_cols = host_pylists(args)  # one batched read for every argument
        out_rows = [py_fn(*row) for row in zip(*host_cols)] if host_cols else []
        out_dt = (out_dtype_fn([a.dtype for a in args]) if callable(out_dtype_fn)
                  else out_dtype_fn)
        v, m, d = column_from_pylist(out_rows, out_dt, cap, device)
        return _cv(v, m, out_dt, d)

    return _f


# ---------------------------------------------------------------------------
# rounding / decimal plumbing
# ---------------------------------------------------------------------------


@registry.register("bround")
def _bround(args, cap, device):
    """HALF_EVEN (banker's) rounding: Spark's bround."""
    a = args[0]
    scale = int(_scalar_arg(args[1])) if len(args) > 1 else 0
    if a.dtype.is_float:
        m = 10.0**scale
        r = true_div(torch.round(a.values.to(torch.float64) * m), m)  # HALF_EVEN
        return _cv(r.to(a.values.dtype), a.validity, a.dtype)
    if a.dtype.kind == T.TypeKind.DECIMAL:
        k = a.dtype.scale - scale
        if k <= 0:
            return a
        p = D.pow10(min(k, 18))
        q = D.tdiv(a.values, p)
        r = torch.fmod(a.values, p)
        half = p // 2
        odd = torch.remainder(q, 2) != 0
        up = (torch.abs(r) > half) | ((torch.abs(r) == half) & odd)
        v = q + torch.where(up, torch.sign(r), torch.zeros_like(r))
        if scale < 0:
            # negative target scale: the result is at scale 0, the rounded
            # magnitude re-expanded (bround(123.45, -1) = 120)
            v = v * D.pow10(min(-scale, 18))
        return _cv(v, a.validity, T.decimal(a.dtype.precision, max(scale, 0)))
    return a


@registry.register("unscaled_value", T.INT64)
def _unscaled_value(args, cap, device):
    a = args[0]
    assert a.dtype.kind == T.TypeKind.DECIMAL
    return _cv(a.values.to(torch.int64), a.validity, T.INT64)


@registry.register("make_decimal")
def _make_decimal(args, cap, device):
    """long unscaled -> decimal(p,s); the out type from literal args."""
    a = args[0]
    p = int(_scalar_arg(args[1])) if len(args) > 1 else 38
    s = int(_scalar_arg(args[2])) if len(args) > 2 else 18
    out = T.decimal(min(p, 38), s)
    v = a.values.to(torch.int64)
    return _cv(v, a.validity & D.precision_ok(v, out.precision), out)


@registry.register("check_overflow")
def _check_overflow(args, cap, device):
    a = args[0]
    assert a.dtype.kind == T.TypeKind.DECIMAL
    return _cv(a.values, a.validity & D.precision_ok(a.values, a.dtype.precision), a.dtype)


# ---------------------------------------------------------------------------
# timestamps
# ---------------------------------------------------------------------------

_US_PER_DAY = 86_400_000_000


def _ts_field(name, divisor, modulo):
    @registry.register(name, T.INT32)
    def _f(args, cap, device):
        a = args[0]
        us_in_day = torch.remainder(a.values, _US_PER_DAY)
        v = torch.remainder(fdiv(us_in_day, divisor), modulo)
        return _cv(v.to(torch.int32), a.validity, T.INT32)

    return _f


_ts_field("hour", 3_600_000_000, 24)
_ts_field("minute", 60_000_000, 60)
_ts_field("second", 1_000_000, 60)


@registry.register("weekofyear", T.INT32)
def _weekofyear(args, cap, device):
    """ISO-8601 week number (Spark weekofyear)."""
    d = date_arg(args[0]).to(torch.int64)
    # ISO week: the week of the year holding the Thursday of d's week
    dow = torch.remainder(d + 3, 7)  # 0 = Monday
    thursday = d - dow + 3
    y, _, _ = civil_from_days(thursday)
    jan1 = days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
    week = fdiv(thursday - jan1, 7) + 1
    return _cv(week.to(torch.int32), args[0].validity, T.INT32)


@registry.register("months_between", T.FLOAT64)
def _months_between(args, cap, device):
    y1, m1, day1 = civil_from_days(date_arg(args[0]))
    y2, m2, day2 = civil_from_days(date_arg(args[1]))

    def last_dom(y, m):
        return last_dom_days(y, m) - days_from_civil(y, m, torch.ones_like(m)) + 1

    both_last = (day1 == last_dom(y1, m1)) & (day2 == last_dom(y2, m2))
    months = ((y1 - y2) * 12 + (m1 - m2)).to(torch.float64)
    frac = true_div((day1 - day2).to(torch.float64), 31.0)
    v = torch.where(both_last | (day1 == day2), months, months + frac)
    v = true_div(torch.round(v * 1e8), 1e8)
    return _cv(v, args[0].validity & args[1].validity, T.FLOAT64)


@registry.register("unix_timestamp", T.INT64)
def _unix_timestamp(args, cap, device):
    a = args[0]
    assert a.dtype.kind == T.TypeKind.TIMESTAMP
    return _cv(fdiv(a.values, 1_000_000), a.validity, T.INT64)


@registry.register("from_unixtime_ts", T.TIMESTAMP)
def _from_unixtime_ts(args, cap, device):
    a = args[0]
    return _cv(a.values.to(torch.int64) * 1_000_000, a.validity, T.TIMESTAMP)


@registry.register("add_months", T.DATE32)
def _add_months(args, cap, device):
    n = args[1].values.to(torch.int64)
    y, m, day = civil_from_days(date_arg(args[0]))
    m0 = m - 1 + n
    y2 = y + fdiv(m0, 12)
    m2 = torch.remainder(m0, 12) + 1
    first = days_from_civil(y2, m2, torch.ones_like(m2))
    out = torch.minimum(first + (day - 1), last_dom_days(y2, m2))
    return _cv(out.to(torch.int32), args[0].validity & args[1].validity, T.DATE32)


@registry.register("trunc_date", T.DATE32)
def _trunc_date(args, cap, device):
    fmt = str(_scalar_arg(args[1])).lower()
    d = args[0].values.to(torch.int64)
    y, m, day = civil_from_days(d)
    if fmt in ("year", "yyyy", "yy"):
        out = days_from_civil(y, torch.ones_like(m), torch.ones_like(day))
    elif fmt == "quarter":
        out = days_from_civil(y, fdiv(m - 1, 3) * 3 + 1, torch.ones_like(day))
    elif fmt in ("month", "mon", "mm"):
        out = days_from_civil(y, m, torch.ones_like(day))
    elif fmt == "week":
        out = d - torch.remainder(d + 3, 7)  # back to Monday
    else:
        out = d
    return _cv(out.to(torch.int32), args[0].validity, T.DATE32)


_DAYNAMES = {"MO": 0, "TU": 1, "WE": 2, "TH": 3, "FR": 4, "SA": 5, "SU": 6}


@registry.register("next_day", T.DATE32)
def _next_day(args, cap, device):
    d = args[0].values.to(torch.int64)
    target = _DAYNAMES.get(str(_scalar_arg(args[1]))[:2].upper())
    if target is None:
        return _cv(torch.zeros(cap, dtype=torch.int32, device=device),
                   torch.zeros(cap, dtype=torch.bool, device=device), T.DATE32)
    dow = torch.remainder(d + 3, 7)  # 0 = Monday
    delta = torch.remainder(target - dow + 7, 7)
    delta = torch.where(delta == 0, torch.full_like(delta, 7), delta)
    return _cv((d + delta).to(torch.int32), args[0].validity, T.DATE32)


def _minmax_skip_nulls(args, is_least):
    """Spark least/greatest: NULLs skipped; the SQL total order (NaN above
    every number; strings by byte order, so dictionary codes compare by the
    unified vocabulary's rank, not by code)."""
    from auron_tpu_torch.exprs.eval import Evaluator
    from auron_tpu_torch.ops.sortkeys import orderable_word

    args = Evaluator(T.Schema(()))._unify_vals(args)  # common type; one vocabulary
    keys = [orderable_word(a) for a in args]
    out_v, out_k, out_m = args[0].values, keys[0], args[0].validity
    for cv, k in zip(args[1:], keys[1:]):
        better = lt_u64(k, out_k) if is_least else lt_u64(out_k, k)
        take_new = cv.validity & (~out_m | better)
        out_v = torch.where(take_new, cv.values, out_v)
        out_k = torch.where(take_new, k, out_k)
        out_m = out_m | cv.validity
    return _cv(out_v, out_m, args[0].dtype, args[0].dict)


@registry.register("least", lambda dts: dts[0])
def _least(args, cap, device):
    return _minmax_skip_nulls(args, True)


@registry.register("greatest", lambda dts: dts[0])
def _greatest(args, cap, device):
    return _minmax_skip_nulls(args, False)


def _java_fmt_to_strftime(fmt: str) -> str:
    out = fmt
    for a, b in (("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"), ("HH", "%H"),
                 ("mm", "%M"), ("ss", "%S")):
        out = out.replace(a, b)
    return out


_host_rowwise(
    "date_format",
    lambda d, fmt: d.strftime(_java_fmt_to_strftime(fmt)) if d is not None else None,
    T.STRING,
)


# ---------------------------------------------------------------------------
# strings: dictionary transforms
# ---------------------------------------------------------------------------


def _initcap(s: str) -> str:
    out = []
    cap_next = True
    for ch in s:
        if ch.isalnum():
            out.append(ch.upper() if cap_next else ch.lower())
            cap_next = False
        else:
            out.append(ch)
            cap_next = True
    return "".join(out)


_dict_transform("initcap", _initcap)
_dict_transform("md5", lambda s: hashlib.md5(s.encode()).hexdigest())
_dict_transform("sha224", lambda s: hashlib.sha224(s.encode()).hexdigest())
_dict_transform("sha256", lambda s: hashlib.sha256(s.encode()).hexdigest())
_dict_transform("sha384", lambda s: hashlib.sha384(s.encode()).hexdigest())
_dict_transform("sha512", lambda s: hashlib.sha512(s.encode()).hexdigest())
_dict_transform("replace", lambda s, find, rep: s.replace(find, rep))
_dict_transform(
    "translate",
    # chars of `frm` past `to`'s length are deleted (Spark semantics)
    lambda s, frm, to: s.translate(str.maketrans(frm[: len(to)], to[: len(frm)], frm[len(to):])),
)


def _json_path_get(s: str, path: str):
    """Spark get_json_object JSONPath subset: $.a.b[0].c"""
    try:
        obj = json.loads(s)
    except (ValueError, TypeError):
        return None
    if not path.startswith("$"):
        return None
    for name, idx in _re.findall(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]", path):
        if name:
            if not isinstance(obj, dict) or name not in obj:
                return None
            obj = obj[name]
        else:
            i = int(idx)
            if not isinstance(obj, list) or i >= len(obj):
                return None
            obj = obj[i]
        if obj is None:
            return None
    if isinstance(obj, str):
        return obj
    return json.dumps(obj)


_dict_transform("get_json_object", _json_path_get)

_LIST_OF_STRING = T.DataType(T.TypeKind.LIST, inner=(T.STRING,))


def _split(s: str, pattern: str, limit: int = -1) -> list[str]:
    return _re.split(pattern, s, maxsplit=0 if limit <= 0 else limit - 1)


@registry.register("split", lambda a: _LIST_OF_STRING)
def _split_fn(args, cap, device):
    """split(str, regex[, limit]) -> LIST<STRING>: each vocabulary entry split
    once; the list vocabulary parallels the string one, so the codes stay."""
    a = args[0]
    pattern = _scalar_arg(args[1])
    limit = int(_scalar_arg(args[2])) if len(args) > 2 else -1
    d = object_array([_split(s, pattern, limit) if s is not None else [] for s in a.dict])
    return _cv(a.values.clamp(0, len(d) - 1), a.validity, _LIST_OF_STRING, d)


@registry.register("array_reverse")
def _array_reverse(args, cap, device):
    a = args[0]
    assert a.dtype.kind == T.TypeKind.LIST
    d = object_array([list(reversed(e)) if e is not None else [] for e in a.dict])
    return _cv(a.values, a.validity, a.dtype, d)


@registry.register("array_flatten")
def _array_flatten(args, cap, device):
    a = args[0]
    assert a.dtype.kind == T.TypeKind.LIST and a.dtype.inner[0].kind == T.TypeKind.LIST
    d = object_array([[x for sub in e for x in (sub or [])] if e is not None else []
                      for e in a.dict])
    return _cv(a.values, a.validity, a.dtype.inner[0], d)


# brickhouse array_union analog: per-row union of two LIST columns
_host_rowwise(
    "array_union",
    lambda a, b: sorted({*(a or []), *(b or [])}, key=lambda x: (x is None, x)),
    lambda dts: dts[0],
)

# row-wise string builders
_host_rowwise(
    "concat",
    lambda *parts: None if any(p is None for p in parts) else "".join(parts),
    T.STRING,
)
_host_rowwise(
    "concat_ws",
    lambda sep, *parts: None if sep is None else sep.join(p for p in parts if p is not None),
    T.STRING,
)
_host_rowwise("string_space", lambda n: " " * max(int(n), 0) if n is not None else None,
              T.STRING)
_host_rowwise("null_if", lambda a, b: None if a == b else a, lambda dts: dts[0])


@registry.register(
    "make_array",
    lambda dts: T.DataType(T.TypeKind.LIST, inner=(dts[0] if dts else T.INT32,)),
)
def _make_array(args, cap, device):
    """make_array(c1, c2, ...): Spark CreateArray (reference
    spark_make_array.rs). NULL elements stay inside the list; the result is
    never NULL. The rows are assembled on the host into the LIST
    vocabulary."""
    ones = torch.ones(cap, dtype=torch.bool, device=device)
    if not args:
        # Spark's array(): zero elements, element type NULL
        out_dt = T.DataType(T.TypeKind.LIST, inner=(T.NULL,))
        v, _, d = column_from_pylist([[]] * cap, out_dt, cap, device)
        return _cv(v, ones, out_dt, d)
    out_dt = T.DataType(T.TypeKind.LIST, inner=(args[0].dtype,))
    rows = [list(vals) for vals in zip(*host_pylists(args))]
    v, _, d = column_from_pylist(rows, out_dt, cap, device)
    return _cv(v, ones, out_dt, d)


# ---------------------------------------------------------------------------
# nested (LIST/MAP/STRUCT) value transforms — reference: spark_map.rs,
# spark_make_array.rs, get_map_value / get_indexed_field exprs
# ---------------------------------------------------------------------------


def _entry_table(a, new: list, out_dt: T.DataType):
    """Per-entry results ``new`` (None = NULL) of a dictionary column ``a``
    as a ColumnVal: a dictionary result keeps the codes against a vocabulary
    of the results, a fixed-width one gathers the values by code."""
    ok = np.array([v is not None for v in new], dtype=bool)
    idx = a.values.clamp(0, max(len(new) - 1, 0))
    valid = a.validity & gather_table(ok, a.values)
    if out_dt.is_dict_encoded:
        return _cv(idx.to(torch.int32), valid, out_dt,
                   object_array([v if v is not None else empty_entry(out_dt) for v in new]))
    vals = np.zeros(len(new), dtype=out_dt.numpy_dtype())
    temporal = out_dt.kind in (T.TypeKind.DATE32, T.TypeKind.TIMESTAMP)
    for i, v in enumerate(new):
        if v is not None:
            if out_dt.kind == T.TypeKind.DECIMAL:
                import decimal as pydec

                vals[i] = int(pydec.Decimal(str(v)).scaleb(out_dt.scale))
            else:
                vals[i] = _physical_of(v, out_dt) if temporal else v
    return _cv(gather_table(vals, a.values), valid, out_dt)


def _dict_value_transform(name: str, py_fn, out_dtype_fn):
    """Like ``_dict_transform`` for any dictionary-encoded input (LIST, MAP,
    STRUCT or STRING): transforms the vocabulary entries on the host; the
    result is a dictionary or a gathered fixed-width column."""

    @registry.register(name, out_dtype_fn)
    def _f(args, cap, device, py_fn=py_fn, out_dtype_fn=out_dtype_fn):
        a = args[0]
        assert a.dtype.is_dict_encoded, f"{name} needs a dict-encoded arg"
        extra = [_scalar_arg(x) for x in args[1:]]
        out_dt = (out_dtype_fn([x.dtype for x in args]) if callable(out_dtype_fn)
                  else out_dtype_fn)
        return _entry_table(a, [py_fn(e, *extra) if e is not None else None for e in a.dict],
                            out_dt)

    return _f


def _element_at_list(e, idx):
    i = int(idx)
    if i == 0 or abs(i) > len(e):
        return None
    return e[i - 1] if i > 0 else e[i]


@registry.register(
    "element_at",
    lambda dts: dts[0].inner[1] if dts[0].kind == T.TypeKind.MAP else dts[0].inner[0],
)
def _element_at_fn(args, cap, device):
    """element_at(map, key) / element_at(array, 1-based index): dispatch on
    the column type (an empty map is an empty list by value)."""
    a = args[0]
    key = _scalar_arg(args[1])
    if a.dtype.kind == T.TypeKind.MAP:
        return _entry_table(a, [_map_get(e, key) if e is not None else None for e in a.dict],
                            a.dtype.inner[1])
    return _entry_table(a, [_element_at_list(e, key) if e is not None else None
                            for e in a.dict], a.dtype.inner[0])


def _map_get(m, key):
    """The value of the first entry of ``m`` whose key equals ``key``."""
    return next((v for k, v in m if k == key), None)


_dict_value_transform("map_keys", lambda m: [k for k, _ in m],
                      lambda dts: T.DataType(T.TypeKind.LIST, inner=(dts[0].inner[0],)))
_dict_value_transform("map_values", lambda m: [v for _, v in m],
                      lambda dts: T.DataType(T.TypeKind.LIST, inner=(dts[0].inner[1],)))
_dict_value_transform("get_map_value", _map_get, lambda dts: dts[0].inner[1])
_dict_value_transform(
    "str_to_map",
    # Spark's defaults: pairs split on ',', key and value on ':'; a pair
    # without the key delimiter maps its key to NULL
    lambda s, pd_=",", kd=":": [tuple((kv.split(kd, 1) + [None])[:2]) for kv in s.split(pd_)]
    if s else [],
    lambda dts: T.DataType(T.TypeKind.MAP, inner=(T.STRING, T.STRING)),
)
_host_rowwise(
    "map_concat",
    # a later map's key wins, as in the reference (a Python dict merge)
    lambda a, b: list({**dict(a or []), **dict(b or [])}.items()),
    lambda dts: dts[0],
)
_host_rowwise(
    "map_from_arrays",
    lambda ks, vs: list(zip(ks or [], vs or [])),
    lambda dts: T.DataType(T.TypeKind.MAP, inner=(dts[0].inner[0], dts[1].inner[0])),
)


def _entry_kv(e):
    if e is None:
        # Spark 3.x: a runtime error, not a silent NULL
        raise ValueError("map_from_entries does not allow null entries")
    if isinstance(e, (list, tuple)):
        return {"key": e[0], "value": e[1]}
    return {"key": e["key"], "value": e["value"]}


_host_rowwise(
    "map_from_entries",
    lambda entries: None if entries is None else [_entry_kv(e) for e in entries],
    lambda dts: T.DataType(
        T.TypeKind.MAP,
        inner=(dts[0].inner[0].inner[0] if dts and dts[0].inner else T.STRING,
               dts[0].inner[0].inner[1] if dts and dts[0].inner else T.STRING),
    ),
)


@registry.register("named_struct")
def _named_struct(args, cap, device):
    """named_struct(name1, col1, name2, col2, ...) with literal names: the
    rows assembled on the host into the STRUCT vocabulary; never NULL."""
    names = [_scalar_arg(args[i]) for i in range(0, len(args), 2)]
    val_cvs = [args[i] for i in range(1, len(args), 2)]
    out_dt = T.DataType(T.TypeKind.STRUCT, inner=tuple(cv.dtype for cv in val_cvs),
                        struct_names=tuple(names))
    # each row's dict, its field values already in the port's form: the
    # vocabulary directly, identity codes
    rows = [dict(zip(names, vals)) for vals in zip(*host_pylists(val_cvs))] if val_cvs \
        else [{} for _ in range(cap)]
    codes = torch.arange(cap, dtype=torch.int32, device=device)
    return _cv(codes, torch.ones(cap, dtype=torch.bool, device=device), out_dt,
               object_array(rows))


@registry.register("get_struct_field")
def _get_struct_field(args, cap, device):
    a = args[0]
    name = str(_scalar_arg(args[1]))
    assert a.dtype.kind == T.TypeKind.STRUCT
    out_dt = a.dtype.inner[a.dtype.struct_names.index(name)]
    return _entry_table(a, [e.get(name) if isinstance(e, dict) else None for e in a.dict],
                        out_dt)


_dict_value_transform("array_size", lambda e: len(e), T.INT32)
_dict_value_transform("array_contains", lambda e, item: item in e, T.BOOL)
_dict_value_transform(
    "array_join", lambda e, sep: sep.join(str(x) for x in e if x is not None), T.STRING)
_dict_value_transform("array_distinct", lambda e: list(dict.fromkeys(e)), lambda dts: dts[0])
_dict_value_transform(
    "sort_array",
    # Spark null placement: nulls first ascending, last descending
    lambda e, asc=True: (
        [x for x in e if x is None] + sorted(x for x in e if x is not None)
        if asc
        else sorted((x for x in e if x is not None), reverse=True) + [x for x in e if x is None]
    ),
    lambda dts: dts[0],
)
_dict_value_transform(
    "array_min", lambda e: min((x for x in e if x is not None), default=None),
    lambda dts: dts[0].inner[0])
_dict_value_transform(
    "array_max", lambda e: max((x for x in e if x is not None), default=None),
    lambda dts: dts[0].inner[0])


# ---------------------------------------------------------------------------
# the long tail: regexp family, hex/base64, conv, hash functions in SQL
# form, parse_json (reference spark_strings.rs / spark_hash.rs /
# spark_get_json_object.rs)
# ---------------------------------------------------------------------------


def _java_regex(p: str):
    """Java-flavored pattern -> python re (close subset; possessive
    quantifiers and \\p{...} unicode classes are not translated)."""
    return _re.compile(p)


def _rlike(s: str, p: str) -> bool:
    return _java_regex(p).search(s) is not None


def _regexp_extract(s: str, p: str, idx=1):
    m = _java_regex(p).search(s)
    if m is None:
        return ""  # Spark: no match -> empty string (NULLs handled outside)
    idx = int(idx)
    if idx < 0 or idx > (m.re.groups or 0):
        return None  # an invalid group index -> NULL (ANSI off)
    g = m.group(idx)
    return g if g is not None else ""


def _java_replacement(r: str, n_groups: int) -> str:
    r"""Java Matcher replacement -> python re template: $N becomes
    \g<N> (octal-safe). Java takes the LONGEST group number that is a
    valid group of the pattern ($12 with one group = group 1 + literal
    '2'); a backslash escapes the next char literally."""
    out: list[str] = []
    i, n = 0, len(r)
    while i < n:
        c = r[i]
        if c == "\\":
            if i + 1 < n:
                nxt = r[i + 1]
                out.append("\\\\" if nxt == "\\" else nxt)
                i += 2
                continue
            out.append("\\\\")
            i += 1
            continue
        if c == "$" and i + 1 < n and r[i + 1].isdigit():
            # greedy longest VALID group number (Matcher.appendReplacement)
            j = i + 1
            while j < n and r[j].isdigit() and int(r[i + 1: j + 1]) <= max(n_groups, 0):
                j += 1
            if j == i + 1:  # the first digit already exceeds the group count
                j = i + 2   # Java errors here; degrade to that single digit
            out.append(f"\\g<{r[i + 1: j]}>")
            i = j
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _regexp_replace(s: str, p: str, r: str) -> str:
    rx = _java_regex(p)
    return rx.sub(_java_replacement(r, rx.groups), s)


# regex patterns/replacements are foldable in Spark plans, so these run as
# O(|vocabulary|) dictionary transforms, not per-row host calls
_dict_transform("rlike", lambda s, p: None if p is None else _rlike(s, p), T.BOOL)
_dict_transform(
    "regexp_extract",
    lambda s, p, idx=1: None if p is None or idx is None else _regexp_extract(s, p, idx),
    T.STRING,
)
_dict_transform(
    "regexp_replace",
    lambda s, p, r: None if p is None or r is None else _regexp_replace(s, p, r),
    T.STRING,
)


@registry.register("hex", T.STRING)
def _hex(args, cap, device):
    a = args[0]
    if a.dtype.is_string_like:
        return dict_apply(
            a, lambda s: (s.encode("utf-8") if isinstance(s, str) else s).hex().upper(),
            T.STRING)
    # integral: uppercase hex of the unsigned 64-bit two's complement
    (vals,) = host_pylists([_cv(a.values.to(torch.int64), a.validity, T.INT64)])
    out = [format(x & ((1 << 64) - 1), "X") if x is not None else None for x in vals]
    v, m, d = column_from_pylist(out, T.STRING, cap, device)
    return _cv(v, m, T.STRING, d)


def _unhex(s: str):
    if len(s) % 2:
        s = "0" + s  # Spark pads odd-length inputs
    try:
        return bytes.fromhex(s)
    except ValueError:
        return None


_dict_transform("unhex", _unhex, T.BINARY)
_dict_transform(
    "base64",
    lambda s: _b64.b64encode(s.encode("utf-8") if isinstance(s, str) else s).decode(),
    T.STRING,
)


def _unbase64(s: str):
    try:
        return _b64.b64decode(s, validate=False)
    except Exception:
        return None


_dict_transform("unbase64", _unbase64, T.BINARY)

_CONV_DIGITS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _conv(num: str, from_base: int, to_base: int):
    """Hive/Spark conv(): parse the leading valid digits; unsigned 64-bit
    wraparound for negative values when to_base > 0."""
    fb, tb = int(from_base), int(to_base)
    if not (2 <= abs(fb) <= 36 and 2 <= abs(tb) <= 36):
        return None
    s = num.strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    val = 0
    seen = False
    overflow = False
    bound = (1 << 64) - 1
    for ch in s.upper():
        d = _CONV_DIGITS.find(ch)
        if d < 0 or d >= abs(fb):
            break
        val = val * abs(fb) + d
        if val > bound:
            overflow = True  # Hive clamps to unsigned max, never wraps
        seen = True
    if not seen:
        return "0" if s else None
    if overflow:
        val = bound  # Hive clamps to unsigned max (signed view: -1)
        neg = False
    if neg:
        val = -val
    u = val & bound  # the 64-bit two's complement image
    if tb > 0:
        # positive to_base: the unsigned view
        if u == 0:
            return "0"
        out = []
        while u:
            out.append(_CONV_DIGITS[u % tb])
            u //= tb
        return "".join(reversed(out))
    # negative to_base: the SIGNED view of the 64-bit image
    tb = -tb
    sv = u - (1 << 64) if u >= (1 << 63) else u
    if sv == 0:
        return "0"
    sign = "-" if sv < 0 else ""
    sv = abs(sv)
    out = []
    while sv:
        out.append(_CONV_DIGITS[sv % tb])
        sv //= tb
    return sign + "".join(reversed(out))


_dict_transform("conv", lambda n, f, t: None if f is None or t is None else _conv(n, f, t),
                T.STRING)


def _register_hash_fn(name: str, algo: str, out_t):
    @registry.register(name, out_t)
    def _f(args, cap, device, algo=algo, out_t=out_t):
        from auron_tpu_torch.exec.basic import batch_from_columns
        from auron_tpu_torch.ops.hash_dispatch import hash_batch

        ones = torch.ones(cap, dtype=torch.bool, device=device)
        kb = batch_from_columns(list(args), [f"c{i}" for i in range(len(args))], ones)
        return _cv(hash_batch(kb, list(range(len(args))), algo, seed=42), ones, out_t)

    return _f


# Spark: hash() == murmur3 (an int32), xxhash64() (an int64), never NULL
_register_hash_fn("hash", "murmur3", T.INT32)
_register_hash_fn("murmur3_hash", "murmur3", T.INT32)
_register_hash_fn("xxhash64", "xxhash64", T.INT64)


def _canon_json(s: str):
    try:
        return json.dumps(json.loads(s), separators=(",", ":"))
    except (ValueError, TypeError):
        return None


_dict_transform("parse_json", _canon_json, T.STRING)


@registry.register("get_parsed_json_object", T.STRING)
def _get_parsed_json_object(args, cap, device):
    # the parsed representation is the canonical JSON string; same paths
    return registry.dispatch("get_json_object", args, cap, device)
