"""Scalar function registry with Spark semantics.

Port of ``auron_tpu/functions/registry.py``: a name -> kernel map the
planner targets from protobuf ``scalar_func`` nodes. A kernel receives the
evaluated ``ColumnVal`` arguments, the batch capacity and the batch's
device, and returns a ``ColumnVal``.

Two kernel families:
- device kernels: torch ops over fixed-width columns (math, dates,
  conditional-null helpers, decimal helpers);
- dictionary kernels: string functions whose result depends only on the
  *value* (upper/lower/trim/substring/length/...) transform the host
  vocabulary once (O(|vocabulary|) host work) and gather by code on the
  device (``dict_apply``).

Where the torch op differs from jnp's the kernel spells the jnp rule out:
``signum`` keeps NaN and -0.0 (``torch.sign`` gives 0 for both), ``cbrt``
is a sign-preserving power (torch has no cube root), ``sinh``/``cosh`` stay
finite up to the float64 range (torch's CPU kernel overflows early), float
-> int64 casts saturate with NaN -> 0 (XLA's conversion), ``round`` is
HALF_UP, integer division truncates where the reference uses
``lax.div``/``lax.rem`` and floors where it uses ``jnp.floor_divide``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.columnar.batch import object_array
from auron_tpu_torch.exprs import decimal_math as D
from auron_tpu_torch.exprs.eval import ColumnVal
from auron_tpu_torch.exprs.eval import _gather_table as gather_table

class Registry:
    def __init__(self):
        self._fns: dict[str, Callable] = {}
        self._dtypes: dict[str, Callable] = {}

    def register(self, name: str, infer_dtype: Callable | T.DataType | None = None):
        def deco(fn):
            self._fns[name] = fn
            if infer_dtype is not None:
                self._dtypes[name] = (
                    infer_dtype if callable(infer_dtype) else (lambda args: infer_dtype)
                )
            return fn

        return deco

    def names(self) -> list[str]:
        return sorted(self._fns)

    def lookup(self, name: str) -> Callable | None:
        return self._fns.get(name)

    # functions that handle dict-encoded wide decimals correctly (rank
    # orders, byte-exact hashes); everything else would silently operate
    # on dictionary codes, so dispatch fails loudly instead
    _WIDE_DECIMAL_SAFE = frozenset({"hash", "murmur3_hash", "xxhash64", "least", "greatest"})

    def dispatch(self, name: str, args: list, cap: int, device=None):
        if name not in self._fns:
            raise KeyError(f"scalar function '{name}' not registered")
        if name not in self._WIDE_DECIMAL_SAFE and any(a.dtype.is_wide_decimal for a in args):
            raise NotImplementedError(
                f"scalar function '{name}' over decimal(p>18) arguments is "
                "not supported yet (values are dictionary codes)")
        if device is None:
            device = args[0].values.device if args else "cpu"
        return self._fns[name](args, cap, device)

    def infer_dtype(self, name: str, arg_dtypes: list[T.DataType]) -> T.DataType:
        if name in self._dtypes:
            return self._dtypes[name](arg_dtypes)
        return arg_dtypes[0] if arg_dtypes else T.NULL


registry = Registry()


def _cv(values, validity, dtype, d=None) -> ColumnVal:
    return ColumnVal(values, validity, dtype, d)


def fdiv(a, b):
    """Floor division (``jnp.floor_divide`` / jnp ``//`` on integers)."""
    return torch.div(a, b, rounding_mode="floor")


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d``, correctly rounded on every device: torch's CUDA kernel
    divides by a Python scalar as a product with its reciprocal, which
    differs from the quotient (XLA's, the CPU's) by an ulp."""
    return x / torch.full_like(x, d)


def f64_to_i64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int64 conversion: truncation, saturating at the int64
    range, NaN -> 0 (a plain torch cast of NaN or of an out-of-range value
    is platform-defined)."""
    lo, hi = -(2.0**63), 2.0**63
    safe = torch.where(torch.isnan(x) | (x >= hi) | (x < lo), torch.zeros_like(x), x)
    out = safe.to(torch.int64)
    out = torch.where(x >= hi, torch.full_like(out, 2**63 - 1), out)
    return torch.where(x < lo, torch.full_like(out, -(2**63)), out)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------


@registry.register("abs")
def _abs(args, cap, device):
    a = args[0]
    return _cv(torch.abs(a.values), a.validity, a.dtype)


@registry.register("negative")
def _neg(args, cap, device):
    a = args[0]
    return _cv(-a.values, a.validity, a.dtype)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Sign-preserving cube root: -0.0, +-inf and NaN pass through."""
    return torch.copysign(torch.pow(torch.abs(x), 1.0 / 3.0), x)


_LN2 = 0.6931471805599453


def _cosh(x: torch.Tensor) -> torch.Tensor:
    """cosh, finite up to |x| ~ 710.47 as the reference's: torch's
    vectorized CPU kernel overflows from |x| ~ 709.8 (exp(|x|) / 2 past
    the float64 range); there, exp(|x| - ln 2)."""
    big = torch.abs(x) > 700.0
    return torch.where(big, torch.exp(torch.abs(x) - _LN2), torch.cosh(x))


def _sinh(x: torch.Tensor) -> torch.Tensor:
    big = torch.abs(x) > 700.0
    return torch.where(big, torch.copysign(torch.exp(torch.abs(x) - _LN2), x), torch.sinh(x))


def _signum(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: -1 / 1 off zero, the input itself at +-0.0 and NaN."""
    return torch.where(x > 0, torch.ones_like(x), torch.where(x < 0, -torch.ones_like(x), x))


def _float_fn(name, fn):
    @registry.register(name, T.FLOAT64)
    def _f(args, cap, device, fn=fn):
        a = args[0]
        return _cv(fn(a.values.to(torch.float64)), a.validity, T.FLOAT64)

    return _f


_float_fn("sqrt", torch.sqrt)
_float_fn("exp", torch.exp)
_float_fn("ln", torch.log)
_float_fn("log10", torch.log10)
_float_fn("log2", torch.log2)
_float_fn("sin", torch.sin)
_float_fn("cos", torch.cos)
_float_fn("tan", torch.tan)
_float_fn("asin", torch.asin)
_float_fn("acos", torch.acos)
_float_fn("atan", torch.atan)
_float_fn("sinh", _sinh)
_float_fn("cosh", _cosh)
_float_fn("tanh", torch.tanh)
_float_fn("cbrt", _cbrt)
_float_fn("degrees", torch.rad2deg)
_float_fn("radians", torch.deg2rad)
_float_fn("signum", _signum)
_float_fn("floor_f", torch.floor)
_float_fn("ceil_f", torch.ceil)


def _decimal_floor_ceil(a, up: bool):
    p = D.pow10(a.dtype.scale)
    q = D.tdiv(a.values, p)
    r = torch.fmod(a.values, p)
    adj = (r > 0) if up else -(r < 0).to(torch.int64)
    return _cv(q + adj.to(torch.int64), a.validity, T.decimal(a.dtype.precision, 0))


@registry.register("ceil", lambda a: T.INT64 if a[0].is_float else a[0])
def _ceil(args, cap, device):
    a = args[0]
    if a.dtype.is_float:
        return _cv(f64_to_i64(torch.ceil(a.values.to(torch.float64))), a.validity, T.INT64)
    if a.dtype.kind == T.TypeKind.DECIMAL:
        return _decimal_floor_ceil(a, True)
    return _cv(a.values, a.validity, a.dtype)


@registry.register("floor", lambda a: T.INT64 if a[0].is_float else a[0])
def _floor(args, cap, device):
    a = args[0]
    if a.dtype.is_float:
        return _cv(f64_to_i64(torch.floor(a.values.to(torch.float64))), a.validity, T.INT64)
    if a.dtype.kind == T.TypeKind.DECIMAL:
        return _decimal_floor_ceil(a, False)
    return _cv(a.values, a.validity, a.dtype)


@registry.register("pow", T.FLOAT64)
def _pow(args, cap, device):
    a, b = args
    v = torch.pow(a.values.to(torch.float64), b.values.to(torch.float64))
    return _cv(v, a.validity & b.validity, T.FLOAT64)


@registry.register("atan2", T.FLOAT64)
def _atan2(args, cap, device):
    a, b = args
    v = torch.atan2(a.values.to(torch.float64), b.values.to(torch.float64))
    return _cv(v, a.validity & b.validity, T.FLOAT64)


@registry.register("round")
def _round(args, cap, device):
    """Spark round: HALF_UP (away from zero at .5), optional scale arg."""
    a = args[0]
    scale = int(_scalar_arg(args[1])) if len(args) > 1 else 0
    if a.dtype.kind == T.TypeKind.DECIMAL:
        v, ok = D.rescale(a.values, a.dtype.scale, scale)
        out_t = T.decimal(a.dtype.precision, max(scale, 0))
        v2, ok2 = D.rescale(v, scale, out_t.scale)
        return _cv(v2, a.validity & ok & ok2, out_t)
    if a.dtype.is_float:
        m = 10.0**scale
        x = a.values.to(torch.float64) * m
        r = true_div(torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)), m)
        return _cv(r.to(a.values.dtype), a.validity, a.dtype)
    if scale >= 0:
        return a
    p = 10 ** (-scale)
    v = a.values.to(torch.int64)
    q = D.tdiv(v, p)
    r = torch.fmod(v, p)
    adj = torch.where(2 * torch.abs(r) >= p, torch.sign(r), torch.zeros_like(r))
    return _cv(((q + adj) * p).to(a.values.dtype), a.validity, a.dtype)


@registry.register("isnan", T.BOOL)
def _isnan(args, cap, device):
    a = args[0]
    v = torch.isnan(a.values) if a.dtype.is_float else torch.zeros_like(a.validity)
    return _cv(v & a.validity, torch.ones_like(a.validity), T.BOOL)


@registry.register("nanvl")
def _nanvl(args, cap, device):
    a, b = args
    isn = torch.isnan(a.values)
    return _cv(torch.where(isn, b.values, a.values), torch.where(isn, b.validity, a.validity),
               a.dtype)


@registry.register("null_if_zero")
def _null_if_zero(args, cap, device):
    # reference: datafusion-ext-functions/src/null_if.rs
    a = args[0]
    return _cv(a.values, a.validity & ~(a.values == 0), a.dtype)


@registry.register("normalize_nan_and_zero")
def _normalize_nan_and_zero(args, cap, device):
    v = args[0].values
    v = torch.where(v == 0, torch.zeros_like(v), v)  # -0.0 -> +0.0
    v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
    return _cv(v, args[0].validity, args[0].dtype)


# ---------------------------------------------------------------------------
# dates (days since epoch / micros since epoch)
# ---------------------------------------------------------------------------


def civil_from_days(days: torch.Tensor):
    """days-since-epoch -> (year, month, day), proleptic Gregorian."""
    z = days.to(torch.int64) + 719468
    era = fdiv(z, 146097)
    doe = z - era * 146097
    yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) - fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100))
    mp = fdiv(5 * doy + 2, 153)
    d = doy - fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y, m, d):
    y = y - (m <= 2).to(torch.int64)
    era = fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + fdiv(yoe, 4) - fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def date_arg(a) -> torch.Tensor:
    if a.dtype.kind == T.TypeKind.TIMESTAMP:
        return fdiv(a.values, 86_400_000_000).to(torch.int32)
    return a.values


@registry.register("year", T.INT32)
def _year(args, cap, device):
    y, _, _ = civil_from_days(date_arg(args[0]))
    return _cv(y.to(torch.int32), args[0].validity, T.INT32)


@registry.register("month", T.INT32)
def _month(args, cap, device):
    _, m, _ = civil_from_days(date_arg(args[0]))
    return _cv(m.to(torch.int32), args[0].validity, T.INT32)


@registry.register("day", T.INT32)
def _day(args, cap, device):
    _, _, d = civil_from_days(date_arg(args[0]))
    return _cv(d.to(torch.int32), args[0].validity, T.INT32)


@registry.register("quarter", T.INT32)
def _quarter(args, cap, device):
    _, m, _ = civil_from_days(date_arg(args[0]))
    return _cv((fdiv(m - 1, 3) + 1).to(torch.int32), args[0].validity, T.INT32)


@registry.register("dayofweek", T.INT32)
def _dayofweek(args, cap, device):
    # Spark: 1 = Sunday ... 7 = Saturday; 1970-01-01 was a Thursday (5)
    d = date_arg(args[0]).to(torch.int64)
    return _cv((torch.remainder(d + 4, 7) + 1).to(torch.int32), args[0].validity, T.INT32)


@registry.register("dayofyear", T.INT32)
def _dayofyear(args, cap, device):
    d = date_arg(args[0])
    y, _, _ = civil_from_days(d)
    jan1 = days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
    return _cv((d - jan1 + 1).to(torch.int32), args[0].validity, T.INT32)


@registry.register("date_add", T.DATE32)
def _date_add(args, cap, device):
    a, n = args
    return _cv((a.values + n.values.to(torch.int32)).to(torch.int32), a.validity & n.validity,
               T.DATE32)


@registry.register("date_sub", T.DATE32)
def _date_sub(args, cap, device):
    a, n = args
    return _cv((a.values - n.values.to(torch.int32)).to(torch.int32), a.validity & n.validity,
               T.DATE32)


@registry.register("datediff", T.INT32)
def _datediff(args, cap, device):
    a, b = args
    return _cv((date_arg(a) - date_arg(b)).to(torch.int32), a.validity & b.validity, T.INT32)


def last_dom_days(y, m):
    """Days since epoch of the last day of month (y, m)."""
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, torch.ones_like(m), m + 1)
    return days_from_civil(ny, nm, torch.ones_like(nm)) - 1


@registry.register("last_day", T.DATE32)
def _last_day(args, cap, device):
    y, m, _ = civil_from_days(date_arg(args[0]))
    return _cv(last_dom_days(y, m).to(torch.int32), args[0].validity, T.DATE32)


# ---------------------------------------------------------------------------
# string functions via dictionary transforms
# ---------------------------------------------------------------------------


def _scalar_arg(cv):
    """A constant argument's Python value (row 0 of the column): a literal's
    host value when it carries one, else one read of row 0."""
    if cv.const is not None:
        return cv.const
    if cv.dtype.is_string_like:
        return cv.dict[int(cv.values[0].item())]
    return cv.values[0].item()


def dict_apply(a, py_fn, out_dtype, extra=()):
    """Apply a per-value transform over a dict-encoded column's vocabulary
    (O(|vocabulary|) host work, device gathers only). A string result gets
    its own vocabulary in first-occurrence order; None marks the rows
    NULL."""
    entries = a.dict
    new = [py_fn(s, *extra) if s is not None else None for s in entries]
    ok = np.array([v is not None for v in new], dtype=bool)
    if out_dtype.is_string_like:
        filler = b"" if out_dtype.kind == T.TypeKind.BINARY else ""
        vocab: dict = {}
        remap = np.empty(len(new), dtype=np.int32)
        for i, s in enumerate(new):
            remap[i] = vocab.setdefault(s if s is not None else filler, len(vocab))
        codes = gather_table(remap, a.values)
        return _cv(codes, a.validity & gather_table(ok, a.values), out_dtype,
                   object_array(list(vocab) or [filler]))
    vals = np.array([v if v is not None else 0 for v in new], dtype=out_dtype.numpy_dtype())
    return _cv(gather_table(vals, a.values), a.validity & gather_table(ok, a.values), out_dtype)


def _dict_transform(name: str, py_fn, out_dtype=T.STRING):
    @registry.register(name, out_dtype)
    def _f(args, cap, device, py_fn=py_fn, out_dtype=out_dtype):
        a = args[0]
        assert a.dtype.is_string_like, f"{name} needs a string arg"
        extra = [_scalar_arg(x) for x in args[1:]]
        return dict_apply(a, py_fn, out_dtype, extra)

    return _f


_dict_transform("upper", lambda s: s.upper())
_dict_transform("lower", lambda s: s.lower())
_dict_transform("trim", lambda s: s.strip(" "))
_dict_transform("ltrim", lambda s: s.lstrip(" "))
_dict_transform("rtrim", lambda s: s.rstrip(" "))
_dict_transform("reverse", lambda s: s[::-1])
_dict_transform("length", lambda s: len(s), T.INT32)
_dict_transform("octet_length", lambda s: len(s.encode("utf-8")), T.INT32)
_dict_transform("ascii", lambda s: ord(s[0]) if s else 0, T.INT32)


def _substring(s: str, pos: int, length: int = 1 << 30) -> str:
    # Spark 1-based; pos 0 behaves like 1; negative counts from the end
    n = len(s)
    if pos > 0:
        start = pos - 1
    elif pos == 0:
        start = 0
    else:
        start = max(n + pos, 0)
    if length < 0:
        return ""
    return s[start: start + length]


_dict_transform("substring", _substring)
_dict_transform("starts_with", lambda s, p: s.startswith(p), T.BOOL)
_dict_transform("ends_with", lambda s, p: s.endswith(p), T.BOOL)
_dict_transform("contains", lambda s, p: p in s, T.BOOL)
_dict_transform("repeat", lambda s, n: s * max(n, 0))
_dict_transform("lpad", lambda s, n, p=" ": (p * n + s)[-n:] if n > len(s) else s[:n])
_dict_transform("rpad", lambda s, n, p=" ": (s + p * n)[:n] if n > len(s) else s[:n])
_dict_transform("instr", lambda s, sub: s.find(sub) + 1, T.INT32)


# ---------------------------------------------------------------------------
# runtime filters
# ---------------------------------------------------------------------------


@registry.register("bloom_filter_might_contain", T.BOOL)
def _bloom_might_contain(args, cap, device):
    """args: (serialized bloom filter as a BINARY literal, long column). The
    filter is built by the bloom-filter aggregate on the other side of a
    join and shipped through the plan."""
    from auron_tpu_torch.ops.bloom import SparkBloomFilter

    filt_cv, col_cv = args
    bf = SparkBloomFilter.deserialize(_scalar_arg(filt_cv), device=col_cv.values.device)
    return _cv(bf.might_contain_long(col_cv.values.to(torch.int64)), col_cv.validity, T.BOOL)
