"""Spark-exact casts (port of ``auron_tpu/exprs/cast.py``).

Device casts over torch tensors (``cast_values``), organized by (from_kind,
to_kind), Spark non-ANSI unless noted:

- int -> narrower int: two's-complement wrap (Java narrowing);
- float/double -> int types: NaN -> 0, out-of-range saturates;
- numeric -> decimal and decimal -> numeric with HALF_UP rescale and
  overflow -> NULL: decimal <-> decimal rescales and checks the precision,
  decimal -> int truncates toward zero (out of range NULL), int -> decimal
  is checked, float -> decimal rounds HALF_UP by ``floor(x + 0.5)`` /
  ``ceil(x - 0.5)`` of ``x * 10.0**scale``;
- bool <-> numeric, date32 <-> timestamp-us;
- string -> numeric/bool/date/timestamp/decimal (``cast_string_dict``):
  evaluated once per vocabulary entry on the host, then gathered by code;
  invalid strings become NULL. A vocabulary is a numpy object array.

The host half (``cast_scalar``, ``format_scalar``, Spark's lenient
string -> date/timestamp parser, Java's Float/Double/BigDecimal display,
``can_cast``) is copied from the reference; the scalar cast of a
fixed-width value runs ``cast_values`` on a one-element CPU tensor.
List, struct and map casts are not in the port yet: ``cast_scalar`` raises
``NotImplementedError`` naming the type.
"""

from __future__ import annotations

import datetime as _dt
import decimal as _pydec

import numpy as np
import torch

from auron_tpu_torch import types as T
from auron_tpu_torch.exprs import decimal_math as D

_INT_BOUNDS = {
    T.TypeKind.INT8: (-128, 127),
    T.TypeKind.INT16: (-(2**15), 2**15 - 1),
    T.TypeKind.INT32: (-(2**31), 2**31 - 1),
    T.TypeKind.INT64: (-(2**63), 2**63 - 1),
}

_NESTED = (T.TypeKind.LIST, T.TypeKind.MAP, T.TypeKind.STRUCT)


def cast_values(values: torch.Tensor, validity: torch.Tensor, src: T.DataType,
                dst: T.DataType) -> tuple[torch.Tensor, torch.Tensor]:
    """Device cast of fixed-width values; returns (values, validity)."""
    if src == dst:
        return values, validity
    sk, dk = src.kind, dst.kind
    if sk == T.TypeKind.NULL:
        return (torch.zeros_like(values, dtype=dst.physical_dtype()),
                torch.zeros_like(validity))
    if sk == T.TypeKind.BOOL:
        return cast_values(values.to(torch.int64), validity, T.INT64, dst)
    if dk == T.TypeKind.BOOL:
        return values != 0, validity
    us_per_day = 86_400_000_000
    if sk == T.TypeKind.DATE32 and dk == T.TypeKind.TIMESTAMP:
        return values.to(torch.int64) * us_per_day, validity
    if sk == T.TypeKind.TIMESTAMP and dk == T.TypeKind.DATE32:
        return torch.div(values, us_per_day, rounding_mode="floor").to(torch.int32), validity
    if sk == T.TypeKind.DATE32 and dst.is_numeric:
        return cast_values(values.to(torch.int32), validity, T.INT32, dst)
    if sk == T.TypeKind.TIMESTAMP and dst.is_numeric:
        secs = torch.div(values, 1_000_000, rounding_mode="floor")  # Spark: seconds
        return cast_values(secs, validity, T.INT64, dst)
    if src.is_integer and dk == T.TypeKind.DATE32:
        return values.to(torch.int32), validity
    if src.is_integer and dk == T.TypeKind.TIMESTAMP:
        return values.to(torch.int64) * 1_000_000, validity

    if sk == T.TypeKind.DECIMAL:
        if dk == T.TypeKind.DECIMAL:
            v, ok = D.rescale(values, src.scale, dst.scale)
            return v, validity & ok & D.precision_ok(v, dst.precision)
        if dst.is_integer:
            # truncates toward zero; out of range -> NULL
            trunc = D.tdiv(values, D.pow10(min(src.scale, 18))) if src.scale > 0 else values
            lo, hi = _INT_BOUNDS[dk]
            ok = (trunc >= lo) & (trunc <= hi)
            return trunc.to(dst.physical_dtype()), validity & ok
        if dst.is_float:
            f = values.to(torch.float64) * (10.0 ** (-src.scale))
            return f.to(dst.physical_dtype()), validity

    if dk == T.TypeKind.DECIMAL:
        if src.is_integer:
            v, ok = D.checked_mul_pow10(values.to(torch.int64), dst.scale)
            return v, validity & ok & D.precision_ok(v, dst.precision)
        if src.is_float:
            scaled = values.to(torch.float64) * (10.0**dst.scale)
            rounded = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                                  torch.ceil(scaled - 0.5))
            ok = torch.isfinite(scaled) & (torch.abs(rounded) < 2.0**63)
            v = torch.where(ok, rounded, torch.zeros_like(rounded)).to(torch.int64)
            ok = ok & D.precision_ok(v, dst.precision)
            return torch.where(ok, v, torch.zeros_like(v)), validity & ok

    if src.is_float and dst.is_integer:
        lo, hi = _INT_BOUNDS[dk]
        f = values.to(torch.float64)
        t = torch.trunc(f)
        if dk == T.TypeKind.INT64:
            # the largest double below 2^63 is 2^63 - 1024; >= 2^63 saturates
            iv = t.clamp(-(2.0**63), float(2**63 - 1024)).to(torch.int64)
            iv = torch.where(t >= 2.0**63, torch.full_like(iv, hi), iv)
        else:
            iv = t.clamp(float(lo), float(hi)).to(torch.int64)
        iv = torch.where(torch.isnan(f), torch.zeros_like(iv), iv)
        return iv.to(dst.physical_dtype()), validity
    if (src.is_integer or src.is_float) and (dst.is_integer or dst.is_float):
        return values.to(dst.physical_dtype()), validity
    raise TypeError(f"unsupported device cast {src} -> {dst}")


# ---------------------------------------------------------------------------
# string source: cast the vocabulary on the host, gather by code
# ---------------------------------------------------------------------------


def cast_string_dict(d, dst: T.DataType) -> tuple[np.ndarray, np.ndarray]:
    """Cast vocabulary entries to ``dst``: (values, ok) per code. Spark trims
    whitespace for numeric casts and accepts "123", "1.5", scientific
    notation; invalid -> NULL. Wide-decimal vocabularies (Decimal entries)
    take the same path."""
    entries = list(d)
    n = len(entries)
    vals = np.zeros(n, dtype=dst.numpy_dtype())
    ok = np.zeros(n, dtype=bool)
    for i, s in enumerate(entries):
        if s is None:
            continue
        t = s.strip() if isinstance(s, str) else s
        try:
            if dst.kind == T.TypeKind.BOOL:
                tl = t.lower()
                if tl in ("true", "t", "yes", "y", "1"):
                    vals[i], ok[i] = True, True
                elif tl in ("false", "f", "no", "n", "0"):
                    vals[i], ok[i] = False, True
            elif dst.is_integer:
                # fractional strings truncate toward zero; range-checked
                iv = int(_pydec.Decimal(t).to_integral_value(rounding=_pydec.ROUND_DOWN))
                lo, hi = _INT_BOUNDS[dst.kind]
                if lo <= iv <= hi:
                    vals[i], ok[i] = iv, True
            elif dst.is_float:
                vals[i], ok[i] = float(t), True
            elif dst.kind == T.TypeKind.DECIMAL:
                with _pydec.localcontext() as hp:
                    hp.prec = 100  # scaleb rounds at the context precision
                    u = int(_pydec.Decimal(t).scaleb(dst.scale).quantize(
                        _pydec.Decimal(1), rounding=_pydec.ROUND_HALF_UP))
                if -(2**63) <= u < 2**63 and (dst.precision >= 19 or abs(u) < 10**dst.precision):
                    vals[i], ok[i] = u, True
            elif dst.kind == T.TypeKind.DATE32:
                days = spark_string_to_date(t)
                if days is not None:
                    vals[i], ok[i] = days, True
            elif dst.kind == T.TypeKind.TIMESTAMP:
                us = spark_string_to_timestamp(t)
                if us is not None:
                    vals[i], ok[i] = us, True
            else:
                raise TypeError(f"cast string -> {dst}")
        except (ValueError, ArithmeticError, OverflowError):
            pass
    return vals, ok


# ---------------------------------------------------------------------------
# Spark's lenient string -> date/timestamp parser
# (reference: datafusion-ext-commons/src/spark_hash + cast.rs delegate to the
#  semantics of Spark DateTimeUtils.stringToDate / stringToTimestamp)
# ---------------------------------------------------------------------------

_EPOCH = _dt.date(1970, 1, 1)


def _seg_ok(pos: int, ndig: int) -> bool:
    """Digit-count rule: year takes 4..7 digits, every other segment 1..2."""
    return (4 <= ndig <= 7) if pos == 0 else (1 <= ndig <= 2)


def _is_leap(y: int) -> bool:
    return y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)


_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _valid_ymd(y: int, m: int, d: int) -> bool:
    """Proleptic-Gregorian calendar check valid for ANY year (python's
    datetime.date caps at 9999 but Spark's LocalDate does not)."""
    if not 1 <= m <= 12 or d < 1:
        return False
    limit = _MONTH_DAYS[m - 1] + (1 if m == 2 and _is_leap(y) else 0)
    return d <= limit


def _days_from_civil(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 for a proleptic-Gregorian date, any year
    (Howard Hinnant's civil-days algorithm)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _civil_from_days(z: int) -> tuple[int, int, int]:
    """Inverse of _days_from_civil: days-since-epoch -> (y, m, d), any year
    (python's datetime.date caps at 9999; formatting must not crash on
    values the lenient parser deliberately accepts)."""
    z += 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (1 if m <= 2 else 0), m, d


def _date_str(days: int) -> str:
    y, m, d = _civil_from_days(int(days))
    if y < 0:
        return f"-{-y:04d}-{m:02d}-{d:02d}"
    return f"{y:04d}-{m:02d}-{d:02d}"


def _parse_date_segments(s: str) -> tuple[int, int, int] | None:
    """Parse `[+-]yyyy[-[m]m[-[d]d]]`; returns (y, m, d) or None."""
    sign = 1
    if s and s[0] in "+-":
        sign = -1 if s[0] == "-" else 1
        s = s[1:]
    parts = s.split("-")
    if not 1 <= len(parts) <= 3:
        return None
    out = [1, 1, 1]  # missing month/day default to 1
    for i, p in enumerate(parts):
        if not p.isdigit() or not _seg_ok(i, len(p)):
            return None
        out[i] = int(p)
    y, m, d = out
    y *= sign
    if not _valid_ymd(y, m, d):
        return None
    return y, m, d


def spark_string_to_date(s: str) -> int | None:
    """Spark `stringToDate`: days since epoch, or None (-> NULL).

    Accepts yyyy / yyyy-[m]m / yyyy-[m]m-[d]d with anything after a ' ' or
    'T' following the day segment ignored.
    """
    t = s.strip()
    if not t:
        return None
    # chop at the FIRST ' ' or 'T' separator (searching 'T' globally would
    # trip on zone names like UTC/EST after a space-separated time)
    for i, ch in enumerate(t):
        if ch in "T " and i > 0:
            t = t[:i]
            break
    ymd = _parse_date_segments(t)
    if ymd is None:
        return None
    return _days_from_civil(*ymd)


_TZ_ALIASES = {"UTC": 0, "GMT": 0, "Z": 0, "UT": 0}


def _parse_zone_offset(z: str) -> int | None:
    """Zone id -> offset seconds, or None if unparseable.

    Handles Z, ±h[h], ±h[h]:mm, ±h[h]:mm:ss, ±hhmm, UTC/GMT[±...], and IANA
    region ids via zoneinfo (resolved at the parsed instant? Spark resolves
    at the instant; for fixed-offset zones this is identical — region zones
    fall back to their current rules via zoneinfo in _apply_region_zone).
    """
    z = z.strip()
    if z.upper() in _TZ_ALIASES:
        return 0
    if z and z[0] in "+-":
        sign = -1 if z[0] == "-" else 1
        body = z[1:]
        if ":" in body:
            parts = body.split(":")
            if not 2 <= len(parts) <= 3 or not all(p.isdigit() for p in parts):
                return None
            if len(parts[0]) > 2 or any(len(p) != 2 for p in parts[1:]):
                return None
            h, mnt = int(parts[0]), int(parts[1])
            sec = int(parts[2]) if len(parts) == 3 else 0
        elif body.isdigit():
            if len(body) <= 2:
                h, mnt, sec = int(body), 0, 0
            elif len(body) == 4:
                h, mnt, sec = int(body[:2]), int(body[2:]), 0
            elif len(body) == 6:
                h, mnt, sec = int(body[:2]), int(body[2:4]), int(body[4:])
            else:
                return None
        else:
            return None
        if h > 18 or mnt > 59 or sec > 59:
            return None
        return sign * (h * 3600 + mnt * 60 + sec)
    up = z.upper()
    for pref in ("UTC", "GMT", "UT"):
        if up.startswith(pref) and len(z) > len(pref):
            return _parse_zone_offset(z[len(pref):])
    return None


def _region_zone(z: str):
    try:
        from zoneinfo import ZoneInfo

        return ZoneInfo(z)
    except Exception:
        return None


def spark_string_to_timestamp(s: str, default_date: _dt.date | None = None) -> int | None:
    """Spark `stringToTimestamp`: microseconds since epoch UTC, or None.

    Grammar: `[+-]yyyy[-[m]m[-[d]d]][[T ][h]h[:[m]m[:[s]s[.f{1,9}]]][zone]]`
    plus a bare-time form `[h]h:[m]m:...` that borrows `default_date`
    (session "today"; defaults to the current UTC date like Spark's session
    time zone default).
    """
    t = s.strip()
    if not t:
        return None

    # split date / time.  A bare time form starts with a segment containing
    # ':' before any '-' that could begin a date (careful: '-' also signs
    # the year and appears in zone offsets).
    date_part, time_part = t, ""
    for i, ch in enumerate(t):
        if ch == "T" and i == 0:
            # Spark's bare-time form with explicit separator ("T12:34:56"):
            # empty date part, everything after the T is time. A bare "T"
            # or "T<zone>" has no time body and stays invalid.
            if len(t) > 1 and t[1].isdigit():
                date_part, time_part = "", t[1:]
            break
        if ch in "T " and i > 0:
            date_part, time_part = t[:i], t[i + 1 :]
            break
        if ch == ":":  # bare time, no date segment
            date_part, time_part = "", t
            break

    if date_part:
        ymd = _parse_date_segments(date_part)
        if ymd is None:
            return None
        y, m, d = ymd
    else:
        today = default_date or _dt.datetime.now(_dt.timezone.utc).date()
        y, m, d = today.year, today.month, today.day

    hour = minute = sec = micros = 0
    tz_off_sec: int | None = 0
    region = None
    if time_part:
        # peel the zone id: first char after the time body that is not a
        # digit, ':' or '.' starts the zone (also a '+'/'-' always does)
        body, zone = time_part, ""
        for i, ch in enumerate(time_part):
            if ch in "+-":
                body, zone = time_part[:i], time_part[i:]
                break
            if not (ch.isdigit() or ch in ":."):
                body, zone = time_part[:i], time_part[i:].strip()
                break
        body = body.strip()
        if body:
            frac = ""
            if "." in body:
                body, _, frac = body.partition(".")
                if not (frac.isdigit() and 1 <= len(frac) <= 9):
                    return None
            segs = body.split(":")
            if not 1 <= len(segs) <= 3:
                return None
            for i, p in enumerate(segs):
                if not p.isdigit() or not 1 <= len(p) <= 2:
                    return None
            hour = int(segs[0])
            minute = int(segs[1]) if len(segs) > 1 else 0
            sec = int(segs[2]) if len(segs) > 2 else 0
            if frac and len(segs) < 3:
                return None  # fraction requires seconds
            micros = int(frac[:6].ljust(6, "0")) if frac else 0
            if hour > 23 or minute > 59 or sec > 59:
                return None
        if zone:
            tz_off_sec = _parse_zone_offset(zone)
            if tz_off_sec is None:
                region = _region_zone(zone)
                if region is None:
                    return None

    if region is not None:
        try:
            naive = _dt.datetime(y, m, d, hour, minute, sec)
        except ValueError:
            return None  # region-zone resolution needs a python datetime
        epoch_s = naive.replace(tzinfo=region).timestamp()
        return int(round(epoch_s)) * 1_000_000 + micros
    # fixed offsets: pure integer arithmetic, valid for any proleptic year
    epoch_s = (
        _days_from_civil(y, m, d) * 86400
        + hour * 3600
        + minute * 60
        + sec
        - (tz_off_sec or 0)
    )
    return epoch_s * 1_000_000 + micros


# ---------------------------------------------------------------------------
# X -> string: Java/Spark display formatting
# ---------------------------------------------------------------------------


def _java_fp_str(x: float, single: bool) -> str:
    """Java Float/Double.toString: shortest round-trip digits, plain decimal
    in [1e-3, 1e7), otherwise `d.dddE±x` scientific (no '+' on exponents)."""
    if np.isnan(x):
        return "NaN"
    if np.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == 0.0:
        return "-0.0" if np.signbit(x) else "0.0"
    neg = x < 0
    m = -x if neg else x
    # shortest round-trip digits for the width (numpy dragon4, unique=True)
    s = np.format_float_scientific(np.float32(m) if single else np.float64(m), trim="-")
    mant, _, e = s.partition("e")
    exp = int(e)
    digits = mant.replace(".", "").rstrip("0") or "0"
    out: str
    if -3 <= exp < 7:
        if exp >= 0:
            ip = digits[: exp + 1].ljust(exp + 1, "0")
            fp = digits[exp + 1 :] or "0"
            out = f"{ip}.{fp}"
        else:
            out = "0." + "0" * (-exp - 1) + digits
    else:
        fp = digits[1:] or "0"
        out = f"{digits[0]}.{fp}E{exp}"
    return ("-" + out) if neg else out


def _java_bigdecimal_str(unscaled: int, scale: int) -> str:
    """Java BigDecimal.toString: plain notation unless scale < 0 or the
    adjusted exponent < -6, then scientific."""
    neg = unscaled < 0
    digs = str(-unscaled if neg else unscaled)
    adjusted = (len(digs) - 1) - scale
    if scale >= 0 and adjusted >= -6:
        if scale == 0:
            out = digs
        elif len(digs) > scale:
            out = f"{digs[:-scale]}.{digs[-scale:]}"
        else:
            out = "0." + digs.rjust(scale, "0")
    else:
        if len(digs) == 1:
            out = f"{digs}E{'+' if adjusted > 0 else ''}{adjusted}"
        else:
            out = f"{digs[0]}.{digs[1:]}E{'+' if adjusted > 0 else ''}{adjusted}"
    return ("-" + out) if neg else out


def _timestamp_str(us: int) -> str:
    """Spark timestampToString: 'yyyy-MM-dd HH:mm:ss[.f]' with the fraction's
    trailing zeros trimmed and no trailing dot."""
    sec, frac = divmod(int(us), 1_000_000)  # divmod floors: frac >= 0
    days, sod = divmod(sec, 86400)
    h, rem = divmod(sod, 3600)
    mi, s = divmod(rem, 60)
    base = f"{_date_str(days)} {h:02d}:{mi:02d}:{s:02d}"
    if frac:
        base += ("." + f"{frac:06d}").rstrip("0")
    return base


def _to_physical(v, dtype: T.DataType):
    """Normalize a host-object scalar (what pa.Array.to_pylist yields inside
    nested dictionary entries: datetime.date/datetime, Decimal) to this
    engine's physical scalar (int days / int micros / unscaled int)."""
    k = dtype.kind
    if k == T.TypeKind.DATE32 and isinstance(v, _dt.date) and not isinstance(v, _dt.datetime):
        return (v - _EPOCH).days
    if k == T.TypeKind.TIMESTAMP and isinstance(v, _dt.datetime):
        if v.tzinfo is not None:
            v = v.astimezone(_dt.timezone.utc).replace(tzinfo=None)
        days = _days_from_civil(v.year, v.month, v.day)
        return (days * 86400 + v.hour * 3600 + v.minute * 60 + v.second) * 1_000_000 + v.microsecond
    if (
        k == T.TypeKind.DECIMAL
        and not dtype.is_wide_decimal
        and isinstance(v, _pydec.Decimal)
    ):
        return T.unscaled_int(v, dtype.scale)
    return v


def _from_physical(v, dtype: T.DataType):
    """Physical scalar -> arrow-compatible value for pa.array embedding.
    Decimals must become Decimal objects (pa would read a raw int as the
    WHOLE value, not the unscaled integer); date32/timestamp stay as raw
    ints — pa.array accepts them directly, and this sidesteps python
    datetime's year 1..9999 cap for values the lenient parser accepts."""
    if v is None:
        return None
    if dtype.kind == T.TypeKind.DECIMAL and isinstance(v, (int, np.integer)):
        return T.decimal_from_unscaled(int(v), dtype.scale)
    return v


def format_scalar(v, dtype: T.DataType) -> str | None:
    """Spark CAST(x AS STRING) display text for one non-NULL python scalar."""
    if v is None:
        return None
    v = _to_physical(v, dtype)
    k = dtype.kind
    if k == T.TypeKind.BOOL:
        return "true" if v else "false"
    if dtype.is_integer:
        return str(int(v))
    if k == T.TypeKind.FLOAT32:
        return _java_fp_str(float(v), single=True)
    if k == T.TypeKind.FLOAT64:
        return _java_fp_str(float(v), single=False)
    if k == T.TypeKind.DECIMAL:
        if isinstance(v, _pydec.Decimal):  # wide decimal: dictionary value
            return _java_bigdecimal_str(T.unscaled_int(v, dtype.scale), dtype.scale)
        return _java_bigdecimal_str(int(v), dtype.scale)
    if k == T.TypeKind.DATE32:
        return _date_str(int(v))
    if k == T.TypeKind.TIMESTAMP:
        return _timestamp_str(int(v))
    if k in (T.TypeKind.STRING, T.TypeKind.BINARY):
        return v if isinstance(v, str) else bytes(v).decode("utf-8", "replace")
    if k == T.TypeKind.LIST:
        el = dtype.inner[0]
        items = ["null" if e is None else format_scalar(e, el) for e in v]
        return "[" + ", ".join(items) + "]"
    if k == T.TypeKind.MAP:
        kt, vt = dtype.inner
        pairs = v.items() if isinstance(v, dict) else v
        parts = [
            f"{'null' if a is None else format_scalar(a, kt)} ->"
            f" {'null' if b is None else format_scalar(b, vt)}"
            for a, b in pairs
        ]
        return "{" + ", ".join(parts) + "}"
    if k == T.TypeKind.STRUCT:
        vals = [v.get(n) for n in dtype.struct_names] if isinstance(v, dict) else list(v)
        parts = [
            "null" if e is None else format_scalar(e, t)
            for e, t in zip(vals, dtype.inner)
        ]
        return "{" + ", ".join(parts) + "}"
    raise TypeError(f"format_scalar: {dtype}")


# ---------------------------------------------------------------------------
# host-side scalar cast; mirrors the device semantics
# ---------------------------------------------------------------------------


def cast_scalar(v, src: T.DataType, dst: T.DataType):
    """Spark-cast one python scalar; the converted value or None (invalid ->
    NULL, as the non-ANSI device casts)."""
    if v is None or src.kind == T.TypeKind.NULL:
        return None
    if src == dst:
        return v
    v = _to_physical(v, src)
    sk, dk = src.kind, dst.kind
    if dk == T.TypeKind.BINARY:
        # Spark: only string and integral sources; int -> big-endian bytes
        if sk == T.TypeKind.STRING:
            return v.encode() if isinstance(v, str) else bytes(v)
        if src.is_integer:
            width = {T.TypeKind.INT8: 1, T.TypeKind.INT16: 2, T.TypeKind.INT32: 4,
                     T.TypeKind.INT64: 8}[sk]
            return int(v).to_bytes(width, "big", signed=True)
        return None
    if dk == T.TypeKind.STRING:
        return format_scalar(v, src)
    # nested -> nested of the same shape (reference ``exprs/cast.py:653-673``)
    if sk == T.TypeKind.LIST and dk == T.TypeKind.LIST:
        return [cast_scalar(e, src.inner[0], dst.inner[0]) for e in v]
    if sk == T.TypeKind.MAP and dk == T.TypeKind.MAP:
        out = []
        for a, b in (v.items() if isinstance(v, dict) else v):
            ck = cast_scalar(a, src.inner[0], dst.inner[0])
            if ck is None:
                return None  # a map key cannot be NULL
            out.append((ck, cast_scalar(b, src.inner[1], dst.inner[1])))
        return out
    if sk == T.TypeKind.STRUCT and dk == T.TypeKind.STRUCT:
        vals = [v.get(n) for n in src.struct_names] if isinstance(v, dict) else list(v)
        if len(vals) != len(dst.inner):
            return None
        return {n: cast_scalar(e, st, dt_)
                for n, e, st, dt_ in zip(dst.struct_names, vals, src.inner, dst.inner)}

    if sk in (T.TypeKind.STRING, T.TypeKind.BINARY):
        s = v if isinstance(v, str) else v.decode("utf-8", "replace")
        if dst.is_wide_decimal:
            # parse exactly (the vocabulary kernel's int64 bound does not apply)
            try:
                with _pydec.localcontext() as hp:
                    hp.prec = 100
                    u = int(_pydec.Decimal(s.strip()).scaleb(dst.scale).quantize(
                        _pydec.Decimal(1), rounding=_pydec.ROUND_HALF_UP))
            except (ValueError, ArithmeticError):
                return None
            if not _fits_precision(u, dst.precision):
                return None
            return T.decimal_from_unscaled(u, dst.scale)
        one = np.empty(1, dtype=object)
        one[0] = s
        vals, ok = cast_string_dict(one, dst)
        if not ok[0]:
            return None
        out = vals[0]
        return _from_physical(out.item() if hasattr(out, "item") else out, dst)
    if src.is_wide_decimal:
        u = T.unscaled_int(v, src.scale) if isinstance(v, _pydec.Decimal) else int(v)
        if dst.kind == T.TypeKind.DECIMAL:
            scaled = _rescale_int(u, src.scale, dst.scale)
            if scaled is None or not _fits_precision(scaled, dst.precision):
                return None
            if not dst.is_wide_decimal and not -(2**63) <= scaled < 2**63:
                return None
            return T.decimal_from_unscaled(scaled, dst.scale)
        if dst.is_integer:
            q = u // (10**src.scale) if src.scale else u
            if u < 0 and src.scale and u % (10**src.scale):
                q += 1  # truncate toward zero
            lo, hi = _INT_BOUNDS[dk]
            return q if lo <= q <= hi else None
        if dst.is_float:
            return float(T.decimal_from_unscaled(u, src.scale))
        if dk == T.TypeKind.BOOL:
            return u != 0
        return None
    if dst.is_wide_decimal:
        # the unscaled target integer, exactly, per source kind
        if sk == T.TypeKind.BOOL:
            u = (1 if v else 0) * 10**dst.scale
        elif src.is_integer:
            u = int(v) * 10**dst.scale
        elif src.is_float:
            try:
                with _pydec.localcontext() as hp:
                    hp.prec = 60
                    u = int(_pydec.Decimal(repr(float(v))).scaleb(dst.scale).quantize(
                        _pydec.Decimal(1), rounding=_pydec.ROUND_HALF_UP))
            except (ValueError, ArithmeticError):
                return None  # NaN / Infinity
        elif sk == T.TypeKind.DECIMAL:  # narrow: v is the unscaled int
            u = _rescale_int(int(v), src.scale, dst.scale)
        elif sk == T.TypeKind.TIMESTAMP:  # Spark: seconds
            u = (int(v) // 1_000_000) * 10**dst.scale
        else:
            return None
        if u is None or not _fits_precision(u, dst.precision):
            return None
        return T.decimal_from_unscaled(u, dst.scale)
    va = torch.from_numpy(np.array([v], dtype=src.numpy_dtype()))
    out_v, out_ok = cast_values(va, torch.ones(1, dtype=torch.bool), src, dst)
    if not bool(out_ok[0]):
        return None
    o = out_v.numpy()[0]
    return bool(o) if dk == T.TypeKind.BOOL else _from_physical(o.item(), dst)


def _rescale_int(u: int, s_from: int, s_to: int) -> int | None:
    if s_to >= s_from:
        return u * 10 ** (s_to - s_from)
    q, r = divmod(abs(u), 10 ** (s_from - s_to))
    if 2 * r >= 10 ** (s_from - s_to):
        q += 1  # HALF_UP
    return -q if u < 0 else q


def _fits_precision(u: int, precision: int) -> bool:
    return abs(u) < 10**precision


def can_cast(src: T.DataType, dst: T.DataType) -> bool:
    """Static Spark ``Cast.canCast`` over the types this engine carries."""
    if src == dst or src.kind == T.TypeKind.NULL:
        return True
    if dst.kind == T.TypeKind.STRING:
        return True
    if dst.kind == T.TypeKind.BINARY:
        return src.is_string_like or src.is_integer
    sk, dk = src.kind, dst.kind
    if sk == T.TypeKind.LIST and dk == T.TypeKind.LIST:
        return can_cast(src.inner[0], dst.inner[0])
    if sk == T.TypeKind.MAP and dk == T.TypeKind.MAP:
        return can_cast(src.inner[0], dst.inner[0]) and can_cast(src.inner[1], dst.inner[1])
    if sk == T.TypeKind.STRUCT and dk == T.TypeKind.STRUCT:
        return len(src.inner) == len(dst.inner) and all(
            can_cast(a, b) for a, b in zip(src.inner, dst.inner))
    if sk in _NESTED or dk in _NESTED:
        return False
    return True  # the primitive lattice: everything else is castable in Spark
