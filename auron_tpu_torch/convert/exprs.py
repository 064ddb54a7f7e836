"""Host expression -> engine IR conversion with UDF-fallback wrapping (port
of ``auron_tpu/convert/exprs.py``).

Every host expression either translates to a native ``ir.Expr``, or — when
``udf.fallback.enable`` is on and the host registered the function — is
wrapped as a ``HostUDF`` evaluated through the bridge callback. Otherwise
the failure propagates and marks the owning operator unconvertible.
"""

from __future__ import annotations

import base64
import decimal as pydec

from auron_tpu_torch import types as T
from auron_tpu_torch.convert.hostplan import parse_type
from auron_tpu_torch.exprs import cast as cast_kernels
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.functions import registry  # loads the full function registry
from auron_tpu_torch.ops.sortkeys import SortSpec
from auron_tpu_torch.utils.config import UDF_FALLBACK_ENABLE, Configuration


class UnsupportedExpr(Exception):
    pass


_BINOPS = {
    "add": "add", "subtract": "sub", "multiply": "mul", "divide": "div",
    "remainder": "mod", "pmod": "mod",
    "equalto": "eq", "lessthan": "lt", "lessthanorequal": "lteq",
    "greaterthan": "gt", "greaterthanorequal": "gteq",
    "and": "and", "or": "or",
}

# host expression names -> engine scalar function names (identity unless
# listed); anything the function registry knows converts directly
_FN_RENAME = {
    "stringtrim": "trim",
    "stringtrimleft": "ltrim",
    "stringtrimright": "rtrim",
    "lower": "lower",
    "upper": "upper",
    "dateadd": "date_add",
    "datesub": "date_sub",
    "dayofmonth": "day",
    "createarray": "make_array",
    "makearray": "make_array",
    "createnamedstruct": "named_struct",
}


def convert_expr(e: dict, conf: Configuration, udf_registry: dict | None = None) -> ir.Expr:
    """Convert one host expression dict; raises UnsupportedExpr on failure
    (the caller decides whole-node fallback or HostUDF wrapping). A
    malformed payload (a missing key) degrades to UnsupportedExpr, so the
    owning operator falls back instead of failing the conversion."""
    try:
        return _convert_expr(e, conf, udf_registry)
    except UnsupportedExpr:
        raise
    except (KeyError, TypeError, ValueError) as err:
        raise UnsupportedExpr(f"malformed host expression {e!r}: {err}") from err


def _known_function(name: str) -> bool:
    return registry.lookup(name) is not None


def _convert_expr(e: dict, conf: Configuration, udf_registry: dict | None = None) -> ir.Expr:
    kind = e.get("kind")
    if kind == "attr":
        idx = int(e["index"])
        if idx < 0:
            raise UnsupportedExpr("unbound attribute (host serializer could not resolve it)")
        return ir.Column(idx, e.get("name", ""))
    if kind == "lit":
        dt = parse_type(e.get("type", "null"))
        v = e.get("value")
        if dt.kind == T.TypeKind.BINARY and isinstance(v, str):
            v = base64.b64decode(v)  # the serializer ships bytes as base64
        return ir.Literal(v, dt)
    if kind != "call":
        raise UnsupportedExpr(f"unknown expression kind {kind!r}")

    name = e["name"].lower()
    kids = e.get("children", [])

    def sub(i):
        return convert_expr(kids[i], conf, udf_registry)

    def subs():
        return [convert_expr(k, conf, udf_registry) for k in kids]

    if name in _BINOPS:
        return ir.BinaryOp(_BINOPS[name], sub(0), sub(1))
    if name == "not":
        return ir.Not(sub(0))
    if name == "isnull":
        return ir.IsNull(sub(0))
    if name == "isnotnull":
        return ir.IsNotNull(sub(0))
    if name == "cast":
        child = sub(0)
        to = parse_type(e["to"])
        # the serializer ships the source type ("from"); without it the only
        # statically-known source is a literal child
        src = parse_type(e["from"]) if "from" in e else getattr(child, "dtype", None)
        if src is not None and not cast_kernels.can_cast(src, to):
            raise UnsupportedExpr(f"cast {src} -> {to} is not castable")
        return ir.Cast(child, to, bool(e.get("try", False)))
    if name == "if":
        return ir.If(sub(0), sub(1), sub(2))
    if name == "casewhen":
        # "branches" is required: a generic name + children serialization of
        # CaseWhen would otherwise become a silent all-NULL expression
        branches = tuple((convert_expr(w, conf, udf_registry), convert_expr(t, conf, udf_registry))
                         for w, t in e["branches"])
        orelse = convert_expr(e["else"], conf, udf_registry) if e.get("else") else None
        return ir.Case(branches, orelse)
    if name == "in":
        # "values" is required (a missing key would become an empty IN list
        # matching nothing); "value_type" coerces the items to typed scalars
        items = tuple(e["values"])
        vt = e.get("value_type")
        if vt:
            items = tuple(None if v is None else _coerce_literal(v, parse_type(vt))
                          for v in items)
        return ir.In(sub(0), items, bool(e.get("negated")))
    if name == "coalesce":
        return ir.Coalesce(tuple(subs()))
    if name == "like":
        return ir.Like(sub(0), e["pattern"], bool(e.get("negated")), e.get("escape", "\\"))
    if name == "sparkpartitionid":
        return ir.SparkPartitionId()
    if name == "monotonicallyincreasingid":
        return ir.MonotonicId()
    if name == "scalarsubquery":
        return ir.ScalarSubquery(e["resource_id"], parse_type(e["type"]))

    if name == "__hive_udf__":
        # a Hive UDF whose serialized function rides in the plan, evaluated
        # through the bridge's callback; gated by the UDF fallback flag
        if not conf.get(UDF_FALLBACK_ENABLE):
            raise UnsupportedExpr("hive UDF with udf.fallback.enable off")
        out_t = parse_type(e.get("type", "string"))
        return ir.HostUDF(f"__hive:{e['udf_blob']}", tuple(subs()), out_t)

    fn = _FN_RENAME.get(name, name)
    if _known_function(fn):
        return ir.ScalarFunc(fn, tuple(subs()))

    # ---- host-UDF fallback (SparkUDFWrapper analog) ----
    if udf_registry is not None and name in udf_registry and conf.get(UDF_FALLBACK_ENABLE):
        out_t = parse_type(e.get("type", "string"))
        return ir.HostUDF(name, tuple(subs()), out_t)
    raise UnsupportedExpr(f"expression {e['name']!r} is not supported")


def _coerce_literal(v, dt: T.DataType):
    """A JSON IN-list item as the serializer's declared literal type:
    strings stay plain strings (the string IN path compares vocabulary
    entries); numeric, temporal and decimal items become typed Literals, so
    the comparison runs in value space."""
    k = dt.kind
    if k == T.TypeKind.STRING:
        return v
    if k == T.TypeKind.BINARY:
        return base64.b64decode(v) if isinstance(v, str) else v
    if k == T.TypeKind.BOOL:
        return ir.Literal(bool(v), dt)
    if k == T.TypeKind.DECIMAL:
        return ir.Literal(pydec.Decimal(str(v)), dt)
    if dt.is_integer or k in (T.TypeKind.DATE32, T.TypeKind.TIMESTAMP):
        return ir.Literal(int(v), dt)
    if k in (T.TypeKind.FLOAT32, T.TypeKind.FLOAT64):
        return ir.Literal(float(v), dt)
    return v


def convert_sort_fields(fields: list[dict], conf: Configuration, udf_registry=None):
    return [(convert_expr(f["expr"], conf, udf_registry),
             SortSpec(asc=bool(f.get("asc", True)),
                      nulls_first=bool(f.get("nulls_first", f.get("asc", True)))))
            for f in fields]
