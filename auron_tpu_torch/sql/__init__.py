"""SQL frontend: real query text -> protobuf plans for the engine.

Pipeline: :func:`~auron_tpu_torch.sql.parser.parse` (lexer + recursive-descent
parser, sql/parser.py) -> :mod:`~auron_tpu_torch.sql.binder` (name/type
resolution over a TPC-DS catalog) -> :func:`~auron_tpu_torch.sql.lowering.lower`
(protobuf plans via plan/builders.py). Every construct outside the
supported subset raises a positioned
:class:`~auron_tpu_torch.sql.diagnostics.SqlUnsupported` — the frontend never
emits a silently wrong plan. See docs/sql.md for the grammar and the
lowering rules.
"""

from auron_tpu_torch.sql.catalog import Catalog, build_tables, tpcds_catalog
from auron_tpu_torch.sql.diagnostics import (
    SqlAnalysisError,
    SqlDiagnostic,
    SqlSyntaxError,
    SqlUnsupported,
)
from auron_tpu_torch.sql.lowering import LoweredQuery, lower
from auron_tpu_torch.sql.parser import parse

__all__ = [
    "Catalog",
    "LoweredQuery",
    "SqlAnalysisError",
    "SqlDiagnostic",
    "SqlSyntaxError",
    "SqlUnsupported",
    "build_tables",
    "compile_text",
    "lower",
    "parse",
    "tpcds_catalog",
]


def compile_text(sql: str, catalog: Catalog | None = None,
                 n_parts: int = 2) -> LoweredQuery:
    """Parse + bind + lower one SQL text. Diagnostics carry the text."""
    from auron_tpu_torch.sql.diagnostics import SqlDiagnostic as _D

    from auron_tpu_torch import obs

    cat = catalog if catalog is not None else tpcds_catalog()
    with obs.span("sql.parse", cat="sql"):
        ast = parse(sql)
    try:
        return lower(ast, cat, n_parts=n_parts)
    except _D as e:
        raise e.with_sql(sql) from None
