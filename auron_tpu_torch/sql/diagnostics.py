"""Structured SQL diagnostics with source positions.

The frontend's failure contract: any construct outside the
supported subset raises :class:`SqlUnsupported` pointing at the exact
source position — the engine NEVER silently produces a wrong plan for
SQL it only half-understands. Malformed SQL raises :class:`SqlSyntaxError`
(a different class: "we can't read this" vs "we read it and refuse it"),
and semantic errors (unknown column, ambiguous name) raise
:class:`SqlAnalysisError`. All three render ``<line>:<col>: message``
with a caret snippet, so a failing gate query is diagnosable from the
test output alone.

Copied from ``auron_tpu/sql/diagnostics.py``; only the imports differ.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SourcePos:
    """1-based line/column plus absolute offset into the query text."""

    line: int = 0
    col: int = 0
    offset: int = 0

    def __str__(self) -> str:
        return f"{self.line}:{self.col}"


NO_POS = SourcePos()


def caret_snippet(sql: str, pos: SourcePos, width: int = 72) -> str:
    """The offending source line with a caret under the position."""
    lines = sql.splitlines()
    if not (1 <= pos.line <= len(lines)):
        return ""
    line = lines[pos.line - 1]
    start = 0
    if len(line) > width:
        start = max(0, pos.col - width // 2)
        line = line[start : start + width]
    return line + "\n" + " " * max(pos.col - 1 - start, 0) + "^"


class SqlDiagnostic(Exception):
    """Base: a positioned diagnostic over one SQL text."""

    kind = "error"

    def __init__(self, message: str, pos: SourcePos = NO_POS, sql: str = ""):
        self.message = message
        self.pos = pos
        self.sql = sql
        super().__init__(self.render())

    def with_sql(self, sql: str) -> "SqlDiagnostic":
        """Re-raise helper: attach the full text once it is known."""
        return type(self)(self.message, self.pos, sql)

    def render(self) -> str:
        head = f"{self.pos}: {self.kind}: {self.message}" if self.pos.line \
            else f"{self.kind}: {self.message}"
        snip = caret_snippet(self.sql, self.pos) if self.sql else ""
        return head + ("\n" + snip if snip else "")


class SqlSyntaxError(SqlDiagnostic):
    """The text is not parseable SQL at all."""

    kind = "syntax error"


class SqlUnsupported(SqlDiagnostic):
    """Valid SQL, but outside the engine's supported subset. ``construct``
    names the offending feature (stable identifier for tests/tooling)."""

    kind = "unsupported"

    def __init__(self, construct: str, message: str = "",
                 pos: SourcePos = NO_POS, sql: str = ""):
        self.construct = construct
        full = construct + (f": {message}" if message else "")
        self._message_only = message
        super().__init__(full, pos, sql)

    def with_sql(self, sql: str) -> "SqlUnsupported":
        return SqlUnsupported(self.construct, self._message_only, self.pos, sql)


class SqlAnalysisError(SqlDiagnostic):
    """Parseable and in-subset, but names/types do not resolve."""

    kind = "analysis error"
