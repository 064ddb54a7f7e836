"""Plan digests: canonical SQL text -> stable cache key.

The serving layer (auron_tpu/serve) keys its compiled-program cache on a
digest of the query TEXT rather than on the lowered plan: a hit skips
parse -> bind -> lower entirely, which is the point (Flare's observation
that native compilation pays only under compile-once/serve-many reuse).
Digest equality must therefore imply plan equality, so the canonical
form normalizes exactly the text features that cannot change the plan:

- whitespace and ``--`` / ``/* */`` comments (the lexer drops them);
- identifier and keyword case — identifiers resolve case-insensitively
  (``case.sensitive`` default). When a session runs case-SENSITIVE the
  cache key includes that knob's value (serve/cache.py), so the two
  regimes never share entries and uppercasing here stays safe.

Literal values stay part of the digest: the lowering bakes them into the
plan protos (filter predicates, IN lists, constant folds), so two texts
differing in a literal are genuinely different plans. The XLA-program
layer below recovers most of the sharing anyway — the fusion stage cache
keys on (schema, segment signature, capacity bucket), and a literal
changes none of them, so a cache MISS here still re-enters the same
compiled programs with zero new XLA compiles (docs/serving.md).

Determinism is load-bearing: the digest must be stable across processes
and PYTHONHASHSEED values (sha256 over the canonical byte string, no
dict iteration anywhere).

Copied from ``auron_tpu/sql/digest.py`` over the port's config options;
only the imports differ. The serving layer it names is ``serve/``.
"""

from __future__ import annotations

import hashlib

from auron_tpu_torch.sql.lexer import IDENT, STRING, tokenize
from auron_tpu_torch.utils.config import (
    CASE_SENSITIVE,
    FUSE_AGG_INPUTS,
    FUSE_ENABLE,
    FUSE_MIN_OPS,
    FUSE_PROBE,
    FUSE_SHUFFLE,
    HOST_SORT_MODE,
    SQL_SHUFFLE_PARTITIONS,
)

#: conf options whose values the parse->bind->lower pipeline reads: their
#: RESOLVED values ride the serving cache key (serve/cache.py), so a
#: session conf changing any of them can never be served a stale plan.
#: This tuple lives HERE — next to the digest whose equality contract it
#: completes — and auronlint R14 enforces it: any knob read reachable
#: from sql/lowering.py or plan/fusion.py over the call graph must be
#: listed, so forgetting to extend it when the lowering grows a knob is
#: a lint failure, not a wrong-plan cache hit in production.
PLAN_KNOBS = (
    SQL_SHUFFLE_PARTITIONS,
    CASE_SENSITIVE,
    FUSE_ENABLE,
    FUSE_MIN_OPS,
    FUSE_AGG_INPUTS,
    FUSE_PROBE,
    FUSE_SHUFFLE,
    HOST_SORT_MODE,
)


def canonical_text(sql: str, fold_ident_case: bool = True) -> str:
    """The canonical token rendering two equal-plan texts share.

    Token KIND must survive the rendering: the lexer strips string
    quotes, so rendering a STRING token bare would make ``SELECT '1'``
    and ``SELECT 1`` (or ``s = 'NAME'`` and ``s = NAME``) collide on one
    digest — two different plans sharing a cache key, the exact wrong-
    results failure this module's invariant forbids. Strings re-quote
    with ``''`` escaping (the grammar's own form, so a quoted rendering
    can never equal an identifier or number token)."""
    parts = []
    for t in tokenize(sql):
        if t.kind == "eof":
            break
        if t.kind == STRING:
            parts.append("'" + t.text.replace("'", "''") + "'")
        elif t.kind == IDENT and t.quoted:
            # quoted identifiers re-quote for the same reason strings do:
            # bare, `"a b"` would render identically to the two-token
            # `a b` (e.g. an implicit alias) — two different plans on one
            # key. The parser resolves quoted == bare otherwise, so the
            # rendered case still folds with the rest
            parts.append('"' + (t.upper if fold_ident_case else t.text)
                         + '"')
        elif fold_ident_case and t.kind == IDENT:
            parts.append(t.upper)
        else:
            parts.append(t.text)
    return " ".join(parts)


def plan_digest(sql: str, fold_ident_case: bool = True) -> str:
    """Hex digest of the canonical text (sha256, first 16 bytes — plenty
    for a cache key, short enough to read in /serve and /queries)."""
    canon = canonical_text(sql, fold_ident_case=fold_ident_case)
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()[:32]
