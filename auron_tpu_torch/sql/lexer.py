"""SQL lexer: text -> positioned token stream.

Hand-rolled (no new deps), mirroring the token surface the TPC-DS query
corpus actually uses: identifiers, quoted identifiers, integer/decimal
numbers, single-quoted strings with '' escaping, the operator/punct set
of the supported grammar, and ``--``/``/* */`` comments. Every token
carries a :class:`SourcePos` so parser/binder diagnostics point at real
source locations.

Copied from ``auron_tpu/sql/lexer.py``; only the imports differ.
"""

from __future__ import annotations

from dataclasses import dataclass

from auron_tpu_torch.sql.diagnostics import SourcePos, SqlSyntaxError

# token kinds
IDENT = "ident"
NUMBER = "number"
STRING = "string"
OP = "op"
EOF = "eof"

#: multi-char operators first so maximal munch wins
_OPS = ("<>", "!=", "<=", ">=", "||", "(", ")", ",", ".", "+", "-", "*", "/",
        "=", "<", ">", ";")


@dataclass(frozen=True)
class Token:
    kind: str
    text: str          # raw text (identifiers keep original case)
    pos: SourcePos
    #: True for a double-quoted identifier. The parser treats quoted and
    #: bare identifiers identically (the quotes are stripped here), but
    #: the plan-digest canonicalizer (sql/digest.py) must re-quote them:
    #: rendered bare, `"a b"` would collide with the two-token `a b`
    quoted: bool = False

    @property
    def upper(self) -> str:
        return self.text.upper()

    def is_kw(self, *kws: str) -> bool:
        return self.kind == IDENT and self.upper in kws

    def __repr__(self) -> str:
        return f"<{self.kind} {self.text!r} @{self.pos}>"


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, line, col = 0, 1, 1
    n = len(sql)

    def pos() -> SourcePos:
        return SourcePos(line, col, i)

    def advance(k: int) -> None:
        nonlocal i, line, col
        for _ in range(k):
            if i < n and sql[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            advance(1)
            continue
        if c == "-" and sql[i : i + 2] == "--":
            while i < n and sql[i] != "\n":
                advance(1)
            continue
        if c == "/" and sql[i : i + 2] == "/*":
            p = pos()
            end = sql.find("*/", i + 2)
            if end < 0:
                raise SqlSyntaxError("unterminated block comment", p, sql)
            advance(end + 2 - i)
            continue
        if c == "'":
            p = pos()
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlSyntaxError("unterminated string literal", p, sql)
                if sql[j] == "'":
                    if sql[j + 1 : j + 2] == "'":  # '' escape
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            toks.append(Token(STRING, "".join(buf), p))
            advance(j + 1 - i)
            continue
        if c == '"':
            p = pos()
            end = sql.find('"', i + 1)
            if end < 0:
                raise SqlSyntaxError("unterminated quoted identifier", p, sql)
            toks.append(Token(IDENT, sql[i + 1 : end], p, quoted=True))
            advance(end + 1 - i)
            continue
        if c.isdigit() or (c == "." and sql[i + 1 : i + 2].isdigit()):
            p = pos()
            j = i
            seen_dot = False
            while j < n and (sql[j].isdigit() or (sql[j] == "." and not seen_dot)):
                if sql[j] == ".":
                    # "1.." would be a range typo; also stop on "1.e" never
                    if not sql[j + 1 : j + 2].isdigit():
                        break
                    seen_dot = True
                j += 1
            if j < n and sql[j] in "eE":
                k = j + 1
                if k < n and sql[k] in "+-":
                    k += 1
                if k < n and sql[k].isdigit():
                    while k < n and sql[k].isdigit():
                        k += 1
                    j = k
            toks.append(Token(NUMBER, sql[i:j], p))
            advance(j - i)
            continue
        if c.isalpha() or c == "_":
            p = pos()
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            toks.append(Token(IDENT, sql[i:j], p))
            advance(j - i)
            continue
        matched = False
        for op in _OPS:
            if sql.startswith(op, i):
                toks.append(Token(OP, op, pos()))
                advance(len(op))
                matched = True
                break
        if not matched:
            raise SqlSyntaxError(f"unexpected character {c!r}", pos(), sql)
    toks.append(Token(EOF, "", pos()))
    return toks
