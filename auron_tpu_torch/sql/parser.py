"""Recursive-descent SQL parser for the supported TPC-DS subset.

Grammar (see docs/sql.md for the full reference): single-statement
queries with WITH CTEs, UNION ALL bodies, SELECT lists with aliases /
CASE / arithmetic / CAST / date+interval literals, comma or explicit
INNER/LEFT JOIN froms, WHERE with IN (list or uncorrelated subquery) /
BETWEEN / LIKE / IS NULL, GROUP BY / HAVING, ORDER BY / LIMIT.

Anything outside the subset raises :class:`SqlUnsupported` with the
construct name and source position RIGHT HERE when it is syntactically
recognizable (window OVER, ROLLUP/CUBE, set ops other than UNION ALL,
RIGHT/FULL/CROSS/NATURAL joins, EXISTS, ``||``); constructs that are
only recognizable semantically (correlated subqueries, scalar
subqueries in expressions) parse and are rejected by the binder.

Copied from ``auron_tpu/sql/parser.py``; only the imports differ.
``parse_streaming_view`` parses; nothing of the port lowers a streaming
view yet (ROADMAP item 6c).
"""

from __future__ import annotations

from auron_tpu_torch.sql import sqlast as A
from auron_tpu_torch.sql.diagnostics import SqlDiagnostic, SqlSyntaxError, SqlUnsupported
from auron_tpu_torch.sql.lexer import EOF, IDENT, NUMBER, OP, STRING, Token, tokenize

#: words that terminate an implicit alias position
_RESERVED = {
    "SELECT", "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "UNION",
    "ON", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "NATURAL",
    "AND", "OR", "NOT", "AS", "WITH", "CASE", "WHEN", "THEN", "ELSE", "END",
    "IS", "NULL", "IN", "BETWEEN", "LIKE", "ASC", "DESC", "NULLS", "FIRST",
    "LAST", "DISTINCT", "ALL", "BY", "INTERVAL", "DATE", "CAST", "EXISTS",
    "INTERSECT", "EXCEPT", "OUTER", "USING", "OVER",
}

_CMP_OPS = {"=", "<>", "!=", "<", "<=", ">", ">="}

#: normalized interval units. DAY is the batch subset; the time units
#: exist for streaming window sizes and watermark delays only — the
#: binder's date-arithmetic fold refuses them (sub-day date offsets have
#: no DATE32 lowering).
_INTERVAL_UNITS = {
    "DAY": "day", "DAYS": "day",
    "HOUR": "hour", "HOURS": "hour",
    "MINUTE": "minute", "MINUTES": "minute",
    "SECOND": "second", "SECONDS": "second",
    "MILLISECOND": "millisecond", "MILLISECONDS": "millisecond",
}


def parse(sql: str) -> A.Query:
    """Parse one SQL statement; diagnostics carry the full text."""
    try:
        return _Parser(tokenize(sql)).parse_query_top()
    except SqlDiagnostic as e:
        raise e.with_sql(sql) from None


def parse_streaming_view(sql: str) -> A.StreamingView:
    """Parse a CREATE STREAMING VIEW statement (stream subsystem front
    door)::

        CREATE STREAMING VIEW <name>
          [WATERMARK FOR <col> AS <col> - INTERVAL '<n>' <unit>]
        AS <query>

    The inner query is the ordinary grammar; window calls (TUMBLE/HOP)
    ride GROUP BY as plain function calls and are given meaning by
    stream/lowering.py.
    """
    try:
        return _Parser(tokenize(sql)).parse_streaming_view_top()
    except SqlDiagnostic as e:
        raise e.with_sql(sql) from None


class _Parser:
    def __init__(self, toks: list[Token]):
        self.toks = toks
        self.i = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != EOF:
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        return self.peek().is_kw(*kws)

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> Token:
        t = self.peek()
        if not t.is_kw(kw):
            raise SqlSyntaxError(f"expected {kw}, found {t.text!r}", t.pos)
        return self.next()

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == OP and t.text in ops

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> Token:
        t = self.peek()
        if not (t.kind == OP and t.text == op):
            raise SqlSyntaxError(f"expected {op!r}, found {t.text!r}", t.pos)
        return self.next()

    def ident(self, what: str = "identifier") -> Token:
        t = self.peek()
        if t.kind != IDENT:
            raise SqlSyntaxError(f"expected {what}, found {t.text!r}", t.pos)
        return self.next()

    # -- statements ---------------------------------------------------------

    def parse_query_top(self) -> A.Query:
        q = self.parse_query()
        self.eat_op(";")
        t = self.peek()
        if t.kind != EOF:
            raise SqlSyntaxError(f"unexpected trailing input {t.text!r}", t.pos)
        return q

    def parse_streaming_view_top(self) -> A.StreamingView:
        pos = self.peek().pos
        self.expect_kw("CREATE")
        self.expect_kw("STREAMING")
        self.expect_kw("VIEW")
        name = self.ident("view name").text
        watermark = None
        if self.eat_kw("WATERMARK"):
            wpos = self.peek().pos
            self.expect_kw("FOR")
            col = A.Ident((self.ident("watermark column").text,),
                          pos=self.peek().pos)
            self.expect_kw("AS")
            expr = self.parse_expr()
            # the only supported shape: <same col> - INTERVAL '<n>' <unit>
            if not (isinstance(expr, A.BinOp) and expr.op == "-"
                    and isinstance(expr.left, A.Ident)
                    and expr.left.parts[-1].lower() == col.parts[0].lower()
                    and isinstance(expr.right, A.IntervalLit)):
                raise SqlUnsupported(
                    "watermark expression",
                    "only <col> - INTERVAL '<n>' <unit> is supported", wpos)
            watermark = A.Watermark(col, expr.right, pos=wpos)
        self.expect_kw("AS")
        q = self.parse_query()
        self.eat_op(";")
        t = self.peek()
        if t.kind != EOF:
            raise SqlSyntaxError(f"unexpected trailing input {t.text!r}", t.pos)
        return A.StreamingView(name, watermark, q, pos=pos)

    def parse_query(self) -> A.Query:
        pos = self.peek().pos
        ctes: list[A.Cte] = []
        if self.eat_kw("WITH"):
            while True:
                cpos = self.peek().pos
                name = self.ident("CTE name").text
                self.expect_kw("AS")
                self.expect_op("(")
                body = self.parse_body()
                self.expect_op(")")
                ctes.append(A.Cte(name, body, pos=cpos))
                if not self.eat_op(","):
                    break
        body = self.parse_body()
        order_by: list[A.OrderItem] = []
        limit = None
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            order_by = self.parse_order_items()
        if self.at_kw("LIMIT"):
            self.next()
            t = self.peek()
            if t.kind != NUMBER or not t.text.isdigit():
                raise SqlSyntaxError("LIMIT expects an integer", t.pos)
            self.next()
            limit = int(t.text)
        return A.Query(body, tuple(ctes), tuple(order_by), limit, pos=pos)

    def parse_body(self):
        first = self.parse_select()
        branches = [first]
        while self.at_kw("UNION", "INTERSECT", "EXCEPT"):
            t = self.next()
            if t.is_kw("INTERSECT", "EXCEPT"):
                raise SqlUnsupported(t.text.lower(),
                                     "set operation outside the subset", t.pos)
            if not self.eat_kw("ALL"):
                raise SqlUnsupported(
                    "union distinct",
                    "only UNION ALL is supported (dedup via GROUP BY)", t.pos)
            branches.append(self.parse_select())
        if len(branches) == 1:
            return first
        return A.UnionAll(tuple(branches), pos=branches[0].pos)

    def parse_select(self) -> A.Select:
        t = self.expect_kw("SELECT")
        distinct = False
        if self.eat_kw("DISTINCT"):
            distinct = True
        else:
            self.eat_kw("ALL")
        items = [self.parse_select_item()]
        while self.eat_op(","):
            items.append(self.parse_select_item())
        from_: list[A.TableRef] = []
        where = group_by = having = None
        group_by = ()
        if self.eat_kw("FROM"):
            from_.append(self.parse_table_ref())
            while self.eat_op(","):
                from_.append(self.parse_table_ref())
        if self.eat_kw("WHERE"):
            where = self.parse_expr()
        if self.at_kw("GROUP"):
            self.next()
            self.expect_kw("BY")
            group_by = tuple(self.parse_group_list())
        if self.eat_kw("HAVING"):
            having = self.parse_expr()
        return A.Select(tuple(items), tuple(from_), where, group_by,
                        having, distinct, pos=t.pos)

    def parse_select_item(self) -> A.SelectItem:
        t = self.peek()
        if self.at_op("*"):
            raise SqlUnsupported("select *",
                                 "explicit select lists only", t.pos)
        expr = self.parse_expr()
        alias = None
        if self.eat_kw("AS"):
            alias = self.ident("alias").text
        elif self.peek().kind == IDENT and self.peek().upper not in _RESERVED:
            alias = self.next().text
        return A.SelectItem(expr, alias, pos=t.pos)

    def parse_group_list(self) -> list[A.Expr]:
        out = []
        while True:
            t = self.peek()
            if t.is_kw("ROLLUP", "CUBE", "GROUPING"):
                raise SqlUnsupported(t.text.lower(),
                                     "grouping sets outside the subset", t.pos)
            out.append(self.parse_expr())
            if not self.eat_op(","):
                return out

    def parse_order_items(self) -> list[A.OrderItem]:
        out = []
        while True:
            pos = self.peek().pos
            expr = self.parse_expr()
            asc = True
            if self.eat_kw("DESC"):
                asc = False
            else:
                self.eat_kw("ASC")
            nulls_first = None
            if self.eat_kw("NULLS"):
                t = self.next()
                if t.is_kw("FIRST"):
                    nulls_first = True
                elif t.is_kw("LAST"):
                    nulls_first = False
                else:
                    raise SqlSyntaxError("expected FIRST or LAST", t.pos)
            out.append(A.OrderItem(expr, asc, nulls_first, pos=pos))
            if not self.eat_op(","):
                return out

    # -- relations ----------------------------------------------------------

    def parse_table_ref(self) -> A.TableRef:
        ref = self.parse_primary_ref()
        while True:
            t = self.peek()
            if t.is_kw("RIGHT", "FULL"):
                raise SqlUnsupported(f"{t.text.lower()} outer join",
                                     "only INNER and LEFT joins", t.pos)
            if t.is_kw("CROSS"):
                raise SqlUnsupported("cross join",
                                     "explicit products outside the subset",
                                     t.pos)
            if t.is_kw("NATURAL"):
                raise SqlUnsupported("natural join",
                                     "spell the join keys in ON", t.pos)
            kind = None
            if t.is_kw("JOIN"):
                self.next()
                kind = "inner"
            elif t.is_kw("INNER"):
                self.next()
                self.expect_kw("JOIN")
                kind = "inner"
            elif t.is_kw("LEFT"):
                self.next()
                self.eat_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "left"
            else:
                return ref
            right = self.parse_primary_ref()
            u = self.peek()
            if u.is_kw("USING"):
                raise SqlUnsupported("join using",
                                     "spell the join keys in ON", u.pos)
            self.expect_kw("ON")
            on = self.parse_expr()
            ref = A.Join(ref, right, kind, on, pos=t.pos)

    def parse_primary_ref(self) -> A.TableRef:
        t = self.peek()
        if self.eat_op("("):
            q = self.parse_query()
            self.expect_op(")")
            self.eat_kw("AS")
            alias = self.ident("derived-table alias").text
            return A.DerivedTable(q, alias, pos=t.pos)
        name = self.ident("table name").text
        alias = None
        if self.eat_kw("AS"):
            alias = self.ident("alias").text
        elif self.peek().kind == IDENT and self.peek().upper not in _RESERVED:
            alias = self.next().text
        return A.TableName(name, alias, pos=t.pos)

    # -- expressions ---------------------------------------------------------

    def parse_expr(self) -> A.Expr:
        return self.parse_or()

    def parse_or(self) -> A.Expr:
        e = self.parse_and()
        while self.at_kw("OR"):
            t = self.next()
            e = A.BinOp("or", e, self.parse_and(), pos=t.pos)
        return e

    def parse_and(self) -> A.Expr:
        e = self.parse_not()
        while self.at_kw("AND"):
            t = self.next()
            e = A.BinOp("and", e, self.parse_not(), pos=t.pos)
        return e

    def parse_not(self) -> A.Expr:
        if self.at_kw("NOT"):
            t = self.next()
            return A.UnaryOp("not", self.parse_not(), pos=t.pos)
        return self.parse_predicate()

    def parse_predicate(self) -> A.Expr:
        e = self.parse_additive()
        t = self.peek()
        if t.kind == OP and t.text in _CMP_OPS:
            self.next()
            op = {"!=": "<>"}.get(t.text, t.text)
            return A.BinOp(op, e, self.parse_additive(), pos=t.pos)
        if t.is_kw("IS"):
            self.next()
            negated = bool(self.eat_kw("NOT"))
            self.expect_kw("NULL")
            return A.IsNullPred(e, negated, pos=t.pos)
        negated = False
        if t.is_kw("NOT"):
            nxt = self.peek(1)
            if nxt.is_kw("BETWEEN", "IN", "LIKE"):
                self.next()
                negated = True
                t = self.peek()
        if t.is_kw("BETWEEN"):
            self.next()
            lo = self.parse_additive()
            self.expect_kw("AND")
            hi = self.parse_additive()
            return A.Between(e, lo, hi, negated, pos=t.pos)
        if t.is_kw("IN"):
            self.next()
            self.expect_op("(")
            if self.at_kw("SELECT", "WITH"):
                q = self.parse_query()
                self.expect_op(")")
                return A.InSubquery(e, q, negated, pos=t.pos)
            items = [self.parse_additive()]
            while self.eat_op(","):
                items.append(self.parse_additive())
            self.expect_op(")")
            return A.InList(e, tuple(items), negated, pos=t.pos)
        if t.is_kw("LIKE"):
            self.next()
            p = self.peek()
            if p.kind != STRING:
                raise SqlSyntaxError("LIKE expects a string pattern", p.pos)
            self.next()
            return A.LikePred(e, p.text, negated, pos=t.pos)
        if negated:
            raise SqlSyntaxError("expected BETWEEN/IN/LIKE after NOT", t.pos)
        return e

    def parse_additive(self) -> A.Expr:
        e = self.parse_multiplicative()
        while self.at_op("+", "-"):
            t = self.next()
            rhs = self.parse_interval_or_mult()
            e = A.BinOp(t.text, e, rhs, pos=t.pos)
        return e

    def parse_interval_or_mult(self) -> A.Expr:
        t = self.peek()
        if t.is_kw("INTERVAL"):
            self.next()
            v = self.next()
            if v.kind not in (NUMBER, STRING) or not v.text.strip().isdigit():
                raise SqlSyntaxError("INTERVAL expects an integer", v.pos)
            u = self.ident("interval unit")
            unit = _INTERVAL_UNITS.get(u.upper)
            if unit is None:
                raise SqlUnsupported(f"interval unit {u.text}",
                                     "DAY (batch) or time units (streaming "
                                     "windows/watermarks)", u.pos)
            return A.IntervalLit(int(v.text), unit, pos=t.pos)
        # the raw dsdgen form: `date + 30 days`
        if t.kind == NUMBER and t.text.isdigit() and self.peek(1).is_kw("DAY", "DAYS"):
            self.next()
            self.next()
            return A.IntervalLit(int(t.text), "day", pos=t.pos)
        return self.parse_multiplicative()

    def parse_multiplicative(self) -> A.Expr:
        e = self.parse_unary()
        while True:
            if self.at_op("||"):
                t = self.peek()
                raise SqlUnsupported("string concatenation ||",
                                     "string functions outside the subset",
                                     t.pos)
            if not self.at_op("*", "/"):
                return e
            t = self.next()
            e = A.BinOp(t.text, e, self.parse_unary(), pos=t.pos)

    def parse_unary(self) -> A.Expr:
        if self.at_op("-", "+"):
            t = self.next()
            return A.UnaryOp(t.text, self.parse_unary(), pos=t.pos)
        return self.parse_primary()

    def parse_primary(self) -> A.Expr:
        t = self.peek()
        if t.kind == NUMBER:
            self.next()
            return A.NumberLit(t.text, pos=t.pos)
        if t.kind == STRING:
            self.next()
            return A.StringLit(t.text, pos=t.pos)
        if t.kind == OP and t.text == "(":
            self.next()
            if self.at_kw("SELECT", "WITH"):
                q = self.parse_query()
                self.expect_op(")")
                return A.ScalarSubquery(q, pos=t.pos)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind != IDENT:
            raise SqlSyntaxError(f"unexpected token {t.text!r}", t.pos)
        if t.is_kw("NULL"):
            self.next()
            return A.NullLit(pos=t.pos)
        if t.is_kw("DATE"):
            v = self.peek(1)
            if v.kind == STRING:
                self.next()
                self.next()
                return A.DateLit(v.text, pos=t.pos)
        if t.is_kw("EXISTS"):
            raise SqlUnsupported("exists subquery",
                                 "rewrite as IN / join", t.pos)
        if t.is_kw("CASE"):
            return self.parse_case()
        if t.is_kw("CAST"):
            return self.parse_cast()
        if t.is_kw("INTERVAL"):
            return self.parse_interval_or_mult()
        # function call or (qualified) identifier
        if self.peek(1).kind == OP and self.peek(1).text == "(":
            return self.parse_func_call()
        self.next()
        parts = [t.text]
        while self.at_op(".") and self.peek(1).kind == IDENT:
            self.next()
            parts.append(self.next().text)
        return A.Ident(tuple(parts), pos=t.pos)

    def parse_func_call(self) -> A.Expr:
        t = self.next()
        name = t.text.lower()
        self.expect_op("(")
        star = False
        distinct = False
        args: list[A.Expr] = []
        if self.at_op("*"):
            self.next()
            star = True
        elif not self.at_op(")"):
            distinct = bool(self.eat_kw("DISTINCT"))
            args.append(self.parse_expr())
            while self.eat_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        o = self.peek()
        if o.is_kw("OVER"):
            raise SqlUnsupported("window function",
                                 f"{name}(...) OVER (...)", o.pos)
        return A.FuncCall(name, tuple(args), distinct, star, pos=t.pos)

    def parse_case(self) -> A.Expr:
        t = self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        whens = []
        while self.eat_kw("WHEN"):
            c = self.parse_expr()
            self.expect_kw("THEN")
            v = self.parse_expr()
            whens.append((c, v))
        if not whens:
            raise SqlSyntaxError("CASE needs at least one WHEN", t.pos)
        orelse = None
        if self.eat_kw("ELSE"):
            orelse = self.parse_expr()
        self.expect_kw("END")
        return A.CaseExpr(operand, tuple(whens), orelse, pos=t.pos)

    def parse_cast(self) -> A.Expr:
        t = self.expect_kw("CAST")
        self.expect_op("(")
        e = self.parse_expr()
        self.expect_kw("AS")
        tn = self.parse_type_name()
        self.expect_op(")")
        return A.Cast(e, tn, pos=t.pos)

    def parse_type_name(self) -> A.TypeName:
        t = self.ident("type name")
        name = t.text.lower()
        params: list[int] = []
        if self.eat_op("("):
            while True:
                v = self.peek()
                if v.kind != NUMBER or not v.text.isdigit():
                    raise SqlSyntaxError("type parameter must be an integer",
                                         v.pos)
                self.next()
                params.append(int(v.text))
                if not self.eat_op(","):
                    break
            self.expect_op(")")
        return A.TypeName(name, tuple(params), pos=t.pos)
