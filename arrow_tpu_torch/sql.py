"""A SQL frontend over the plan layer (counterpart of ``arrow_tpu/sql.py``).

The reference routes SQL through Substrait (engine/substrait/serde.h) from
external frontends; this module translates the analytic subset the engine
executes natively into a ``Declaration`` over host Tables:

  SELECT <exprs> FROM <table> [alias]
  [[INNER|LEFT|RIGHT|FULL [OUTER]|SEMI|ANTI] JOIN <table> [alias]
   ON a = b [AND c = d]...]...
  [WHERE <pred>] [GROUP BY <cols>] [HAVING <pred>]
  [ORDER BY <col> [ASC|DESC], ...] [LIMIT n [OFFSET m]]

Aggregates: sum/min/max/avg/mean/count(*)/count(x)/count(distinct x),
over arbitrary expressions (pre-projected automatically); HAVING may
reference aggregates. Expressions: arithmetic, comparison, AND/OR/NOT,
IN (...), BETWEEN, LIKE, IS [NOT] NULL, CASE WHEN..THEN..ELSE..END,
EXTRACT(year|month|day FROM x), substring(x FROM i FOR n), literals
(numbers, 'strings', DATE 'YYYY-MM-DD' [± INTERVAL 'n' unit, folded at
parse time]). SEMI/ANTI JOIN are dialect extensions standing in for
EXISTS/NOT EXISTS.

As in the reference, a join keeps the left side's key columns and drops
the right side's (``right_output``), so a later join must name a key that
a table already joined holds: TPC-H Q3 is written lineitem first (``FROM
lineitem JOIN orders ON l_orderkey = o_orderkey JOIN customer ON o_custkey
= c_custkey``). ``WHERE`` applies above the joins.

``declaration(sql, tables)`` parses (host work only); ``query(sql, tables,
device=None)`` runs it on ``device``, the card unless ``device="cpu"``.
"""

from __future__ import annotations

import datetime
import re
from typing import Dict, List, Tuple

from . import acero
from .acero import Declaration, Expression, field
from .table import Table

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.\d+|\d+)|(?P<str>'(?:[^']|'')*')"
    r"|(?P<id>[A-Za-z_][A-Za-z_0-9\.]*)"
    r"|(?P<op><=|>=|<>|!=|=|<|>|\(|\)|,|\*|\+|-|/|%))")

_KEYWORDS = {"select", "from", "where", "group", "by", "order", "limit",
             "offset", "as", "and", "or", "not", "in", "between", "like",
             "is", "null", "asc", "desc", "join", "inner", "left", "right",
             "full", "outer", "on", "distinct", "having", "date",
             "case", "when", "then", "else", "end", "extract", "interval",
             "for", "semi", "anti"}


class _Tokens:
    def __init__(self, sql: str):
        self.toks: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(sql):
            m = _TOKEN_RE.match(sql, pos)
            if not m:
                if sql[pos:].strip() == "":
                    break
                raise ValueError(f"SQL tokenize error at: {sql[pos:pos+20]!r}")
            pos = m.end()
            if m.group("num"):
                self.toks.append(("num", m.group("num")))
            elif m.group("str"):
                self.toks.append(("str",
                                  m.group("str")[1:-1].replace("''", "'")))
            elif m.group("id"):
                word = m.group("id")
                if word.lower() in _KEYWORDS:
                    self.toks.append(("kw", word.lower()))
                else:
                    self.toks.append(("id", word))
            else:
                self.toks.append(("op", m.group("op")))
        self.i = 0

    def peek(self, k=0):
        return self.toks[self.i + k] if self.i + k < len(self.toks) \
            else ("eof", "")

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def accept(self, kind, value=None):
        t = self.peek()
        if t[0] == kind and (value is None or t[1] == value):
            self.i += 1
            return t
        return None

    def expect(self, kind, value=None):
        t = self.accept(kind, value)
        if t is None:
            raise ValueError(f"SQL parse error: expected {value or kind}, "
                             f"got {self.peek()}")
        return t


_AGG_FNS = {"sum": "sum", "min": "min", "max": "max", "avg": "mean",
            "mean": "mean", "count": "count", "variance": "variance",
            "stddev": "stddev"}


class _Parser:
    def __init__(self, sql: str):
        self.t = _Tokens(sql)
        self.aggregates: List[tuple] = []
        # (column_name, Expression) pairs pre-projected before the
        # aggregate node for sum(<expr>)-style arguments
        self.agg_inputs: List[tuple] = []

    # --- expressions (precedence climbing) -----------------------------
    def parse_expr(self):
        return self._or()

    def _or(self):
        left = self._and()
        while self.t.accept("kw", "or"):
            left = Expression.call("or_kleene", left, self._and())
        return left

    def _and(self):
        left = self._not()
        while self.t.accept("kw", "and"):
            left = Expression.call("and_kleene", left, self._not())
        return left

    def _not(self):
        if self.t.accept("kw", "not"):
            return Expression.call("invert", self._not())
        return self._comparison()

    def _comparison(self):
        left = self._additive()
        t = self.t.peek()
        if t[0] == "op" and t[1] in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.t.next()
            right = self._additive()
            fn = {"=": "equal", "<>": "not_equal", "!=": "not_equal",
                  "<": "less", "<=": "less_equal", ">": "greater",
                  ">=": "greater_equal"}[t[1]]
            return Expression.call(fn, left, right)
        if self.t.accept("kw", "between"):
            lo = self._additive()
            self.t.expect("kw", "and")
            hi = self._additive()
            return Expression.call("and_kleene",
                                   Expression.call("greater_equal", left, lo),
                                   Expression.call("less_equal", left, hi))
        if self.t.accept("kw", "like"):
            pat = self.t.expect("str")[1]
            return Expression.call("match_like", left, pattern=pat)
        if self.t.accept("kw", "in"):
            self.t.expect("op", "(")
            vals = [self._literal_value()]
            while self.t.accept("op", ","):
                vals.append(self._literal_value())
            self.t.expect("op", ")")
            return left.isin(vals)
        if self.t.accept("kw", "is"):
            negate = bool(self.t.accept("kw", "not"))
            self.t.expect("kw", "null")
            e = left.is_null()
            return Expression.call("invert", e) if negate else e
        return left

    def _additive(self):
        left = self._mult()
        while True:
            t = self.t.peek()
            if t == ("op", "+"):
                self.t.next()
                left = Expression.call("add", left, self._mult())
            elif t == ("op", "-"):
                self.t.next()
                left = Expression.call("subtract", left, self._mult())
            else:
                return left

    def _mult(self):
        left = self._unary()
        while True:
            t = self.t.peek()
            if t == ("op", "*"):
                self.t.next()
                left = Expression.call("multiply", left, self._unary())
            elif t == ("op", "/"):
                self.t.next()
                left = Expression.call("divide", left, self._unary())
            else:
                return left

    def _unary(self):
        if self.t.accept("op", "-"):
            return Expression.call("negate", self._unary())
        return self._primary()

    def _literal_value(self):
        t = self.t.next()
        if t[0] == "num":
            return float(t[1]) if "." in t[1] else int(t[1])
        if t[0] == "str":
            return t[1]
        raise ValueError(f"expected literal, got {t}")

    def _primary(self):
        t = self.t.peek()
        if t == ("op", "("):
            self.t.next()
            e = self.parse_expr()
            self.t.expect("op", ")")
            return e
        if t[0] == "num" or t[0] == "str":
            return Expression.literal(self._literal_value())
        if t == ("kw", "date"):
            self.t.next()
            s = self.t.expect("str")[1]
            d = datetime.date.fromisoformat(s)
            # fold `DATE '...' [+|-] INTERVAL 'n' unit` chains at parse
            # time (calendar arithmetic has no device analogue)
            while True:
                nxt, after = self.t.peek(), self.t.peek(1)
                if nxt[0] == "op" and nxt[1] in ("+", "-") and \
                        after == ("kw", "interval"):
                    self.t.next()
                    self.t.next()
                    n = int(self.t.expect("str")[1])
                    unit = self.t.next()[1].lower().rstrip("s")
                    if nxt[1] == "-":
                        n = -n
                    if unit == "day":
                        d = d + datetime.timedelta(days=n)
                    elif unit == "month":
                        m = d.month - 1 + n
                        d = d.replace(year=d.year + m // 12,
                                      month=m % 12 + 1)
                    elif unit == "year":
                        d = d.replace(year=d.year + n)
                    else:
                        raise ValueError(f"unknown interval unit {unit!r}")
                else:
                    break
            return Expression.literal(
                (d - datetime.date(1970, 1, 1)).days)
        if t == ("kw", "case"):
            self.t.next()
            branches = []
            while self.t.accept("kw", "when"):
                cond = self.parse_expr()
                self.t.expect("kw", "then")
                branches.append((cond, self.parse_expr()))
            if not self.t.accept("kw", "else"):
                raise ValueError("CASE requires an ELSE branch")
            out = self.parse_expr()
            self.t.expect("kw", "end")
            for cond, val in reversed(branches):
                out = Expression.call("if_else", cond, val, out)
            return out
        if t == ("kw", "extract"):
            self.t.next()
            self.t.expect("op", "(")
            part = self.t.next()[1].lower()
            self.t.expect("kw", "from")
            e = self.parse_expr()
            self.t.expect("op", ")")
            return Expression.call(part, e)
        if t[0] == "id":
            name = self.t.next()[1]
            if self.t.peek() == ("op", "("):  # function call
                self.t.next()
                fname = name.lower()
                if fname in _AGG_FNS or fname == "count":
                    return self._aggregate_call(fname)
                if fname == "substring":
                    e = self.parse_expr()
                    if self.t.accept("kw", "from"):
                        start = int(self.t.expect("num")[1])
                        self.t.expect("kw", "for")
                        count = int(self.t.expect("num")[1])
                    else:
                        self.t.expect("op", ",")
                        start = int(self.t.expect("num")[1])
                        self.t.expect("op", ",")
                        count = int(self.t.expect("num")[1])
                    self.t.expect("op", ")")
                    return Expression.call(
                        "utf8_slice_codeunits", e,
                        start=start - 1, stop=start - 1 + count)
                args = []
                if self.t.peek() != ("op", ")"):
                    args.append(self.parse_expr())
                    while self.t.accept("op", ","):
                        args.append(self.parse_expr())
                self.t.expect("op", ")")
                return Expression.call(fname, *args)
            return field(name.split(".")[-1])
        raise ValueError(f"SQL parse error at {t}")

    def _aggregate_call(self, fname):
        distinct = bool(self.t.accept("kw", "distinct"))
        if self.t.accept("op", "*"):
            self.t.expect("op", ")")
            tag = f"__agg{len(self.aggregates)}__"
            self.aggregates.append((None, "count_all", {}, tag))
            return field(tag)
        inner = self.parse_expr()
        self.t.expect("op", ")")
        fn = _AGG_FNS[fname]
        if fname == "count" and distinct:
            fn = "count_distinct"
        tag = f"__agg{len(self.aggregates)}__"
        if inner.kind == Expression.KIND_FIELD:
            target = inner.name
        else:
            # sum(<expr>): pre-project the expression to a named column
            # before the aggregate node (reference: Acero requires plain
            # FieldRef targets too; frontends insert the projection)
            target = f"__aggin{len(self.agg_inputs)}__"
            self.agg_inputs.append((target, inner))
        self.aggregates.append((target, fn, {}, tag))
        return field(tag)


def _parse_select_list(p: _Parser):
    items = []
    while True:
        if p.t.accept("op", "*"):
            items.append(("*", None))
        else:
            e = p.parse_expr()
            name = None
            if p.t.accept("kw", "as"):
                name = p.t.next()[1]
            items.append((name, e))
        if not p.t.accept("op", ","):
            return items


def query(sql: str, tables: Dict[str, Table], device=None) -> Table:
    """Execute a SQL query against named tables on ``device`` (the card
    unless ``device="cpu"``), giving a host Table."""
    return declaration(sql, tables).to_table(device=device)


def declaration(sql: str, tables: Dict[str, Table]) -> Declaration:
    """The Declaration of a SQL query against named tables (parsed on the
    host; nothing runs)."""
    p = _Parser(sql)
    p.t.expect("kw", "select")
    select_items = _parse_select_list(p)
    p.t.expect("kw", "from")
    base_name = p.t.expect("id")[1]
    if base_name not in tables:
        raise KeyError(f"unknown table {base_name!r}")
    # optional table alias (qualified refs strip to the bare column name,
    # so the alias itself only needs to be consumed)
    if not p.t.accept("kw", "as"):
        p.t.accept("id")
    else:
        p.t.expect("id")
    plan = Declaration("table_source",
                       acero.TableSourceNodeOptions(tables[base_name]))

    # joins
    while True:
        jt = None
        if p.t.accept("kw", "join") or (
                p.t.accept("kw", "inner") and p.t.expect("kw", "join")):
            jt = "inner"
        elif p.t.peek() == ("kw", "left"):
            p.t.next()
            p.t.accept("kw", "outer")
            p.t.expect("kw", "join")
            jt = "left outer"
        elif p.t.peek() == ("kw", "right"):
            p.t.next()
            p.t.accept("kw", "outer")
            p.t.expect("kw", "join")
            jt = "right outer"
        elif p.t.peek() == ("kw", "full"):
            p.t.next()
            p.t.accept("kw", "outer")
            p.t.expect("kw", "join")
            jt = "full outer"
        elif p.t.peek() == ("kw", "semi"):
            p.t.next()
            p.t.expect("kw", "join")
            jt = "left semi"
        elif p.t.peek() == ("kw", "anti"):
            p.t.next()
            p.t.expect("kw", "join")
            jt = "left anti"
        else:
            break
        rname = p.t.expect("id")[1]
        if not p.t.accept("kw", "as"):
            p.t.accept("id")
        else:
            p.t.expect("id")
        right_tbl = tables[rname]
        p.t.expect("kw", "on")
        lks, rks = [], []
        while True:
            a = p.t.expect("id")[1].split(".")[-1]
            p.t.expect("op", "=")
            b = p.t.expect("id")[1].split(".")[-1]
            # orient each equality by schema membership (the SQL text may
            # write either side first)
            if a in right_tbl.schema.names and \
                    b not in right_tbl.schema.names:
                a, b = b, a
            lks.append(a)
            rks.append(b)
            if not (p.t.peek() == ("kw", "and")
                    and p.t.peek(1)[0] == "id"
                    and p.t.peek(2) == ("op", "=")):
                break
            p.t.expect("kw", "and")
        right_output = None if jt in ("left semi", "left anti") else \
            [n for n in right_tbl.schema.names if n not in rks]
        plan = Declaration("hashjoin", acero.HashJoinNodeOptions(
            jt, left_keys=lks, right_keys=rks,
            right_output=right_output),
            inputs=[plan, Declaration(
                "table_source", acero.TableSourceNodeOptions(right_tbl))])

    where_expr = None
    if p.t.accept("kw", "where"):
        where_expr = p.parse_expr()
    group_cols: List[str] = []
    if p.t.accept("kw", "group"):
        p.t.expect("kw", "by")
        group_cols.append(p.t.expect("id")[1].split(".")[-1])
        while p.t.accept("op", ","):
            group_cols.append(p.t.expect("id")[1].split(".")[-1])
    having_expr = None
    if p.t.accept("kw", "having"):
        # parsed with the same parser: aggregate calls register extra
        # __aggN__ tags evaluated by the aggregate node, then filtered
        having_expr = p.parse_expr()
    order_keys = []
    if p.t.accept("kw", "order"):
        p.t.expect("kw", "by")
        while True:
            col = p.t.expect("id")[1].split(".")[-1]
            direction = "ascending"
            if p.t.accept("kw", "desc"):
                direction = "descending"
            else:
                p.t.accept("kw", "asc")
            order_keys.append((col, direction))
            if not p.t.accept("op", ","):
                break
    limit = offset = None
    if p.t.accept("kw", "limit"):
        limit = int(p.t.expect("num")[1])
        if p.t.accept("kw", "offset"):
            offset = int(p.t.expect("num")[1])

    decls = [plan]
    if where_expr is not None:
        decls.append(Declaration("filter",
                                 acero.FilterNodeOptions(where_expr)))

    project_decl = None
    projected_names: List[str] = []
    if p.aggregates or group_cols:
        # GROUP BY may name a select alias bound to a computed
        # expression (e.g. extract(year from d) as y ... group by y):
        # those keys are materialized by the same pre-projection that
        # feeds sum(<expr>)-style aggregate arguments
        alias_exprs = {alias: e for alias, e in select_items
                       if alias and e is not None
                       and e.kind != Expression.KIND_FIELD}
        computed_keys = [(c, alias_exprs[c]) for c in group_cols
                         if c in alias_exprs]
        if p.agg_inputs or computed_keys:
            computed_names = {c for c, _ in computed_keys}
            keep = list(dict.fromkeys(
                [c for c in group_cols if c not in computed_names]
                + [t for (t, _, _, _) in p.aggregates
                   if t and not t.startswith("__aggin")]))
            pre_exprs = [field(c) for c in keep] + \
                [e for (_, e) in computed_keys] + \
                [e for (_, e) in p.agg_inputs]
            pre_names = keep + [c for (c, _) in computed_keys] + \
                [n for (n, _) in p.agg_inputs]
            decls.append(Declaration("project", acero.ProjectNodeOptions(
                pre_exprs, pre_names)))
            # the final projection must reference the materialized key,
            # not recompute the expression over dropped inputs
            select_items = [
                (alias, field(alias) if alias in computed_names else e)
                for alias, e in select_items]
        decls.append(Declaration("aggregate", acero.AggregateNodeOptions(
            [(t, f, o or None, out) for (t, f, o, out) in p.aggregates],
            keys=group_cols)))
        if having_expr is not None:
            decls.append(Declaration(
                "filter", acero.FilterNodeOptions(having_expr)))
        projections, names = [], []
        for i, (alias, e) in enumerate(select_items):
            if alias == "*":
                raise ValueError("SELECT * with GROUP BY not supported")
            projections.append(e)
            names.append(alias or _default_name(e, i))
        project_decl = Declaration("project", acero.ProjectNodeOptions(
            projections, names))
        projected_names = names
    elif not (len(select_items) == 1 and select_items[0][0] == "*"):
        projections, names = [], []
        for i, (alias, e) in enumerate(select_items):
            if alias == "*":
                raise ValueError("mixing * with expressions unsupported")
            projections.append(e)
            names.append(alias or _default_name(e, i))
        project_decl = Declaration("project", acero.ProjectNodeOptions(
            projections, names))
        projected_names = names

    # ORDER BY may reference select aliases (sort after projection) or
    # source columns the projection drops (sort before it)
    order_decl = (Declaration("order_by",
                              acero.OrderByNodeOptions(order_keys))
                  if order_keys else None)
    if order_decl is not None and project_decl is not None and \
            not all(k in projected_names for k, _ in order_keys):
        decls.append(order_decl)
        decls.append(project_decl)
    else:
        if project_decl is not None:
            decls.append(project_decl)
        if order_decl is not None:
            decls.append(order_decl)
    if limit is not None or offset is not None:
        decls.append(Declaration("fetch", acero.FetchNodeOptions(
            offset or 0, limit if limit is not None else -1)))

    return Declaration.from_sequence(decls)


def _default_name(e: Expression, i: int) -> str:
    if e.kind == Expression.KIND_FIELD:
        return e.name
    return f"col{i}"
