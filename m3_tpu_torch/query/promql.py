"""PromQL parser: lexer + Pratt parser → AST.

A copy of ``m3_tpu/query/promql.py`` (with its own ``parse_duration``, a
copy of ``m3_tpu/metrics/policy.py``'s), so the port imports nothing of the
JAX package.

Reference: M3's src/query/parser/promql/parse.go wraps the upstream
prometheus/promql parser and converts its AST into M3's transform DAG. This
framework owns the parser (no Go dependency): the grammar subset covers
vector/range selectors with matchers and offsets, all implemented functions,
aggregation operators with by/without and parameters, and binary operators
with precedence, BOOL, and on/ignoring vector matching.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

NANOS = 1_000_000_000
_UNITS = {
    "ns": 1,
    "us": 1_000,
    "µs": 1_000,
    "ms": 1_000_000,
    "s": NANOS,
    "m": 60 * NANOS,
    "h": 3600 * NANOS,
    "d": 24 * 3600 * NANOS,
}

_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h|d)")


def parse_duration(s: str) -> int:
    """Go-style duration ("10s", "1m30s", "2d") → nanos."""
    if not s:
        raise ValueError("empty duration")
    pos = 0
    total = 0
    while pos < len(s):
        m = _DUR_RE.match(s, pos)
        if not m:
            raise ValueError(f"invalid duration {s!r}")
        total += int(float(m.group(1)) * _UNITS[m.group(2)])
        pos = m.end()
    return total


# --- AST ---


@dataclass
class Expr:
    pass


@dataclass
class NumberLiteral(Expr):
    value: float


@dataclass
class StringLiteral(Expr):
    value: str


@dataclass
class Matcher:
    name: str
    op: str  # = != =~ !~
    value: str


@dataclass
class VectorSelector(Expr):
    name: str | None
    matchers: list[Matcher] = field(default_factory=list)
    offset_nanos: int = 0
    # @ modifier: absolute nanos, or "start"/"end" (resolved against the
    # query bounds at eval time)
    at_nanos: int | str | None = None


@dataclass
class RangeSelector(Expr):
    vector: VectorSelector
    range_nanos: int


@dataclass
class Call(Expr):
    func: str
    args: list[Expr]


@dataclass
class Subquery(Expr):
    """expr[range:step] — inner expr evaluated at step resolution, exposed
    to its enclosing function as a range vector (prometheus subqueries)."""

    expr: Expr
    range_nanos: int
    step_nanos: int = 0  # 0 = default (the outer query step)
    offset_nanos: int = 0
    at_nanos: int | str | None = None


@dataclass
class Aggregation(Expr):
    op: str
    expr: Expr
    param: Expr | None = None
    grouping: list[str] = field(default_factory=list)
    without: bool = False


@dataclass
class BinaryOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr
    return_bool: bool = False
    on: bool = False
    ignoring: bool = False
    matching_labels: list[str] = field(default_factory=list)
    group_left: bool = False
    group_right: bool = False
    # carried labels of group_left(...)/group_right(...)
    include_labels: list[str] = field(default_factory=list)


@dataclass
class Unary(Expr):
    op: str
    expr: Expr


AGG_OPS = {
    "sum",
    "min",
    "max",
    "avg",
    "count",
    "stddev",
    "stdvar",
    "topk",
    "bottomk",
    "quantile",
    "count_values",
}

FUNCTIONS = {
    "rate", "irate", "increase", "delta", "idelta", "deriv", "predict_linear",
    "resets", "changes", "holt_winters",
    "sum_over_time", "count_over_time", "avg_over_time", "min_over_time",
    "max_over_time", "last_over_time", "stddev_over_time", "stdvar_over_time",
    "quantile_over_time", "present_over_time",
    "abs", "ceil", "floor", "exp", "sqrt", "ln", "log2", "log10", "round",
    "clamp_min", "clamp_max", "clamp",
    "histogram_quantile", "sort", "sort_desc", "absent", "scalar", "vector",
    "label_replace", "label_join",
    "time", "timestamp",
    "day_of_month", "day_of_week", "days_in_month", "hour", "minute", "month",
    "year",
}

_TOKEN_RE = re.compile(
    r"""
    (?P<space>\s+)
  | (?P<duration>\d+(?:\.\d+)?(?:ns|us|ms|s|m|h|d|w|y)(?:\d+(?:\.\d+)?(?:ns|us|ms|s|m|h|d|w|y))*)
  | (?P<number>\d+\.\d+|\d+|\.\d+)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<ident>[a-zA-Z_][a-zA-Z0-9_:.]*)
  | (?P<colonident>:[a-zA-Z_:][a-zA-Z0-9_:.]*)
  | (?P<op>=~|!~|==|!=|<=|>=|<|>|=|\+|-|\*|/|%|\^|\(|\)|\{|\}|\[|\]|,|:|@)
    """,
    re.VERBOSE,
)

_KEYWORDS = {"by", "without", "on", "ignoring", "group_left", "group_right", "bool", "offset", "and", "or", "unless"}


@dataclass
class Token:
    kind: str
    text: str


def lex(s: str) -> list[Token]:
    out = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise ValueError(f"promql: unexpected character {s[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "space":
            continue
        if kind == "colonident":
            # leading-colon recording-rule names are idents; a bare ':'
            # (subquery step separator) stays an operator
            kind = "ident"
        text = m.group()
        if kind == "ident" and text in _KEYWORDS:
            kind = text
        out.append(Token(kind, text))
    out.append(Token("eof", ""))
    return out


_DUR_UNITS = {"w": "168h", "y": "8760h"}


def _duration_nanos(text: str) -> int:
    # normalize w/y which parse_duration doesn't know
    for u, repl in _DUR_UNITS.items():
        text = re.sub(rf"(\d+(?:\.\d+)?){u}", lambda m: f"{float(m.group(1)) * int(repl[:-1])}h", text)
    return parse_duration(text)


class Parser:
    # precedence: or < and/unless < comparison < +- < */% < ^
    _PREC = {
        "or": 1,
        "and": 2,
        "unless": 2,
        "==": 3, "!=": 3, "<": 3, ">": 3, "<=": 3, ">=": 3,
        "+": 4, "-": 4,
        "*": 5, "/": 5, "%": 5,
        "^": 6,
    }

    def __init__(self, tokens: list[Token]) -> None:
        self.toks = tokens
        self.i = 0

    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def eat(self, kind: str | None = None, text: str | None = None) -> Token:
        t = self.cur
        if kind is not None and t.kind != kind:
            raise ValueError(f"promql: expected {kind}, got {t.kind} {t.text!r}")
        if text is not None and t.text != text:
            raise ValueError(f"promql: expected {text!r}, got {t.text!r}")
        self.i += 1
        return t

    def parse(self) -> Expr:
        e = self.parse_expr(0)
        if self.cur.kind != "eof":
            raise ValueError(f"promql: trailing input at {self.cur.text!r}")
        return e

    def parse_expr(self, min_prec: int) -> Expr:
        lhs = self.parse_unary()
        while True:
            t = self.cur
            op = t.text if t.kind == "op" else t.kind
            prec = self._PREC.get(op)
            if t.kind not in ("op", "and", "or", "unless") or prec is None or prec < min_prec:
                return lhs
            self.i += 1
            node = BinaryOp(op=op, lhs=lhs, rhs=NumberLiteral(0))
            if self.cur.kind == "bool":
                self.eat("bool")
                node.return_bool = True
            if self.cur.kind in ("on", "ignoring"):
                which = self.eat().kind
                node.on = which == "on"
                node.ignoring = which == "ignoring"
                node.matching_labels = self._label_list()
                if self.cur.kind in ("group_left", "group_right"):
                    which = self.eat().kind
                    node.group_left = which == "group_left"
                    node.group_right = which == "group_right"
                    if self.cur.text == "(":
                        node.include_labels = self._label_list()
            # ^ is right-associative
            next_min = prec if op == "^" else prec + 1
            node.rhs = self.parse_expr(next_min)
            lhs = node

    def parse_unary(self) -> Expr:
        t = self.cur
        if t.kind == "op" and t.text in ("+", "-"):
            self.i += 1
            return Unary(t.text, self.parse_unary())
        return self.parse_postfix(self.parse_atom())

    def parse_postfix(self, e: Expr) -> Expr:
        while True:
            t = self.cur
            if t.kind == "op" and t.text == "[":
                self.eat(text="[")
                dur = self.eat("duration").text
                if self.cur.text == ":":
                    # subquery: expr[range:step?]
                    self.eat(text=":")
                    step = 0
                    if self.cur.kind == "duration":
                        step = _duration_nanos(self.eat("duration").text)
                    self.eat(text="]")
                    e = Subquery(e, _duration_nanos(dur), step)
                else:
                    self.eat(text="]")
                    if not isinstance(e, VectorSelector):
                        raise ValueError("promql: range on non-selector")
                    e = RangeSelector(e, _duration_nanos(dur))
            elif t.kind == "offset":
                self.eat("offset")
                neg = False
                if self.cur.text == "-":
                    self.eat(text="-")
                    neg = True
                dur = self.eat("duration").text
                off = _duration_nanos(dur) * (-1 if neg else 1)
                if isinstance(e, VectorSelector):
                    e.offset_nanos = off
                elif isinstance(e, RangeSelector):
                    e.vector.offset_nanos = off
                elif isinstance(e, Subquery):
                    e.offset_nanos = off
                else:
                    raise ValueError("promql: offset on non-selector")
            elif t.kind == "op" and t.text == "@":
                self.eat(text="@")
                if self.cur.kind == "number":
                    at = int(float(self.eat().text) * 1e9)
                elif self.cur.kind == "ident" and self.cur.text in ("start", "end"):
                    at = self.eat("ident").text
                    self.eat(text="(")
                    self.eat(text=")")
                else:
                    raise ValueError("promql: bad @ modifier")
                if isinstance(e, VectorSelector):
                    e.at_nanos = at
                elif isinstance(e, RangeSelector):
                    e.vector.at_nanos = at
                elif isinstance(e, Subquery):
                    e.at_nanos = at
                else:
                    raise ValueError("promql: @ on non-selector")
            else:
                return e

    def _label_list(self) -> list[str]:
        self.eat(text="(")
        labels = []
        while self.cur.text != ")":
            labels.append(self.eat("ident").text)
            if self.cur.text == ",":
                self.eat(text=",")
        self.eat(text=")")
        return labels

    def _matchers(self) -> list[Matcher]:
        self.eat(text="{")
        out = []
        while self.cur.text != "}":
            name = self.eat("ident").text
            op = self.eat("op").text
            if op not in ("=", "!=", "=~", "!~"):
                raise ValueError(f"promql: bad matcher op {op}")
            val = self.eat("string").text[1:-1]
            out.append(Matcher(name, op, val))
            if self.cur.text == ",":
                self.eat(text=",")
        self.eat(text="}")
        return out

    def parse_atom(self) -> Expr:
        t = self.cur
        if t.kind == "number":
            self.i += 1
            return NumberLiteral(float(t.text))
        if t.kind == "duration":
            # bare durations can appear as numbers in some positions
            self.i += 1
            return NumberLiteral(_duration_nanos(t.text) / 1e9)
        if t.kind == "string":
            self.i += 1
            return StringLiteral(t.text[1:-1])
        if t.kind == "op" and t.text == "(":
            self.eat(text="(")
            e = self.parse_expr(0)
            self.eat(text=")")
            return e
        if t.kind == "op" and t.text == "{":
            return VectorSelector(None, self._matchers())
        if t.kind == "ident":
            name = t.text
            self.i += 1
            # aggregation with modifiers
            if name in AGG_OPS and self.cur.kind in ("by", "without") or (
                name in AGG_OPS and self.cur.text == "("
            ):
                return self._aggregation(name)
            if name in FUNCTIONS and self.cur.text == "(":
                self.eat(text="(")
                args = []
                while self.cur.text != ")":
                    args.append(self.parse_expr(0))
                    if self.cur.text == ",":
                        self.eat(text=",")
                self.eat(text=")")
                return Call(name, args)
            matchers = self._matchers() if self.cur.text == "{" else []
            return VectorSelector(name, matchers)
        raise ValueError(f"promql: unexpected token {t.text!r}")

    def _aggregation(self, op: str) -> Expr:
        grouping: list[str] = []
        without = False
        if self.cur.kind in ("by", "without"):
            without = self.eat().kind == "without"
            grouping = self._label_list()
        self.eat(text="(")
        args = [self.parse_expr(0)]
        while self.cur.text == ",":
            self.eat(text=",")
            args.append(self.parse_expr(0))
        self.eat(text=")")
        if self.cur.kind in ("by", "without"):
            without = self.eat().kind == "without"
            grouping = self._label_list()
        if len(args) == 2:
            param, expr = args[0], args[1]
        else:
            param, expr = None, args[0]
        return Aggregation(op=op, expr=expr, param=param, grouping=grouping, without=without)


def parse(query: str) -> Expr:
    return Parser(lex(query)).parse()
