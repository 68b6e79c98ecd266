"""SPARQL subset parser (BGP + OPTIONAL + FILTER + UNION + PREFIX).

Grammar (recursive descent):

    query     := prologue SELECT varlist WHERE group
    prologue  := (PREFIX name: <iri>)*
    varlist   := '*' | var+
    group     := '{' item* '}'
    item      := triple '.'?                      (BGP triple pattern)
               | OPTIONAL group
               | FILTER expr
               | group (UNION group)+             (alternative groups)
    triple    := term term term
    term      := var | <iri> | prefixed | literal | number
    expr      := '(' cmp ')' | REGEX '(' var ',' literal ')'
    cmp       := operand op operand ( '&&' cmp )*
    op        := < <= > >= = !=

This is the fragment the paper evaluates (basic graph patterns for
LUBM/YAGO/BTC + the explore-use-case keywords for BSBM).  Modifiers the
paper strips (DISTINCT/ORDER BY) are accepted and ignored with a warning.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Union

from repro_torch.utils import get_logger

log = get_logger("rdf.sparql")


# --------------------------------------------------------------------- AST
@dataclass(frozen=True)
class Var:
    name: str


@dataclass(frozen=True)
class Iri:
    value: str  # normalized (prefix-expanded if prefix known, else as written)


@dataclass(frozen=True)
class Literal:
    value: str  # lexical form WITHOUT quotes
    numeric: float | None = None


Term = Union[Var, Iri, Literal]


@dataclass(frozen=True)
class TriplePattern:
    s: Term
    p: Term
    o: Term


@dataclass(frozen=True)
class Comparison:
    lhs: Term
    op: str  # < <= > >= = !=
    rhs: Term


@dataclass(frozen=True)
class Regex:
    var: Var
    pattern: str


FilterExpr = Union[Comparison, Regex]


@dataclass
class GroupPattern:
    triples: list[TriplePattern] = field(default_factory=list)
    filters: list[FilterExpr] = field(default_factory=list)
    optionals: list["GroupPattern"] = field(default_factory=list)
    unions: list[list["GroupPattern"]] = field(default_factory=list)  # each: ≥2 branches


@dataclass
class SelectQuery:
    select: list[str]  # variable names, empty = '*'
    where: GroupPattern
    prefixes: dict[str, str] = field(default_factory=dict)
    # solution modifiers (applied post-matching; ORDER BY is still ignored)
    distinct: bool = False
    limit: int | None = None
    offset: int = 0

    @property
    def has_modifiers(self) -> bool:
        return self.distinct or self.limit is not None or self.offset > 0


# ------------------------------------------------------------------ lexer
_TOKEN_RE = re.compile(
    r"""
    (?P<WS>\s+)
  | (?P<COMMENT>\#[^\n]*)
  | (?P<IRI><[^>\s]*>)
  | (?P<LITERAL>"(?:[^"\\]|\\.)*"(?:@\w+|\^\^<[^>]*>|\^\^\w+:\w+)?)
  | (?P<VAR>[?$][A-Za-z_][A-Za-z0-9_]*)
  | (?P<NUMBER>[+-]?\d+(?:\.\d+)?)
  | (?P<LBRACE>\{) | (?P<RBRACE>\})
  | (?P<LPAREN>\() | (?P<RPAREN>\))
  | (?P<DOT>\.(?!\w))
  | (?P<COMMA>,)
  | (?P<OP><=|>=|!=|=|<|>|&&|\|\|)
  | (?P<STAR>\*)
  | (?P<NAME>[A-Za-z_][\w.\-]*(?::[\w.\-]*)*)
""",
    re.VERBOSE,
)

_KEYWORDS = {"SELECT", "WHERE", "OPTIONAL", "FILTER", "UNION", "PREFIX", "REGEX",
             "DISTINCT", "ORDER", "BY", "LIMIT", "OFFSET", "ASC", "DESC", "A"}


@dataclass
class _Tok:
    kind: str
    text: str
    pos: int


class SparqlError(ValueError):
    pass


def normalize_iri(iri: str) -> str:
    """Canonical short forms for the well-known vocabulary.  Shared by the
    query parser and the SPARQL UPDATE parser — both sides MUST intern the
    same term string or updates become unfindable by queries."""
    if iri.endswith("#type") or iri.endswith("/type"):
        return "rdf:type"
    if iri.endswith("#subClassOf"):
        return "rdf:subClassOf"
    return iri


def normalize_prefixed(name: str) -> str:
    if name in ("rdf:type", "rdfs:subClassOf", "rdf:subClassOf"):
        return "rdf:type" if name == "rdf:type" else "rdf:subClassOf"
    # datasets in this repo use prefixed names directly as dictionary terms
    return name


def _lex(src: str) -> list[_Tok]:
    toks: list[_Tok] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SparqlError(f"lex error at {pos}: {src[pos:pos + 20]!r}")
        kind = m.lastgroup or ""
        text = m.group()
        pos = m.end()
        if kind in ("WS", "COMMENT"):
            continue
        if kind == "NAME" and text.upper() in _KEYWORDS:
            kind = text.upper() if text.upper() != "A" else "A"
        toks.append(_Tok(kind, text, m.start()))
    toks.append(_Tok("EOF", "", len(src)))
    return toks


# ----------------------------------------------------------------- parser
class _Parser:
    def __init__(self, src: str):
        self.toks = _lex(src)
        self.i = 0
        self.prefixes: dict[str, str] = {}

    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str) -> _Tok:
        t = self.next()
        if t.kind != kind:
            raise SparqlError(f"expected {kind}, got {t.kind} {t.text!r} at {t.pos}")
        return t

    # ---- entry
    def parse(self) -> SelectQuery:
        while self.peek().kind == "PREFIX":
            self.next()
            name = self.expect("NAME").text
            iri = self.expect("IRI").text[1:-1]
            self.prefixes[name.rstrip(":")] = iri
        self.expect("SELECT")
        distinct = False
        if self.peek().kind == "DISTINCT":
            distinct = True
            self.next()
        select: list[str] = []
        if self.peek().kind == "STAR":
            self.next()
        else:
            while self.peek().kind == "VAR":
                select.append(self.next().text[1:])
        self.expect("WHERE")
        where = self.group()
        # solution modifiers: LIMIT/OFFSET are honored, ORDER BY is parsed
        # and ignored (the engine returns unordered bindings)
        limit: int | None = None
        offset = 0
        while self.peek().kind != "EOF":
            t = self.next()
            if t.kind in ("LIMIT", "OFFSET"):
                n = self.expect("NUMBER")
                try:
                    val = int(n.text)
                except ValueError:
                    raise SparqlError(
                        f"{t.kind} needs an integer, got {n.text!r} at {n.pos}"
                    ) from None
                if val < 0:
                    raise SparqlError(f"{t.kind} must be >= 0 (at {n.pos})")
                if t.kind == "LIMIT":
                    limit = val
                else:
                    offset = val
            elif t.kind == "ORDER":
                log.debug("ignoring ORDER BY (engine returns unordered rows)")
            elif t.kind in ("BY", "ASC", "DESC", "NUMBER", "VAR", "LPAREN",
                            "RPAREN"):
                continue
            else:
                raise SparqlError(
                    f"unexpected trailing token {t.text!r} at {t.pos}")
        return SelectQuery(select=select, where=where, prefixes=self.prefixes,
                           distinct=distinct, limit=limit, offset=offset)

    # ---- group
    def group(self) -> GroupPattern:
        self.expect("LBRACE")
        g = GroupPattern()
        while True:
            t = self.peek()
            if t.kind == "RBRACE":
                self.next()
                return g
            if t.kind == "OPTIONAL":
                self.next()
                g.optionals.append(self.group())
            elif t.kind == "FILTER":
                self.next()
                g.filters.append(self.filter_expr())
            elif t.kind == "LBRACE":
                branches = [self.group()]
                while self.peek().kind == "UNION":
                    self.next()
                    branches.append(self.group())
                if len(branches) < 2:
                    # plain nested group: merge into parent
                    sub = branches[0]
                    g.triples += sub.triples
                    g.filters += sub.filters
                    g.optionals += sub.optionals
                    g.unions += sub.unions
                else:
                    g.unions.append(branches)
            elif t.kind == "EOF":
                raise SparqlError("unexpected EOF inside group")
            else:
                g.triples.append(self.triple())
                if self.peek().kind == "DOT":
                    self.next()
        # unreachable

    def triple(self) -> TriplePattern:
        s = self.term()
        p = self.term(pred=True)
        o = self.term()
        return TriplePattern(s, p, o)

    def term(self, pred: bool = False) -> Term:
        t = self.next()
        if t.kind == "VAR":
            return Var(t.text[1:])
        if t.kind == "IRI":
            return Iri(self._expand_iri(t.text[1:-1]))
        if t.kind == "NAME":
            return Iri(self._expand_prefixed(t.text))
        if t.kind == "A" and pred:
            return Iri("rdf:type")
        if t.kind == "LITERAL":
            lex = _literal_lexical(t.text)
            return Literal(lex, _try_float(lex))
        if t.kind == "NUMBER":
            return Literal(t.text, float(t.text))
        raise SparqlError(f"bad term {t.text!r} at {t.pos}")

    def _expand_iri(self, iri: str) -> str:
        return normalize_iri(iri)

    def _expand_prefixed(self, name: str) -> str:
        return normalize_prefixed(name)

    # ---- filters
    def filter_expr(self) -> FilterExpr:
        t = self.peek()
        if t.kind == "REGEX":
            self.next()
            self.expect("LPAREN")
            var = self.term()
            if not isinstance(var, Var):
                raise SparqlError("regex() first arg must be a variable")
            self.expect("COMMA")
            lit = self.next()
            if lit.kind != "LITERAL":
                raise SparqlError("regex() second arg must be a literal")
            self.expect("RPAREN")
            return Regex(var, _literal_lexical(lit.text))
        self.expect("LPAREN")
        cmp = self._comparison()
        # only single comparisons (optionally &&-chained comparisons are split
        # into multiple filters by the caller; reject || at parse level)
        exprs = [cmp]
        while self.peek().kind == "OP" and self.peek().text == "&&":
            self.next()
            exprs.append(self._comparison())
        self.expect("RPAREN")
        if len(exprs) == 1:
            return exprs[0]
        # represent && as a chain by returning the list through a wrapper
        return _AndChain(exprs)  # type: ignore[return-value]

    def _comparison(self) -> Comparison:
        lhs = self.term()
        op = self.expect("OP").text
        if op in ("&&", "||"):
            raise SparqlError(f"unexpected {op}")
        rhs = self.term()
        return Comparison(lhs, op, rhs)


@dataclass(frozen=True)
class _AndChain:
    exprs: list[Comparison]


def _literal_lexical(tok: str) -> str:
    end = tok.rfind('"')
    return tok[1:end]


def _try_float(s: str) -> float | None:
    try:
        return float(s)
    except ValueError:
        return None


def parse_sparql(src: str) -> SelectQuery:
    q = _Parser(src).parse()
    # flatten &&-chains into separate filters
    def _flatten(g: GroupPattern) -> None:
        flat: list[FilterExpr] = []
        for f in g.filters:
            if isinstance(f, _AndChain):
                flat.extend(f.exprs)
            else:
                flat.append(f)
        g.filters = flat
        for o in g.optionals:
            _flatten(o)
        for branches in g.unions:
            for b in branches:
                _flatten(b)

    _flatten(q.where)
    return q
