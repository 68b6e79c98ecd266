"""A plain evaluator of SPARQL basic graph patterns, in NumPy.

It answers the benchmark's queries from the generated triples alone, with
the semantics the deployment states: every solution of the pattern once
(bag semantics over the projected variables, which here are all the
pattern's variables), ``?x rdf:type C`` true where ``C`` lies in the
closure of ``x``'s stated types under ``rdf:subClassOf``.  It imports
nothing of the system under test.

Terms are the data set's term ids (int64); a query names terms by string
and :class:`Graph` maps them through the data set's own term table.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

RDF_TYPE = "rdf:type"
RDFS_SUBCLASSOF = "rdf:subClassOf"

# term ids pack into one int64 key: predicate, subject and object of
# _BITS bits each (the predicate's at the top)
_BITS = 24
_MASK = (1 << _BITS) - 1

# a "." ends a pattern where whitespace, "}" or the end follows it; a dot
# inside a name (ub:Dept0.Univ0) does not
_END = re.compile(r"\.(?=\s|\}|$)")


@dataclass(frozen=True)
class Pattern:
    s: str  # "?x" for a variable, else a term
    p: str
    o: str


@dataclass(frozen=True)
class Query:
    select: tuple[str, ...]  # variable names without "?"
    patterns: tuple[Pattern, ...]


def parse(text: str) -> Query:
    """``SELECT ?a ?b WHERE { s p o . ... }`` with constant predicates;
    ``#`` comments are dropped; terms are names without spaces.  Anything
    else raises."""
    body = "\n".join(line.split("#", 1)[0] for line in text.splitlines())
    body = _END.sub(" . ", body).replace("{", " { ").replace("}", " } ")
    toks = body.split()
    if not toks or toks[0].upper() != "SELECT":
        raise ValueError("expected SELECT")
    i = 1
    select = []
    while toks[i].startswith("?"):
        select.append(toks[i][1:])
        i += 1
    if toks[i].upper() != "WHERE" or toks[i + 1] != "{":
        raise ValueError("expected WHERE {")
    i += 2
    pats, cur = [], []
    while toks[i] != "}":
        if toks[i] == ".":
            if len(cur) != 3:
                raise ValueError(f"a pattern of {len(cur)} terms: {cur}")
            pats.append(Pattern(*cur))
            cur = []
        else:
            cur.append(toks[i])
        i += 1
    if cur:
        if len(cur) != 3:
            raise ValueError(f"a pattern of {len(cur)} terms: {cur}")
        pats.append(Pattern(*cur))
    if i != len(toks) - 1:
        raise ValueError("text after the closing brace")
    for pat in pats:
        if pat.p.startswith("?"):
            raise ValueError("variable predicates are not supported")
    return Query(tuple(select), tuple(pats))


class _Index:
    """One predicate's pairs, sorted by subject and by object."""

    def __init__(self, s: np.ndarray, o: np.ndarray):
        order = np.lexsort((o, s))
        self.s_s, self.o_s = s[order], o[order]  # by subject, then object
        self.key = (self.s_s << _BITS) | self.o_s  # sorted pair keys
        order = np.lexsort((s, o))
        self.o_o, self.s_o = o[order], s[order]  # by object, then subject

    @property
    def n(self) -> int:
        return int(self.s_s.shape[0])


_EMPTY = _Index(np.zeros(0, np.int64), np.zeros(0, np.int64))


class Graph:
    """The triples ``(s, p, o)`` (term ids; ``p`` indexes ``predicates``)
    indexed for pattern lookups, with the type closure worked out once.
    ``closure=False`` keeps only the stated types: the control that breaks
    the deployment's entailment guarantee.  ``term_id`` (string -> id of
    ``terms``) may be given where it is already at hand."""

    def __init__(self, terms: list[str], predicates, s, p, o,
                 closure: bool = True, term_id: dict | None = None):
        self.terms = terms
        self.term_id = term_id if term_id is not None else \
            {t: i for i, t in enumerate(terms)}
        self.pred_id = {q: i for i, q in enumerate(predicates)}
        s = np.asarray(s, dtype=np.int64)
        p = np.asarray(p, dtype=np.int64)
        o = np.asarray(o, dtype=np.int64)
        if len(terms) > _MASK or len(predicates) >= 1 << (62 - 2 * _BITS):
            raise ValueError("too many terms or predicates for the key")
        key = np.unique((p << 2 * _BITS) | (s << _BITS) | o)
        s, p, o = key >> _BITS & _MASK, key >> 2 * _BITS, key & _MASK
        t_type = self.pred_id.get(RDF_TYPE, -1)
        t_sc = self.pred_id.get(RDFS_SUBCLASSOF, -1)
        self._idx: dict[str, _Index] = {}
        bounds = np.searchsorted(p, np.arange(len(predicates) + 1))
        for q, name in enumerate(predicates):
            if q in (t_type, t_sc):
                continue
            lo, hi = bounds[q], bounds[q + 1]
            if hi > lo:
                self._idx[name] = _Index(s[lo:hi], o[lo:hi])
        sup: dict[int, set[int]] = {}
        m = p == t_sc
        for a, b in zip(s[m].tolist(), o[m].tolist()):
            sup.setdefault(a, set()).add(b)
        m = p == t_type
        ts, to = s[m], o[m]
        if closure:
            extra_s, extra_o = [ts], [to]
            for c in np.unique(to).tolist():
                ups = _ancestors(c, sup)
                if ups:
                    inst = ts[to == c]
                    for a in ups:
                        extra_s.append(inst)
                        extra_o.append(np.full(inst.shape, a, np.int64))
            # an entailed type holds once, however many paths lead to it
            tk = np.unique((np.concatenate(extra_s) << _BITS)
                           | np.concatenate(extra_o))
            ts, to = tk >> _BITS, tk & _MASK
        self._idx[RDF_TYPE] = _Index(ts, to)

    def term(self, name: str) -> int:
        """A query constant's term id; -1 where the data never names it."""
        return self.term_id.get(name, -1)

    def answer(self, query: Query) -> np.ndarray:
        """The solutions, int64 ``[n, len(query.select)]`` of term ids,
        rows sorted."""
        pats = []
        for pat in query.patterns:
            sv = pat.s[1:] if pat.s.startswith("?") else None
            ov = pat.o[1:] if pat.o.startswith("?") else None
            if sv is None and ov is None:
                raise ValueError("a pattern without variables")
            sc = None if sv is not None else self.term(pat.s)
            oc = None if ov is not None else self.term(pat.o)
            pats.append((sv, ov, sc, oc, self._idx.get(pat.p, _EMPTY)))
        cols: dict[str, np.ndarray] | None = None
        while pats:
            bound = set(cols or ())

            def rank(i):
                sv, ov, sc, oc, idx = pats[i]
                vs = {v for v in (sv, ov) if v is not None}
                shared = len(vs & bound)
                size = _slice_size(idx, sc, oc)
                return (-(shared == len(vs)), -shared, size)

            sv, ov, sc, oc, idx = pats.pop(min(range(len(pats)), key=rank))
            cols = _apply(cols, sv, ov, sc, oc, idx)
        out = np.stack([cols[v] for v in query.select], axis=1) \
            if query.select else np.zeros((0, 0), np.int64)
        return sort_rows(out)


def _ancestors(c: int, sup: dict[int, set[int]]) -> set[int]:
    seen: set[int] = set()
    stack = [c]
    while stack:
        for b in sup.get(stack.pop(), ()):
            if b not in seen:
                seen.add(b)
                stack.append(b)
    return seen


def _range(keys: np.ndarray, c) -> tuple:
    return (np.searchsorted(keys, c, "left"), np.searchsorted(keys, c, "right"))


def _slice_size(idx: _Index, sc, oc) -> int:
    if sc is not None:
        lo, hi = _range(idx.s_s, sc)
        return int(hi - lo)
    if oc is not None:
        lo, hi = _range(idx.o_o, oc)
        return int(hi - lo)
    return idx.n


def _member(x: np.ndarray, sorted_vals: np.ndarray) -> np.ndarray:
    if sorted_vals.shape[0] == 0:
        return np.zeros(x.shape, bool)
    pos = np.searchsorted(sorted_vals, x).clip(0, sorted_vals.shape[0] - 1)
    return sorted_vals[pos] == x


def _apply(cols, sv, ov, sc, oc, idx: _Index):
    """Join the binding table ``cols`` (var -> column; None before the
    first pattern) with one pattern: subject variable ``sv`` or constant
    ``sc``, object variable ``ov`` or constant ``oc``."""
    if sc is not None:  # constant subject: its objects, sorted
        lo, hi = _range(idx.s_s, sc)
        vals = idx.o_s[lo:hi]
        if cols is None:
            return {ov: vals.copy()}
        if ov in cols:
            return _keep(cols, _member(cols[ov], vals))
        return _cross(cols, {ov: vals})
    if oc is not None:  # constant object: its subjects, sorted
        lo, hi = _range(idx.o_o, oc)
        vals = idx.s_o[lo:hi]
        if cols is None:
            return {sv: vals.copy()}
        if sv in cols:
            return _keep(cols, _member(cols[sv], vals))
        return _cross(cols, {sv: vals})
    if sv == ov:
        m = idx.s_s == idx.o_s
        pairs = {sv: idx.s_s[m]}
        if cols is None:
            return pairs
        if sv in cols:
            return _keep(cols, _member(cols[sv], pairs[sv]))
        return _cross(cols, pairs)
    if cols is None:
        return {sv: idx.s_s.copy(), ov: idx.o_s.copy()}
    if sv in cols and ov in cols:
        return _keep(cols, _member((cols[sv] << _BITS) | cols[ov], idx.key))
    if sv in cols:
        return _expand(cols, cols[sv], idx.s_s, idx.o_s, ov)
    if ov in cols:
        return _expand(cols, cols[ov], idx.o_o, idx.s_o, sv)
    return _cross(cols, {sv: idx.s_s, ov: idx.o_s})


def _keep(cols, m):
    return {k: v[m] for k, v in cols.items()}


def _expand(cols, on, keys, vals, new):
    lo = np.searchsorted(keys, on, "left")
    cnt = np.searchsorted(keys, on, "right") - lo
    rep = np.repeat(np.arange(on.shape[0]), cnt)
    pos = np.repeat(lo - np.cumsum(cnt) + cnt, cnt) + np.arange(rep.shape[0])
    out = {k: v[rep] for k, v in cols.items()}
    out[new] = vals[pos]
    return out


def _cross(cols, other):
    n = next(iter(cols.values())).shape[0]
    m = next(iter(other.values())).shape[0]
    out = {k: np.repeat(v, m) for k, v in cols.items()}
    out.update({k: np.tile(v, n) for k, v in other.items()})
    return out


def sort_rows(rows: np.ndarray) -> np.ndarray:
    """``rows`` in lexicographic order (a canonical form of a bag)."""
    if rows.ndim != 2 or rows.shape[0] < 2 or rows.shape[1] == 0:
        return rows
    return rows[np.lexsort(rows.T[::-1])]
