"""Structural fingerprints for SPARQL queries (plan-cache keys).

Two queries that differ only in variable names, triple order, filter order,
prefix declarations, or whitespace describe the same query graph and should
compile to the same execution plan.  This module canonicalizes a parsed
``SelectQuery`` into a normal form and hashes it:

1. every variable gets a *structural signature* via a few rounds of
   Weisfeiler–Leman-style refinement over the triple/filter occurrences
   (constants anchor the refinement, so ``?a ub:worksFor ub:Dept0`` and
   ``?b ub:worksFor ub:Dept1`` are distinguished);
2. variables are renamed ``v0, v1, ...`` in signature order (alpha-renaming);
3. the commutative parts — triples and filters within a group — are sorted
   by their canonical serialization (OPTIONAL groups and UNION blocks keep
   their written order: they are evaluated sequentially and are not
   commutative);
4. the fingerprint is the SHA-256 of the canonical serialization.

Because canonicalization only applies a bijective renaming plus reordering
of commutative parts, two queries with equal canonical forms are genuinely
alpha-equivalent: a collision can only merge queries with identical
semantics.  The converse is best-effort — WL-symmetric variables are
tie-broken on their original names, so a pathological automorphic query may
miss sharing, but never computes a wrong answer.

SELECT order is preserved (it fixes result-column order), and the renaming
map is returned so callers can restore the caller's variable names on the
way out of a shared plan or cached result.

``parameterize_query`` additionally produces a *shape* fingerprint: the same
canonicalization with hoistable constants blinded, so LUBM-style template
queries that differ only in which IRI they mention share one parameterized
plan.  The hoisted constants come back as a slot-ordered vector; slot order
is the occurrence order over the shape-canonical group (see
``iter_param_occurrences``), which the engine reuses verbatim to assign
parameter slots to query-graph vertices.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from repro_torch.rdf.sparql import (Comparison, GroupPattern, Iri, Literal, Regex,
                              SelectQuery, TriplePattern, Var, parse_sparql)

_REFINE_ROUNDS = 3


@dataclass(frozen=True)
class CanonicalQuery:
    """A query in canonical form plus the renaming that produced it."""

    query: SelectQuery          # canonical AST (variables renamed v0, v1, ...)
    fingerprint: str            # hex digest of the canonical serialization
    rename: dict[str, str] = field(default_factory=dict)  # original -> canonical

    @property
    def inverse(self) -> dict[str, str]:
        return {c: o for o, c in self.rename.items()}

    def restore(self, variables: list[str]) -> list[str]:
        """Map canonical variable names back to this caller's names."""
        inv = self.inverse
        return [inv.get(v, v) for v in variables]


# ------------------------------------------------------------------ hashing
def _h(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def _term_struct(t, blind: frozenset[int] | None = None) -> tuple:
    """Structural key of a term with variables blinded.  ``blind`` holds
    ``id()``s of constant occurrences to blind too (shape canonicalization:
    every hoistable constant collapses to one placeholder key)."""
    if isinstance(t, Var):
        return ("v",)
    if blind is not None and id(t) in blind:
        return ("c?",)
    if isinstance(t, Iri):
        return ("i", t.value)
    return ("l", t.value, t.numeric)


def _term_sig(t, sig: dict[str, str],
              blind: frozenset[int] | None = None) -> tuple:
    """Structural key of a term with variables replaced by their signature."""
    if isinstance(t, Var):
        return ("v", sig[t.name])
    return _term_struct(t, blind)


def _walk(g: GroupPattern, ctx: str, triples: list, filters: list) -> None:
    """Flatten all triples/filters with a renaming-invariant context tag
    (nesting kind + depth, never a sibling index)."""
    for tp in g.triples:
        triples.append((ctx, tp))
    for f in g.filters:
        filters.append((ctx, f))
    for og in g.optionals:
        _walk(og, ctx + "o", triples, filters)
    for union in g.unions:
        for branch in union:
            _walk(branch, ctx + "u", triples, filters)


def _filter_occurrence(ctx: str, f, name: str) -> tuple:
    if isinstance(f, Regex):
        return ("r", ctx, f.pattern)
    lhs = f.lhs.name == name if isinstance(f.lhs, Var) else False
    rhs = f.rhs.name == name if isinstance(f.rhs, Var) else False
    side = "b" if (lhs and rhs) else ("l" if lhs else "r")
    return ("f", ctx, side, f.op, _term_struct(f.lhs), _term_struct(f.rhs))


def _variable_signatures(ast: SelectQuery,
                         blind: frozenset[int] | None = None) -> dict[str, str]:
    triples: list[tuple[str, TriplePattern]] = []
    filters: list[tuple] = []
    _walk(ast.where, "b", triples, filters)

    occ: dict[str, list] = {}

    def _note(name: str, entry) -> None:
        occ.setdefault(name, []).append(entry)

    for ctx, tp in triples:
        key = (ctx, _term_struct(tp.s, blind), _term_struct(tp.p, blind),
               _term_struct(tp.o, blind))
        for role, t in (("s", tp.s), ("p", tp.p), ("o", tp.o)):
            if isinstance(t, Var):
                _note(t.name, ("t", role, key))
    for ctx, f in filters:
        for t in ((f.var,) if isinstance(f, Regex) else (f.lhs, f.rhs)):
            if isinstance(t, Var):
                _note(t.name, _filter_occurrence(ctx, f, t.name))
    for idx, name in enumerate(ast.select):
        _note(name, ("sel", idx))

    sig = {name: _h(tuple(sorted(entries))) for name, entries in occ.items()}

    # WL refinement: fold in the signatures of co-occurring variables so
    # structurally distinct-but-locally-similar variables separate.
    for _ in range(_REFINE_ROUNDS):
        nxt: dict[str, str] = {}
        for name in sig:
            nbr = []
            for ctx, tp in triples:
                terms = (tp.s, tp.p, tp.o)
                if any(isinstance(t, Var) and t.name == name for t in terms):
                    role = "".join(
                        r for r, t in zip("spo", terms)
                        if isinstance(t, Var) and t.name == name)
                    nbr.append((ctx, role, tuple(_term_sig(t, sig, blind)
                                                 for t in terms)))
            nxt[name] = _h((sig[name], tuple(sorted(nbr))))
        sig = nxt
    return sig


# ------------------------------------------------------------ serialization
def _ser_term(t, blind: frozenset[int] | None = None) -> str:
    if isinstance(t, Var):
        return "?" + t.name
    if blind is not None and id(t) in blind:
        return "◆"  # hoisted constant placeholder (shape serialization)
    if isinstance(t, Iri):
        return f"<{t.value}>"
    num = "" if t.numeric is None else f"#{t.numeric!r}"
    return f'"{t.value}"{num}'


def _ser_filter(f) -> str:
    if isinstance(f, Regex):
        return f"(re {_ser_term(f.var)} {f.pattern!r})"
    return f"(cmp {f.op} {_ser_term(f.lhs)} {_ser_term(f.rhs)})"


def _ser_group(g: GroupPattern, blind: frozenset[int] | None = None) -> str:
    parts = ["T[" + " ".join(f"({_ser_term(tp.s, blind)} "
                             f"{_ser_term(tp.p, blind)} "
                             f"{_ser_term(tp.o, blind)})"
                             for tp in g.triples) + "]",
             "F[" + " ".join(_ser_filter(f) for f in g.filters) + "]",
             "O[" + " ".join(_ser_group(o, blind) for o in g.optionals) + "]",
             "U[" + " ".join("(" + "|".join(_ser_group(b, blind)
                                            for b in branches)
                             + ")" for branches in g.unions) + "]"]
    return "{" + "".join(parts) + "}"


def serialize_query(ast: SelectQuery,
                    blind: frozenset[int] | None = None) -> str:
    sel = "*" if not ast.select else ",".join("?" + v for v in ast.select)
    # solution modifiers are part of query identity: a cached result for
    # LIMIT 10 must not answer LIMIT 20 (plans could be shared, results not
    # — one fingerprint keys both caches, so modifiers split it)
    mods = ""
    if ast.distinct:
        mods += "|D"
    if ast.limit is not None:
        mods += f"|L{ast.limit}"
    if ast.offset:
        mods += f"|O{ast.offset}"
    return f"SELECT({sel})WHERE{_ser_group(ast.where, blind)}{mods}"


# ---------------------------------------------------------- canonical form
def _rename_term(t, rename: dict[str, str]):
    if isinstance(t, Var):
        return Var(rename[t.name])
    return t


def _canon_group(g: GroupPattern, rename: dict[str, str],
                 blind: frozenset[int] | None = None) -> GroupPattern:
    # Constants pass through _rename_term as the SAME objects, so id()-keyed
    # blinding survives into the canonical AST.  Shape canonicalization sorts
    # on the blinded key first (family members must agree on triple order)
    # with the real serialization as a deterministic tie-break — tied triples
    # are structurally interchangeable, so either resolution pairs slots with
    # consistent structural positions.
    triples = sorted(
        (TriplePattern(_rename_term(tp.s, rename), _rename_term(tp.p, rename),
                       _rename_term(tp.o, rename)) for tp in g.triples),
        key=lambda tp: ((_ser_term(tp.p, blind), _ser_term(tp.s, blind),
                         _ser_term(tp.o, blind)),
                        (_ser_term(tp.p), _ser_term(tp.s), _ser_term(tp.o))))
    filters: list = []
    for f in g.filters:
        if isinstance(f, Regex):
            filters.append(Regex(_rename_term(f.var, rename), f.pattern))
        else:
            filters.append(Comparison(_rename_term(f.lhs, rename), f.op,
                                      _rename_term(f.rhs, rename)))
    filters.sort(key=_ser_filter)
    # OPTIONAL groups and UNION blocks keep their written order: OPTIONAL
    # left-joins chain (a later group may join on variables bound by an
    # earlier one) and the first UNION branch fixes SELECT-* projection, so
    # neither is commutative — sorting them would merge non-equivalent
    # queries under one fingerprint
    optionals = [_canon_group(o, rename, blind) for o in g.optionals]
    unions = [[_canon_group(b, rename, blind) for b in branches]
              for branches in g.unions]
    return GroupPattern(triples, filters, optionals, unions)


def canonicalize_query(ast: SelectQuery) -> CanonicalQuery:
    sig = _variable_signatures(ast)
    # signature order; original name only breaks WL-symmetric ties
    order = sorted(sig, key=lambda name: (sig[name], name))
    rename = {name: f"v{i}" for i, name in enumerate(order)}
    canon = SelectQuery(
        select=[rename.get(v, v) for v in ast.select],
        where=_canon_group(ast.where, rename),
        prefixes={},  # already folded into terms by the parser
        distinct=ast.distinct,
        limit=ast.limit,
        offset=ast.offset,
    )
    text = serialize_query(canon)
    fp = hashlib.sha256(text.encode()).hexdigest()[:32]
    return CanonicalQuery(query=canon, fingerprint=fp, rename=rename)


def fingerprint_query(source: str | SelectQuery) -> str:
    """Fingerprint a query given as SPARQL text or a parsed AST."""
    ast = parse_sparql(source) if isinstance(source, str) else source
    return canonicalize_query(ast).fingerprint


# ------------------------------------------------------- parameterized shape
# Predicates whose constant terms anchor the *structure* of the query under
# the type-aware transformation (they fold into vertex labels, not bound
# vertices) — never hoisted into parameters.
_STRUCT_PREDS = frozenset({"rdf:type", "rdf:subClassOf"})


def const_key(t) -> str:
    """Dictionary-text form of a constant term — must match what
    ``core.query.build_query_graph`` feeds ``maps.vertex_of``."""
    return t.value if isinstance(t, Iri) else f'"{t.value}"'


def iter_param_occurrences(g: GroupPattern):
    """Yield hoistable constant term occurrences of a group in slot order.

    Slot order is definitional: the fingerprint layer extracts the constant
    vector with it and the engine assigns plan parameter slots with it, so
    both must call this one generator.  Each occurrence is its own slot even
    when two occurrences mention the same constant (mirroring
    ``build_query_graph``, which makes a fresh bound vertex per occurrence).
    """
    for tp in g.triples:
        if isinstance(tp.p, Iri) and tp.p.value in _STRUCT_PREDS:
            continue
        for t in (tp.s, tp.o):
            if not isinstance(t, Var):
                yield t
    for og in g.optionals:
        yield from iter_param_occurrences(og)
    for union in g.unions:
        for branch in union:
            yield from iter_param_occurrences(branch)


@dataclass(frozen=True)
class ParamQuery:
    """A query split into (shape, constant vector) plus its exact canonical
    form.  ``shape_query`` is the shape-canonical AST with this member's real
    constants still in place — the engine compiles the family plan from it
    (any member works as representative: parameter slots make the compiled
    program constant-independent)."""

    canon: CanonicalQuery       # exact canonicalization (result-cache key)
    shape: str                  # fingerprint with hoistable constants blinded
    consts: tuple[str, ...]     # hoisted constants (dictionary text), by slot
    shape_query: SelectQuery    # shape-canonical AST, slot order authoritative
    rename: dict[str, str] = field(default_factory=dict)  # original -> shape

    @property
    def inverse(self) -> dict[str, str]:
        return {c: o for o, c in self.rename.items()}

    def restore(self, variables: list[str]) -> list[str]:
        """Map shape-canonical variable names back to this caller's names."""
        inv = self.inverse
        return [inv.get(v, v) for v in variables]


def parameterize_query(source: str | SelectQuery) -> ParamQuery:
    """Canonicalize a query to a (shape fingerprint, constant vector) pair.

    Runs the exact canonicalization plus a second pass with hoistable
    constants blinded in the WL refinement, the triple sort, and the
    serialization.  Queries with no hoistable constants degrade to
    shape == exact fingerprint (a family of one).
    """
    ast = parse_sparql(source) if isinstance(source, str) else source
    canon = canonicalize_query(ast)
    blind = frozenset(id(t) for t in iter_param_occurrences(ast.where))
    if not blind:
        return ParamQuery(canon=canon, shape=canon.fingerprint, consts=(),
                          shape_query=canon.query, rename=canon.rename)
    sig = _variable_signatures(ast, blind)
    order = sorted(sig, key=lambda name: (sig[name], name))
    rename = {name: f"v{i}" for i, name in enumerate(order)}
    shape_ast = SelectQuery(
        select=[rename.get(v, v) for v in ast.select],
        where=_canon_group(ast.where, rename, blind),
        prefixes={},
        distinct=ast.distinct,
        limit=ast.limit,
        offset=ast.offset,
    )
    text = serialize_query(shape_ast, blind)
    shape = hashlib.sha256(text.encode()).hexdigest()[:32]
    consts = tuple(const_key(t)
                   for t in iter_param_occurrences(shape_ast.where))
    return ParamQuery(canon=canon, shape=shape, consts=consts,
                      shape_query=shape_ast, rename=rename)
