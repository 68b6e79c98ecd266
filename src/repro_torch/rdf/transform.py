"""RDF → labeled-graph transformations (paper §3.2 and §4.1).

``direct_transform``
    Subjects/objects → vertices; predicates → edge labels; every triple —
    including ``rdf:type`` / ``rdf:subClassOf`` — becomes an edge.  Vertices
    carry no label sets (the paper's L(v) = {v} identity labeling is realized
    by the executor's *ID-attribute* check instead, which is equivalent and
    avoids a label space the size of the vertex set).

``type_aware_transform``
    Definition 3: split T into T' / T'_t (rdf:type) / T'_sc (rdf:subClassOf);
    only T' becomes edges; objects of T'_t ∪ T'_sc become *vertex labels*;
    L(v) = type closure of v through rdf:type then transitive rdf:subClassOf.
    Class-only vertices (objects of type/subClassOf triples that never occur
    in T') are dropped from the vertex set — that is the size reduction in
    the paper's Table 1.

Both return (LabeledGraph, TransformMaps) where TransformMaps carries the
term↔vertex / predicate↔edge-label / class↔vertex-label id mappings needed to
transform SPARQL queries consistently (F_ID = F'_ID etc. in the paper).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.rdf.dictionary import RDF_TYPE, RDFS_SUBCLASSOF, Dictionary
from repro_torch.rdf.graph import LabeledGraph
from repro_torch.rdf.ontology import ClassHierarchy
from repro_torch.rdf.triples import TripleStore
from repro_torch.utils import get_logger

log = get_logger("rdf.transform")


@dataclass
class TransformMaps:
    """Id mappings shared between data-graph and query-graph transformation."""

    dict: Dictionary
    term_to_vertex: dict[int, int]
    vertex_to_term: np.ndarray  # int64 [n_vertices]
    pred_to_elabel: dict[int, int]
    elabel_to_pred: np.ndarray
    class_term_to_vlabel: dict[int, int] = field(default_factory=dict)
    hierarchy: ClassHierarchy | None = None
    kind: str = "type_aware"  # or "direct"

    # convenience: string-level lookups (queries arrive as strings)
    def vertex_of(self, term: str) -> int | None:
        tid = self.dict.term_id(term)
        if tid is None:
            return None
        return self.term_to_vertex.get(tid)

    def elabel_of(self, pred: str) -> int | None:
        pid = self.dict.predicate_id(pred)
        if pid is None:
            return None
        return self.pred_to_elabel.get(pid)

    def vlabel_of(self, cls: str) -> int | None:
        tid = self.dict.term_id(cls)
        if tid is None:
            return None
        return self.class_term_to_vlabel.get(tid)


def _numeric_values(dic: Dictionary, vertex_to_term: np.ndarray) -> np.ndarray:
    """Parse numeric literals ("42", "3.5"^^xsd:double …) into a value column."""
    vals = np.full(vertex_to_term.shape[0], np.nan, dtype=np.float64)
    for v, tid in enumerate(vertex_to_term):
        term = dic.term(int(tid))
        if term.startswith('"'):
            end = term.find('"', 1)
            lex = term[1:end] if end > 0 else term.strip('"')
            try:
                vals[v] = float(lex)
            except ValueError:
                pass
    return vals


def materialize_inferred_types(store: TripleStore) -> TripleStore:
    """Add the inferred ``rdf:type`` triples (transitive subClassOf closure).

    The paper loads LUBM as *original + inferred* triples ("the standard way
    to perform the LUBM benchmark") so subsumption queries (e.g. Q5/Q6's
    ``?x rdf:type ub:Student``) work on engines without reasoning — exactly
    what the direct transformation needs.  The type-aware transformation
    performs this closure natively (Definition 3.7), so it does NOT need the
    materialized triples.  Returns a new finalized store.
    """
    store.finalize()
    d = store.dict
    pid_type = d.predicate_id(RDF_TYPE)
    pid_sc = d.predicate_id(RDFS_SUBCLASSOF)
    out = TripleStore()
    for s, p, o in store.iter_decoded():
        out.add(s, p, o)
    if pid_type is None or pid_sc is None:
        return out.finalize()
    # class hierarchy over class terms
    hierarchy: dict[str, set[str]] = {}
    is_sc = store.p == pid_sc
    for sterm, oterm in zip(store.s[is_sc], store.o[is_sc]):
        hierarchy.setdefault(d.term(int(sterm)), set()).add(d.term(int(oterm)))

    def supers(cls: str) -> set[str]:
        seen: set[str] = set()
        stack = [cls]
        while stack:
            for sup in hierarchy.get(stack.pop(), ()):
                if sup not in seen:
                    seen.add(sup)
                    stack.append(sup)
        return seen

    is_type = store.p == pid_type
    for sterm, oterm in zip(store.s[is_type], store.o[is_type]):
        subj = d.term(int(sterm))
        for sup in supers(d.term(int(oterm))):
            out.add(subj, RDF_TYPE, sup)
    return out.finalize()


def direct_transform(store: TripleStore) -> tuple[LabeledGraph, TransformMaps]:
    store.finalize()
    d = store.dict
    terms = np.unique(np.concatenate([store.s, store.o]))
    term_to_vertex = {int(t): i for i, t in enumerate(terms)}
    remap = np.full(d.n_terms, -1, dtype=np.int64)
    remap[terms] = np.arange(terms.shape[0])
    src = remap[store.s]
    dst = remap[store.o]
    el = store.p.astype(np.int64)  # predicate ids ARE edge labels (bijective)
    n_el = d.n_predicates
    maps = TransformMaps(
        dict=d,
        term_to_vertex=term_to_vertex,
        vertex_to_term=terms.astype(np.int64),
        pred_to_elabel={i: i for i in range(n_el)},
        elabel_to_pred=np.arange(n_el, dtype=np.int64),
        kind="direct",
    )
    g = LabeledGraph.build(
        n_vertices=terms.shape[0],
        src=src,
        el=el,
        dst=dst,
        n_elabels=n_el,
        vlabel_sets=[()] * terms.shape[0],
        n_vlabels=0,
        numeric_value=_numeric_values(d, maps.vertex_to_term),
    )
    log.info("direct transform: %d vertices, %d edges", g.n_vertices, g.n_edges)
    return g, maps


def type_aware_transform(store: TripleStore) -> tuple[LabeledGraph, TransformMaps]:
    store.finalize()
    d = store.dict
    pid_type = d.predicate_id(RDF_TYPE)
    pid_sc = d.predicate_id(RDFS_SUBCLASSOF)
    is_type = store.p == pid_type if pid_type is not None else np.zeros(store.n_triples, bool)
    is_sc = store.p == pid_sc if pid_sc is not None else np.zeros(store.n_triples, bool)
    plain = ~(is_type | is_sc)

    # --- vertex label space: objects of type/subClassOf triples (+ their subjects
    # for subClassOf, since classes are labels on both sides of the hierarchy).
    class_terms = np.unique(
        np.concatenate(
            [store.o[is_type], store.o[is_sc], store.s[is_sc]]
        )
    ) if (is_type.any() or is_sc.any()) else np.zeros(0, dtype=store.o.dtype)
    class_term_to_vlabel = {int(t): i for i, t in enumerate(class_terms)}
    n_vlabels = class_terms.shape[0]

    # --- class hierarchy from subClassOf triples
    hierarchy = ClassHierarchy()
    for sterm, oterm in zip(store.s[is_sc], store.o[is_sc]):
        hierarchy.add_subclass(class_term_to_vlabel[int(sterm)], class_term_to_vlabel[int(oterm)])

    # --- vertex set: subjects/objects of T' plus subjects of T'_t (Def. 3.1).
    vertex_terms = np.unique(
        np.concatenate([store.s[plain], store.o[plain], store.s[is_type]])
    )
    term_to_vertex = {int(t): i for i, t in enumerate(vertex_terms)}
    remap = np.full(d.n_terms, -1, dtype=np.int64)
    remap[vertex_terms] = np.arange(vertex_terms.shape[0])

    # --- per-vertex label sets: direct types expanded through the closure
    direct_types: list[set[int]] = [set() for _ in range(vertex_terms.shape[0])]
    for sterm, oterm in zip(store.s[is_type], store.o[is_type]):
        v = remap[int(sterm)]
        if v >= 0:
            direct_types[v].add(class_term_to_vlabel[int(oterm)])
    vlabel_sets = [tuple(hierarchy.expand_types(ts)) if ts else () for ts in direct_types]

    # --- edge label space: predicates of T' only (F_EL domain is P')
    plain_preds = np.unique(store.p[plain])
    pred_to_elabel = {int(p): i for i, p in enumerate(plain_preds)}
    el_remap = np.full(d.n_predicates, -1, dtype=np.int64)
    el_remap[plain_preds] = np.arange(plain_preds.shape[0])

    src = remap[store.s[plain]]
    dst = remap[store.o[plain]]
    el = el_remap[store.p[plain]]
    maps = TransformMaps(
        dict=d,
        term_to_vertex=term_to_vertex,
        vertex_to_term=vertex_terms.astype(np.int64),
        pred_to_elabel=pred_to_elabel,
        elabel_to_pred=plain_preds.astype(np.int64),
        class_term_to_vlabel=class_term_to_vlabel,
        hierarchy=hierarchy,
        kind="type_aware",
    )
    g = LabeledGraph.build(
        n_vertices=vertex_terms.shape[0],
        src=src,
        el=el,
        dst=dst,
        n_elabels=plain_preds.shape[0],
        vlabel_sets=vlabel_sets,
        n_vlabels=n_vlabels,
        numeric_value=_numeric_values(d, maps.vertex_to_term),
    )
    log.info(
        "type-aware transform: %d vertices, %d edges, %d vertex labels",
        g.n_vertices,
        g.n_edges,
        n_vlabels,
    )
    return g, maps
