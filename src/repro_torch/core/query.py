"""Query graphs: SPARQL basic graph patterns transformed per §3.2 / §4.1.

``build_query_graph(triples, maps)`` applies the SAME transformation to the
query that was applied to the data (Definition 3's requirement that
F_ID = F'_ID, F_VL = F'_VL, F_EL = F'_EL):

- type-aware maps: ``?x rdf:type C`` triples vanish into ``L(?x) ∋ F_VL(C)``;
  everything else becomes a query edge.  A constant subject/object becomes a
  query vertex with a bound ID attribute; a variable predicate becomes a
  blank edge label with a named predicate variable (e-graph homomorphism's
  M_e binding).
- direct maps: type triples stay ordinary edges; class IRIs are plain bound
  vertices.

``unsat`` is set when a constant term does not exist in the data at all (the
query provably has zero solutions — the executor short-circuits).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.rdf.dictionary import RDF_TYPE, RDFS_SUBCLASSOF
from repro_torch.rdf.sparql import Iri, Literal, TriplePattern, Var
from repro_torch.rdf.transform import TransformMaps


@dataclass
class QVertex:
    var: str | None  # variable name, None for constants
    labels: tuple[int, ...] = ()  # required vertex labels (type-aware)
    bound_id: int = -1  # data vertex id (ID attribute), -1 if free
    # original term string for diagnostics
    term: str | None = None
    # parameter slot when the bound id is a plan parameter (-1 = literal);
    # the executor reads the actual id from params[param_slot] at run time
    param_slot: int = -1


@dataclass
class QEdge:
    u: int  # subject query-vertex index
    v: int  # object query-vertex index
    elabel: int  # edge label id, -1 = blank (predicate variable)
    pvar: str | None = None  # predicate variable name when elabel == -1


@dataclass
class QueryGraph:
    vertices: list[QVertex] = field(default_factory=list)
    edges: list[QEdge] = field(default_factory=list)
    var_to_vertex: dict[str, int] = field(default_factory=dict)
    pvars: list[str] = field(default_factory=list)
    unsat: bool = False
    # a parameterized constant was missing from the dictionary — the family
    # representative cannot anchor cost estimation (callers treat the shape
    # as ineligible for parameterized compilation rather than unsat)
    param_missing: bool = False

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    def vertex_for_var(self, name: str) -> int | None:
        return self.var_to_vertex.get(name)

    def adjacency(self) -> list[list[tuple[int, int]]]:
        """Undirected incidence: vertex -> [(edge_idx, other_vertex)]."""
        adj: list[list[tuple[int, int]]] = [[] for _ in self.vertices]
        for ei, e in enumerate(self.edges):
            adj[e.u].append((ei, e.v))
            adj[e.v].append((ei, e.u))
        return adj

    def connected_components(self) -> list[list[int]]:
        seen = [False] * self.n_vertices
        adj = self.adjacency()
        comps = []
        for s in range(self.n_vertices):
            if seen[s]:
                continue
            comp = [s]
            seen[s] = True
            stack = [s]
            while stack:
                cur = stack.pop()
                for _, w in adj[cur]:
                    if not seen[w]:
                        seen[w] = True
                        comp.append(w)
                        stack.append(w)
            comps.append(comp)
        return comps


class QueryBuildError(ValueError):
    pass


def build_query_graph(triples: list[TriplePattern], maps: TransformMaps,
                      param_ids: dict[int, int] | None = None) -> QueryGraph:
    """``param_ids`` maps ``id(term)`` of hoisted constant occurrences to
    their parameter slot (the parser builds a fresh term object per
    occurrence, so object identity distinguishes occurrences of equal
    constants).  A parameterized occurrence still resolves its bound id (the
    representative's constant anchors cost estimation) but a miss sets
    ``param_missing`` instead of ``unsat`` — other family members may well
    resolve."""
    q = QueryGraph()

    def vertex_of(term) -> int:
        if isinstance(term, Var):
            idx = q.var_to_vertex.get(term.name)
            if idx is None:
                idx = len(q.vertices)
                q.vertices.append(QVertex(var=term.name, term="?" + term.name))
                q.var_to_vertex[term.name] = idx
            return idx
        # constant: IRI or literal — bound vertex (the ID attribute)
        text = term.value if isinstance(term, Iri) else f'"{term.value}"'
        vid = maps.vertex_of(text)
        idx = len(q.vertices)
        slot = -1 if param_ids is None else param_ids.get(id(term), -1)
        q.vertices.append(
            QVertex(var=None, bound_id=vid if vid is not None else -2,
                    term=text, param_slot=slot)
        )
        if vid is None:
            if slot >= 0:
                q.param_missing = True
            else:
                q.unsat = True
        return idx

    type_aware = maps.kind == "type_aware"
    for tp in triples:
        pred = tp.p
        if isinstance(pred, Iri) and pred.value == RDF_TYPE and type_aware:
            if isinstance(tp.o, Var):
                raise QueryBuildError(
                    "variable rdf:type objects need the direct transformation "
                    "(type edges are folded away under type-aware transform)"
                )
            if not isinstance(tp.s, (Var,)):
                # constant subject with type assertion: fold into its labels too
                sv = vertex_of(tp.s)
                lbl = maps.vlabel_of(tp.o.value)
                if lbl is None:
                    q.unsat = True
                else:
                    q.vertices[sv].labels = tuple(sorted({*q.vertices[sv].labels, lbl}))
                continue
            sv = vertex_of(tp.s)
            lbl = maps.vlabel_of(tp.o.value)
            if lbl is None:
                q.unsat = True
            else:
                q.vertices[sv].labels = tuple(sorted({*q.vertices[sv].labels, lbl}))
            continue
        if isinstance(pred, Iri) and pred.value == RDFS_SUBCLASSOF and type_aware:
            raise QueryBuildError(
                "rdf:subClassOf query edges are not representable after the "
                "type-aware transformation; use the direct transformation"
            )
        sv = vertex_of(tp.s)
        ov = vertex_of(tp.o)
        if isinstance(pred, Var):
            if pred.name not in q.pvars:
                q.pvars.append(pred.name)
            q.edges.append(QEdge(sv, ov, -1, pvar=pred.name))
        else:
            if not isinstance(pred, Iri):
                raise QueryBuildError("literal in predicate position")
            el = maps.elabel_of(pred.value)
            if el is None:
                q.unsat = True
                el = -2  # sentinel: known-missing predicate
            q.edges.append(QEdge(sv, ov, el if el is not None else -2))
    return q
