"""Brute-force reference matcher — the correctness oracle for the executor.

Pure-python recursive backtracking over the same LabeledGraph + QueryGraph
representations, implementing Definition 1 (subgraph isomorphism) and
Definition 2 (e-graph homomorphism) directly.  O(n^|V(q)|) — test-sized
graphs only.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.query import QueryGraph
from repro_torch.rdf.graph import LabeledGraph


def _has_labels(g: LabeledGraph, v: int, labels) -> bool:
    for lbl in labels:
        if not (g.label_bitmap[v, lbl >> 5] >> np.uint32(lbl & 31)) & np.uint32(1):
            return False
    return True


def _edge_labels(g: LabeledGraph, u: int, v: int) -> list[int]:
    nbrs, labs = g.out.slice_all(u)
    return [int(l) for w, l in zip(nbrs, labs) if int(w) == v]


def enumerate_matches(
    g: LabeledGraph,
    q: QueryGraph,
    semantics: str = "hom",
) -> list[tuple[tuple[int, ...], tuple[int, ...]]]:
    """All solutions as (vertex bindings, pvar bindings) tuples, sorted."""
    if q.unsat:
        return []
    nq = q.n_vertices
    sols: list[tuple[tuple[int, ...], tuple[int, ...]]] = []
    binding = [-1] * nq
    pbind: dict[str, int] = {}

    def vertex_ok(qi: int, v: int) -> bool:
        qv = q.vertices[qi]
        if qv.bound_id >= 0 and v != qv.bound_id:
            return False
        if qv.bound_id == -2:
            return False
        if not _has_labels(g, v, qv.labels):
            return False
        if semantics == "iso":
            for other_qi, other_v in enumerate(binding):
                if other_qi != qi and other_v == v:
                    return False
        return True

    def edges_ok() -> bool:
        # full check over completely bound edges with current partial binding
        for e in q.edges:
            bu, bv = binding[e.u], binding[e.v]
            if bu < 0 or bv < 0:
                continue
            labels = _edge_labels(g, bu, bv)
            if e.elabel >= 0:
                if e.elabel not in labels:
                    return False
            elif e.pvar is not None:
                want = pbind.get(e.pvar)
                if want is not None:
                    if want not in labels:
                        return False
        return True

    def rec(qi: int):
        if qi == nq:
            # assign predicate variables (may branch over multiple labels)
            free_edges = [e for e in q.edges if e.pvar is not None]

            def assign(idx: int, cur: dict[str, int]):
                if idx == len(free_edges):
                    sols.append(
                        (tuple(binding),
                         tuple(cur.get(pv, -1) for pv in q.pvars))
                    )
                    return
                e = free_edges[idx]
                labels = _edge_labels(g, binding[e.u], binding[e.v])
                want = cur.get(e.pvar)
                for lbl in sorted(set(labels)):
                    if want is not None and lbl != want:
                        continue
                    nxt = dict(cur)
                    nxt[e.pvar] = lbl
                    assign(idx + 1, nxt)

            assign(0, {})
            return
        for v in range(g.n_vertices):
            if not vertex_ok(qi, v):
                continue
            binding[qi] = v
            if edges_ok():
                rec(qi + 1)
            binding[qi] = -1

    rec(0)
    return sorted(set(sols))
