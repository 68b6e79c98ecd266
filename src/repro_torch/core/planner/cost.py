"""Cost model: per-edge fanout and per-vertex frequency estimates.

All estimates come from the graph's cached :class:`~repro_torch.stats.GraphStats`
(built once per graph) instead of the ad-hoc inline recomputation the old
``core.plan`` helpers did on every ``build_plan`` call.  The unit of cost
is *expected rows produced per input row* when expanding a query edge —
exactly what the executor's capacity presizing consumes as ``est_fanout``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.query import QueryGraph
from repro_torch.index import get_summary
from repro_torch.rdf.graph import LabeledGraph
from repro_torch.stats import GraphStats, get_stats

# a bound vertex keeps at most one row per input row; model it as strongly
# selective rather than zero so plans still prefer genuinely cheap edges
_BOUND_SELECTIVITY = 0.05
_LABEL_SELECTIVITY_FLOOR = 0.01

_UNSET = object()


class CostModel:
    """Fanout / frequency / candidate estimates for one (graph, stats) pair.

    ``observed`` optionally carries workload feedback from
    :mod:`repro_torch.obs.workload`: per-edge observed ``(surviving, raw)``
    fanouts keyed ``(child, parent, elabel, forward)`` over query-vertex
    indices.  When an expansion matches a key, the observed surviving
    fanout replaces the static estimate in :meth:`edge_cost`, so an
    order-search re-run ranks edges by what actually happened instead of
    what the graph statistics predicted.  Purely an estimator override —
    it never changes which rows a plan produces.
    """

    def __init__(self, g: LabeledGraph, stats: GraphStats | None = None,
                 observed: dict[tuple[int, int, int, bool],
                                tuple[float, float]] | None = None):
        self.g = g
        self.stats = stats if stats is not None else get_stats(g)
        self.observed = observed or {}
        self._summary = _UNSET

    def observed_fanout(self, q: QueryGraph, ei: int,
                        parent: int) -> tuple[float, float] | None:
        """Workload-observed (surviving, raw) fanout for expanding edge
        ``ei`` away from ``parent``, or ``None`` when unobserved."""
        if not self.observed:
            return None
        e = q.edges[ei]
        forward = e.u == parent
        child = e.v if forward else e.u
        return self.observed.get((child, parent, e.elabel, forward))

    @property
    def summary(self):
        """The graph's (class, predicate, class) summary — lazily resolved
        because most CostModel uses never reach edge_cost."""
        if self._summary is _UNSET:
            self._summary = get_summary(self.g)
        return self._summary

    # ---------------------------------------------------------- vertex side
    def vertex_freq(self, q: QueryGraph, u: int) -> float:
        """Candidate-set size estimate for query vertex ``u`` (paper's
        freq(g, L(u)); predicate-index sizes for label-free vertices)."""
        qv = q.vertices[u]
        if qv.bound_id >= 0:
            return 1.0
        if qv.bound_id == -2:  # constant missing from data
            return 0.0
        if qv.labels:
            return float(self.stats.freq(qv.labels))
        # label-free: smallest predicate-index side among incident edges
        best = float(self.g.n_vertices)
        for e in q.edges:
            if e.elabel < 0:
                continue
            if e.u == u:
                best = min(best, float(self.stats.pred_sources(e.elabel, True)))
            if e.v == u:
                best = min(best, float(self.stats.pred_sources(e.elabel, False)))
        return best

    def candidates(self, q: QueryGraph, u: int) -> np.ndarray:
        """Materialized start-candidate set for query vertex ``u``."""
        g = self.g
        qv = q.vertices[u]
        if qv.bound_id >= 0:
            cand = np.array([qv.bound_id], dtype=np.int32)
            if qv.labels:  # ID + labels: verify label containment
                bm = g.label_bitmap[qv.bound_id]
                for lbl in qv.labels:
                    if not (bm[lbl >> 5] >> np.uint32(lbl & 31)) & np.uint32(1):
                        return np.zeros(0, dtype=np.int32)
            return cand
        if qv.bound_id == -2:
            return np.zeros(0, dtype=np.int32)
        if qv.labels:
            return g.candidates_with_labels(list(qv.labels))
        # label-free: smallest predicate-index side among incident edges
        best: np.ndarray | None = None
        for e in q.edges:
            if e.elabel < 0:
                continue
            subs, objs = g.predicate_index(e.elabel)
            side = subs if e.u == u else (objs if e.v == u else None)
            if side is not None and (best is None or side.shape[0] < best.shape[0]):
                best = side
        if best is not None:
            return best.astype(np.int32)
        return np.arange(g.n_vertices, dtype=np.int32)

    # ------------------------------------------------------------ edge side
    def edge_cost(self, q: QueryGraph, ei: int, parent: int) -> float:
        """Expected rows per input row when expanding edge ``ei`` away from
        ``parent``.  When both endpoints carry labels and the graph has a
        summary (:mod:`repro_torch.index.summary`), the per-(class, predicate,
        class) edge count over the parent class's population is the
        estimate — real join selectivity instead of the global
        label-frequency discount; otherwise the average (predicate,
        direction) fanout discounted by the child's label selectivity."""
        e = q.edges[ei]
        forward = e.u == parent
        child = e.v if forward else e.u
        obs = self.observed.get((child, parent, e.elabel, forward))
        if obs is not None:
            return obs[0]
        qv = q.vertices[child]
        est = self.stats.avg_fanout(e.elabel, forward)
        if qv.bound_id >= 0:
            est = min(est, _BOUND_SELECTIVITY)
        elif qv.labels:
            sel = None
            if self.summary is not None:
                sel = self.summary.est_fanout(
                    e.elabel, forward, q.vertices[parent].labels, qv.labels)
            if sel is not None:
                est = max(sel, 1e-4)
            else:
                est *= max(_LABEL_SELECTIVITY_FLOOR,
                           self.stats.label_selectivity(qv.labels) * 4.0)
        return est

    def choose_start_vertex(self, q: QueryGraph, component: list[int]) -> int:
        """rank(u) = freq(g, L(u)) / deg(u) — the paper's start-vertex score."""
        adj = q.adjacency()
        best_u, best_score = component[0], float("inf")
        for u in component:
            deg = max(1, len(adj[u]))
            score = self.vertex_freq(q, u) / deg
            if score < best_score:
                best_score = score
                best_u = u
        return best_u
