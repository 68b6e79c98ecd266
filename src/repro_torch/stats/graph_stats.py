"""Unified graph statistics for the cost-based planner (paper §4.2).

``GraphStats`` is built once per :class:`~repro_torch.rdf.graph.LabeledGraph` and
cached on it (``get_stats``).  It centralizes every number the planner used
to recompute inline on each ``build_plan`` call:

- per-predicate edge counts and distinct subject/object counts (the
  predicate index sizes, without materializing the index arrays);
- per-(predicate, direction) average and maximum fanout;
- vertex-label frequency (``freq(g, l)``) and a label-cooccurrence table
  giving exact two-label intersection sizes (multi-label frequencies fall
  back to the tightest pairwise bound, with an exact memoized path for the
  label sets queries actually mention);
- a bounded-sample join-cardinality estimator: given a sample of source
  vertices, the observed mean fanout under a (predicate, direction) — the
  paper's candidate-region-size estimation distilled to one probe.

Everything is derived from arrays the graph already holds; building is a
few vectorized passes over the per-label CSR offset tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.rdf.graph import LabeledGraph

# above this many vertex labels the dense cooccurrence table is skipped
# (planner falls back to min(label_freq) bounds + the exact memo)
_MAX_DENSE_COOC = 512
# default sample bound for sampled_fanout
_SAMPLE_BOUND = 256


@dataclass
class GraphStats:
    graph: LabeledGraph = field(repr=False)
    n_vertices: int
    n_edges: int
    n_elabels: int
    n_vlabels: int
    # per-predicate: edge count, distinct subjects/objects
    pred_edges: np.ndarray  # int64 [n_elabels]
    pred_subjects: np.ndarray  # int64 [n_elabels]
    pred_objects: np.ndarray  # int64 [n_elabels]
    # per-(predicate, direction) fanout
    fanout_avg_out: np.ndarray  # float64 [n_elabels]
    fanout_avg_in: np.ndarray
    fanout_max_out: np.ndarray  # int64 [n_elabels]
    fanout_max_in: np.ndarray
    # vertex-label tables
    label_freq: np.ndarray  # int64 [n_vlabels]
    label_cooc: np.ndarray | None  # int64 [n_vlabels, n_vlabels] or None
    avg_degree: float
    # memoized exact multi-label frequencies (small: only label sets that
    # queries mention)
    _freq_memo: dict[tuple[int, ...], int] = field(default_factory=dict,
                                                   repr=False)

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(g: LabeledGraph) -> "GraphStats":
        if g.n_elabels:
            deg_out = np.diff(g.out.indptr_el, axis=1)  # [n_elabels, n_vertices]
            deg_in = np.diff(g.inc.indptr_el, axis=1)
            pred_edges = deg_out.sum(axis=1)
            pred_subjects = (deg_out > 0).sum(axis=1)
            pred_objects = (deg_in > 0).sum(axis=1)
            fanout_avg_out = pred_edges / np.maximum(1, pred_subjects)
            fanout_avg_in = pred_edges / np.maximum(1, pred_objects)
            fanout_max_out = deg_out.max(axis=1, initial=0)
            fanout_max_in = deg_in.max(axis=1, initial=0)
        else:
            z = np.zeros(0, np.int64)
            pred_edges = pred_subjects = pred_objects = z
            fanout_avg_out = fanout_avg_in = np.zeros(0, np.float64)
            fanout_max_out = fanout_max_in = z
        label_freq = (np.diff(g.vl_indptr).astype(np.int64)[: g.n_vlabels]
                      if g.n_vlabels else np.zeros(0, np.int64))
        label_cooc = None
        if 0 < g.n_vlabels <= _MAX_DENSE_COOC:
            # chunked M^T M over the unpacked label bitmap: vectorized, and
            # peak extra memory stays at chunk x n_vlabels float32
            cooc = np.zeros((g.n_vlabels, g.n_vlabels), dtype=np.float64)
            chunk = 1 << 16
            for lo in range(0, g.n_vertices, chunk):
                words = g.label_bitmap[lo : lo + chunk]
                bits = np.unpackbits(
                    words.view(np.uint8), axis=1, bitorder="little"
                )[:, : g.n_vlabels].astype(np.float32)
                cooc += bits.T @ bits
            label_cooc = cooc.astype(np.int64)
        return GraphStats(
            graph=g,
            n_vertices=g.n_vertices,
            n_edges=g.n_edges,
            n_elabels=g.n_elabels,
            n_vlabels=g.n_vlabels,
            pred_edges=pred_edges,
            pred_subjects=pred_subjects,
            pred_objects=pred_objects,
            fanout_avg_out=fanout_avg_out,
            fanout_avg_in=fanout_avg_in,
            fanout_max_out=fanout_max_out,
            fanout_max_in=fanout_max_in,
            label_freq=label_freq,
            label_cooc=label_cooc,
            avg_degree=float(g.out.degree.mean()) if g.n_vertices else 0.0,
        )

    # ------------------------------------------------------------- predicates
    def avg_fanout(self, el: int, forward: bool) -> float:
        """Mean out-degree of subjects (forward) / in-degree of objects."""
        if el < 0 or el >= self.n_elabels:
            return self.avg_degree + 1.0
        return float((self.fanout_avg_out if forward
                      else self.fanout_avg_in)[el])

    def max_fanout(self, el: int, forward: bool) -> int:
        if el < 0 or el >= self.n_elabels:
            return self.n_vertices
        return int((self.fanout_max_out if forward
                    else self.fanout_max_in)[el])

    def pred_sources(self, el: int, forward: bool) -> int:
        """Distinct subjects (forward) / objects (backward) of predicate el."""
        if el < 0 or el >= self.n_elabels:
            return self.n_vertices
        return int((self.pred_subjects if forward else self.pred_objects)[el])

    # ----------------------------------------------------------- label tables
    def freq(self, labels: Sequence[int]) -> int:
        """|∩_l V_l| — exact for 0/1/2 labels, exact-memoized beyond."""
        labels = tuple(sorted(labels))
        if not labels:
            return self.n_vertices
        if len(labels) == 1:
            return int(self.label_freq[labels[0]])
        if len(labels) == 2 and self.label_cooc is not None:
            return int(self.label_cooc[labels[0], labels[1]])
        hit = self._freq_memo.get(labels)
        if hit is None:
            hit = self.graph.freq(list(labels))
            self._freq_memo[labels] = hit
        return hit

    def label_selectivity(self, labels: Sequence[int]) -> float:
        if not labels:
            return 1.0
        return max(1.0, float(self.freq(labels))) / max(1, self.n_vertices)

    # ----------------------------------------------- sampled join cardinality
    def sampled_fanout(self, el: int, forward: bool,
                       sources: np.ndarray,
                       bound: int = _SAMPLE_BOUND) -> float:
        """Bounded-sample join-cardinality estimate: mean (el, direction)
        fanout over at most ``bound`` of the given source vertices.  This is
        the planner's probe for "how many rows does expanding this edge from
        *these* candidates produce", vs. the whole-graph average.

        Sources beyond the stats' vertex space (snapshot-born vertices when
        planning against a live store) are dropped from the sample — the
        estimate stays an estimate, never an IndexError."""
        if sources.size == 0:
            return 0.0
        sample = sources[:bound].astype(np.int64)
        sample = sample[sample < self.graph.n_vertices]
        if sample.size == 0:
            return self.avg_fanout(el, forward)
        d = self.graph.out if forward else self.graph.inc
        if el < 0 or el >= self.n_elabels:
            return float(d.degree[sample].mean())
        degs = d.indptr_el[el, sample + 1] - d.indptr_el[el, sample]
        return float(degs.mean())

    def snapshot(self) -> dict:
        """Small JSON-able summary (diagnostics / /healthz)."""
        return {
            "n_vertices": self.n_vertices,
            "n_edges": self.n_edges,
            "n_elabels": self.n_elabels,
            "n_vlabels": self.n_vlabels,
            "avg_degree": round(self.avg_degree, 3),
            "max_fanout_out": int(self.fanout_max_out.max(initial=0)),
            "max_fanout_in": int(self.fanout_max_in.max(initial=0)),
        }


def get_stats(g) -> GraphStats:
    """Return the graph's cached ``GraphStats``, building it on first use.

    The cache lives on the graph object itself, so a graph rebuilt in place
    (new object) naturally gets fresh statistics.  A live-store snapshot
    resolves to its *base* graph's stats: planner estimates tolerate the
    (small, bounded-by-compaction)
    drift, and every correctness-relevant quantity — candidate sets,
    predicate indexes — is answered exactly by the snapshot itself.
    """
    if getattr(g, "is_snapshot", False):
        return get_stats(g.base)
    s = getattr(g, "_graph_stats", None)
    if s is None or s.graph is not g:
        s = GraphStats.build(g)
        g._graph_stats = s  # type: ignore[attr-defined]
    return s


# --------------------------------------------------------------------------
# incremental maintenance (store compaction)
# --------------------------------------------------------------------------


def _affected_pairs(ins: np.ndarray, tombs: np.ndarray,
                    col: int) -> tuple[np.ndarray, np.ndarray]:
    """Distinct (el, vertex) pairs touched by the delta, with the vertex
    taken from COO column ``col`` (0 = subjects, 2 = objects)."""
    parts = [a[:, (1, col)] for a in (ins, tombs) if a.shape[0]]
    if not parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pairs = np.unique(np.concatenate(parts), axis=0)
    return pairs[:, 0], pairs[:, 1]


def _el_deg(g: LabeledGraph, els: np.ndarray, vs: np.ndarray,
            forward: bool) -> np.ndarray:
    d = g.out if forward else g.inc
    deg = np.zeros(els.shape[0], dtype=np.int64)
    ok = (els < g.n_elabels) & (vs < g.n_vertices)
    if ok.any():
        deg[ok] = (d.indptr_el[els[ok], vs[ok] + 1]
                   - d.indptr_el[els[ok], vs[ok]])
    return deg


def patch_stats(old: GraphStats, new_g: LabeledGraph, *, ins: np.ndarray,
                tombs: np.ndarray,
                label_changes: list[tuple[int, tuple, tuple]]) -> GraphStats:
    """Exact incremental ``GraphStats`` maintenance across a compaction.

    ``ins`` / ``tombs`` are the folded delta as int64 COO ``[k, 3]`` arrays
    of (src, el, dst) rows; ``label_changes`` lists ``(vertex, old_labels,
    new_labels)`` for every vertex whose label set changed (new vertices
    have ``old_labels == ()``).  Instead of the full O(n_elabels × V) diff
    passes and the O(V × L²) cooccurrence rebuild of
    :meth:`GraphStats.build`, only the touched (predicate, vertex) pairs
    and changed label sets are visited; the result is bit-identical to a
    from-scratch build (asserted by the store test suite).
    """
    old_g = old.graph
    n_el = new_g.n_elabels

    def extend(a: np.ndarray, fill=0) -> np.ndarray:
        if a.shape[0] >= n_el:
            return a.astype(np.int64).copy()
        return np.concatenate(
            [a.astype(np.int64), np.full(n_el - a.shape[0], fill, np.int64)])

    pred_edges = extend(old.pred_edges)
    if ins.shape[0]:
        pred_edges += np.bincount(ins[:, 1], minlength=n_el)
    if tombs.shape[0]:
        pred_edges -= np.bincount(tombs[:, 1], minlength=n_el)

    counts = {}
    maxes = {}
    for name, col, forward in (("pred_subjects", 0, True),
                               ("pred_objects", 2, False)):
        side = extend(getattr(old, name))
        els, vs = _affected_pairs(ins, tombs, col)
        old_deg = _el_deg(old_g, els, vs, forward)
        new_deg = _el_deg(new_g, els, vs, forward)
        became = ((old_deg == 0) & (new_deg > 0)).astype(np.int64)
        died = ((old_deg > 0) & (new_deg == 0)).astype(np.int64)
        if els.size:
            side += np.bincount(els, weights=became,
                                minlength=n_el).astype(np.int64)
            side -= np.bincount(els, weights=died,
                                minlength=n_el).astype(np.int64)
        counts[name] = side
        # per-el max fanout: grows to max(old, touched new degs); a delete
        # that may have clipped the old max forces one O(V) row recompute
        fmax = extend(getattr(old, "fanout_max_out" if forward
                              else "fanout_max_in"))
        if els.size:
            for e in np.unique(els):
                m = els == e
                cand = int(new_deg[m].max(initial=0))
                lowered = bool(((old_deg[m] == fmax[e])
                                & (new_deg[m] < old_deg[m])).any())
                if lowered:
                    d = new_g.out if forward else new_g.inc
                    fmax[e] = int(np.diff(d.indptr_el[e]).max(initial=0))
                else:
                    fmax[e] = max(int(fmax[e]), cand)
        maxes["out" if forward else "in"] = fmax

    label_freq = old.label_freq.astype(np.int64).copy()
    label_cooc = None if old.label_cooc is None else \
        old.label_cooc.astype(np.int64).copy()
    for _vid, old_ls, new_ls in label_changes:
        for ls, sign in ((old_ls, -1), (new_ls, 1)):
            if not ls:
                continue
            arr = np.asarray(ls, dtype=np.int64)
            label_freq[arr] += sign
            if label_cooc is not None:
                label_cooc[np.ix_(arr, arr)] += sign

    with np.errstate(divide="ignore", invalid="ignore"):
        fanout_avg_out = pred_edges / np.maximum(1, counts["pred_subjects"])
        fanout_avg_in = pred_edges / np.maximum(1, counts["pred_objects"])
    return GraphStats(
        graph=new_g,
        n_vertices=new_g.n_vertices,
        n_edges=new_g.n_edges,
        n_elabels=n_el,
        n_vlabels=new_g.n_vlabels,
        pred_edges=pred_edges,
        pred_subjects=counts["pred_subjects"],
        pred_objects=counts["pred_objects"],
        fanout_avg_out=fanout_avg_out,
        fanout_avg_in=fanout_avg_in,
        fanout_max_out=maxes["out"],
        fanout_max_in=maxes["in"],
        label_freq=label_freq,
        label_cooc=label_cooc,
        avg_degree=float(new_g.out.degree.mean()) if new_g.n_vertices else 0.0,
    )
