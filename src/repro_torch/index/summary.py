"""Coarse summary graph over vertex classes.

Every data vertex gets one *primary class* — its smallest vertex label,
or the extra "unlabeled" bucket ``n_vlabels`` — and the summary graph is
the dense count table ``counts[cs, el, co]`` = number of data edges
``s --el--> o`` with ``class(s) = cs`` and ``class(o) = co``.  The
planner's cost model divides by the parent class's population to get
*expected rows per input row* for a join — a per-(class, predicate,
class) selectivity that replaces the global label-frequency discount
whenever both endpoints of a query edge carry labels.

The dense table is bounded by :data:`MAX_DENSE_CELLS`; graphs whose
``(n_vlabels + 1)^2 * n_elabels`` exceeds it simply get no summary
(``build`` returns ``None``) and the cost model falls back to label
frequencies — estimates only, never correctness.

Snapshots consult their base graph's summary (estimate drift across a
delta is tolerated, exactly like ``GraphStats``); compaction patches the
table exactly via :func:`patch_summary`: delta edges are applied at old
classes, then one masked pass over the new CSR re-keys the edges whose
endpoint classes changed.  Tests assert the patch equals a rebuild.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.rdf.graph import LabeledGraph

MAX_DENSE_CELLS = 1 << 22  # dense (C, n_el, C) int64 table bound (~32 MB)

_MISSING = object()  # cache sentinel: "build was attempted, returned None"


def primary_classes(g: LabeledGraph) -> np.ndarray:
    """Smallest label per vertex; ``n_vlabels`` for label-free vertices."""
    classes = np.full(g.n_vertices, g.n_vlabels, dtype=np.int32)
    for li in range(g.n_vlabels - 1, -1, -1):
        has = (g.label_bitmap[:, li >> 5] >> np.uint32(li & 31)) & np.uint32(1)
        classes[has.astype(bool)] = li
    return classes


@dataclass
class SummaryGraph:
    graph: LabeledGraph
    n_classes: int  # n_vlabels + 1 (last class = unlabeled bucket)
    classes: np.ndarray  # int32 [V] primary class per vertex
    counts: np.ndarray  # int64 [C, n_el, C] edge counts
    class_count: np.ndarray  # int64 [C] vertices per class

    @staticmethod
    def build(g: LabeledGraph) -> "SummaryGraph | None":
        c = g.n_vlabels + 1
        ne = max(1, g.n_elabels)
        if c * c * ne > MAX_DENSE_CELLS:
            return None
        classes = primary_classes(g)
        counts = np.zeros((c, ne, c), dtype=np.int64)
        rows = np.repeat(np.arange(g.n_vertices, dtype=np.int64),
                         np.diff(g.out.indptr_all))
        if rows.size:
            key = ((classes[rows].astype(np.int64) * ne
                    + g.out.lab_all.astype(np.int64)) * c
                   + classes[g.out.nbr_all.astype(np.int64)])
            counts = np.bincount(key, minlength=c * ne * c) \
                .reshape(c, ne, c).astype(np.int64)
        class_count = np.bincount(classes, minlength=c).astype(np.int64)
        return SummaryGraph(g, c, classes, counts, class_count)

    def est_fanout(self, el: int, forward: bool,
                   parent_labels: tuple[int, ...],
                   child_labels: tuple[int, ...]) -> float | None:
        """Expected rows per input row expanding ``el`` from a parent of
        class ``min(parent_labels)`` to children of class
        ``min(child_labels)``; ``None`` when either side is label-free or
        the predicate is unknown to the table (the caller falls back to
        the label-frequency estimate)."""
        if not parent_labels or not child_labels:
            return None
        if el < 0 or el >= self.counts.shape[1]:
            return None
        cp, cc = min(parent_labels), min(child_labels)
        if cp >= self.n_classes or cc >= self.n_classes:
            return None
        num = self.counts[cp, el, cc] if forward else self.counts[cc, el, cp]
        den = self.class_count[cp]
        if den <= 0:
            return 0.0
        return float(num) / float(den)


def get_summary(g) -> SummaryGraph | None:
    """The (cached) summary graph of ``g`` — ``None`` when the class space
    is too large to summarize.  Snapshots resolve to their base graph."""
    if getattr(g, "is_snapshot", False):
        return get_summary(g.base)
    s = getattr(g, "_summary_graph", _MISSING)
    if s is _MISSING or (s is not None and s.graph is not g):
        s = SummaryGraph.build(g)
        g._summary_graph = s
    return s


def patch_summary(old: SummaryGraph | None, new_g: LabeledGraph, *,
                  ins: np.ndarray, tombs: np.ndarray,
                  label_changes) -> SummaryGraph | None:
    """Exact summary for the compacted graph.

    Two phases keep it O(|delta| + |edges touching re-classed vertices|):
    (a) inserted/tombstoned edges are counted in/out at *old* endpoint
    classes, turning the old-graph table into the new-edge-set table
    under old classes; (b) one masked pass over the new out-CSR re-keys
    every edge incident to a vertex whose class changed.  New vertices
    take their new class in both phases, so phase (b) never touches them.
    """
    if old is None:
        return None
    c = old.n_classes
    if c != new_g.n_vlabels + 1:  # label space changed: classes incomparable
        return SummaryGraph.build(new_g)
    ne = max(1, new_g.n_elabels)
    if c * c * ne > MAX_DENSE_CELLS:
        return None
    counts = old.counts
    if ne > counts.shape[1]:
        counts = np.concatenate(
            [counts, np.zeros((c, ne - counts.shape[1], c), np.int64)],
            axis=1)
    else:
        counts = counts.copy()

    v_old = old.classes.shape[0]
    oc = np.concatenate([old.classes,
                         np.full(new_g.n_vertices - v_old, c - 1, np.int32)])
    nc = oc.copy()
    for vid, _old_ls, new_ls in label_changes:
        nc[vid] = min(new_ls) if new_ls else c - 1
    oc[v_old:] = nc[v_old:]  # new vertices: "old" class := new class

    flat = counts.reshape(-1)
    for coo3, sign in ((ins, 1), (tombs, -1)):
        if coo3.size:
            s, el, o = (coo3[:, i].astype(np.int64) for i in range(3))
            key = (oc[s].astype(np.int64) * ne + el) * c + oc[o]
            flat += sign * np.bincount(key, minlength=flat.size)

    changed = oc != nc
    if changed.any():
        rows = np.repeat(np.arange(new_g.n_vertices, dtype=np.int64),
                         np.diff(new_g.out.indptr_all))
        if rows.size:
            w = new_g.out.nbr_all.astype(np.int64)
            el = new_g.out.lab_all.astype(np.int64)
            m = changed[rows] | changed[w]
            if m.any():
                rows, w, el = rows[m], w[m], el[m]
                flat -= np.bincount(
                    (oc[rows].astype(np.int64) * ne + el) * c + oc[w],
                    minlength=flat.size)
                flat += np.bincount(
                    (nc[rows].astype(np.int64) * ne + el) * c + nc[w],
                    minlength=flat.size)

    class_count = np.bincount(nc, minlength=c).astype(np.int64)
    return SummaryGraph(new_g, c, nc, counts, class_count)
