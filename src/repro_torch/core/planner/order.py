"""Matching-order search: greedy, sampled (paper §4.2), and subset-DP.

All searches produce an ordering of the *new* vertices to bind, given a set
of already-placed seed vertices (the start vertex for base plans; every
pre-bound base column for OPTIONAL extension plans):

- ``greedy_order`` — repeatedly bind the vertex reachable from the placed
  set through the cheapest edge (cost-model average fanout × selectivity);
- ``sampled_order`` — the paper's candidate-region-size estimation: walk
  tree edges over the *actual* start candidates with host numpy and pick
  the child with the fewest total candidates.  Predicate-variable edges are
  sampled through the plain (all-predicate) CSR instead of aborting the
  whole query, so one ``?p`` edge no longer forfeits sampling for every
  labeled edge around it;
- ``dp_order`` — exact dynamic program over placed-subsets (Held-Karp
  style) minimizing the estimated sum of intermediate table sizes; only
  attempted when the number of new vertices is ≤ ``DP_MAX_VERTICES``.

The greedy and DP searches rank edges through ``cm.edge_cost``, so
workload-observed fanout overrides (``CostModel.observed``, fed by
:mod:`repro_torch.obs.workload` q-error feedback) flow into order selection
automatically; ``sampled_order`` bypasses the cost model and is skipped
by the builder when feedback is active.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.planner.cost import CostModel
from repro_torch.core.query import QueryGraph
from repro_torch.rdf.graph import LabeledGraph

DP_MAX_VERTICES = 8
_SAMPLE_START = 256  # start candidates sampled for region estimation
_SAMPLE_CHILD = 4096  # bounded child gather per level


# --------------------------------------------------------------------------
# greedy
# --------------------------------------------------------------------------


def greedy_order(cm: CostModel, q: QueryGraph, adj, seeds: set[int],
                 targets: set[int], optional_rank: dict[int, int]) -> list[int]:
    """Order ``targets`` by repeated cheapest-frontier-edge selection."""
    placed = set(seeds)
    remaining = set(targets)
    order: list[int] = []
    while remaining:
        best_w, best_cost = None, float("inf")
        for p in placed:
            for ei, w in adj[p]:
                if w not in remaining:
                    continue
                cost = cm.edge_cost(q, ei, p)
                cost += 1e6 * optional_rank.get(w, 0)  # optionals last
                if cost < best_cost:
                    best_cost, best_w = cost, w
        if best_w is None:
            break
        placed.add(best_w)
        remaining.discard(best_w)
        order.append(best_w)
    return order


def pvar_first_order(cm: CostModel, q: QueryGraph, adj, seeds: set[int],
                     targets: set[int],
                     optional_rank: dict[int, int],
                     bound0: set[int] | None = None) -> list[int]:
    """Greedy order that walks unbound-predicate-variable edges as tree
    edges as early as possible.  Fallback when the estimate-driven order
    would leave two unbound-pvar edges converging on one vertex (which no
    single step can bind — the builder rejects such orders)."""
    placed = set(seeds)
    remaining = set(targets)
    bound: set[int] = set(bound0 or ())  # pvar indices bound so far
    order: list[int] = []
    while remaining:
        best = None  # (cost, w, pvar_idx)
        for p in placed:
            for ei, w in adj[p]:
                if w not in remaining:
                    continue
                e = q.edges[ei]
                pv = q.pvars.index(e.pvar) if e.pvar is not None else -1
                cost = cm.edge_cost(q, ei, p)
                if pv >= 0 and pv not in bound:
                    cost *= 1e-6  # bind fresh pvars via tree edges first
                cost += 1e6 * optional_rank.get(w, 0)
                if best is None or cost < best[0]:
                    best = (cost, w, pv)
        if best is None:
            break
        _, w, pv = best
        if pv >= 0:
            bound.add(pv)
        placed.add(w)
        remaining.discard(w)
        order.append(w)
    return order


# --------------------------------------------------------------------------
# sampled (candidate-region estimation)
# --------------------------------------------------------------------------


def sampled_order(
    g: LabeledGraph,
    q: QueryGraph,
    start: int,
    candidates: np.ndarray,
    optional_rank: dict[int, int],
) -> tuple[list[int], dict[int, float]] | None:
    """Candidate-region estimation over the first chunk of real candidates.

    Returns ``(order, fanout)`` where ``order`` includes ``start`` and
    ``fanout[w]`` is the observed expansion fanout (rows produced per input
    row, pre-filter) for the step that binds ``w`` — the real number the
    executor's capacity presizing wants.  Returns ``None`` only when the
    walk cannot cover the component (e.g. every sampled region dies out).
    """
    sample = candidates[: min(_SAMPLE_START, candidates.shape[0])].astype(np.int64)
    if sample.size == 0:
        return None
    placed = {start}
    cand_of: dict[int, np.ndarray] = {start: sample}
    order = [start]
    fanout: dict[int, float] = {}
    adj = q.adjacency()
    remaining = {v for v in range(q.n_vertices)} - placed
    # restrict to this component
    comp = set()
    stack = [start]
    comp.add(start)
    while stack:
        cur = stack.pop()
        for _, w in adj[cur]:
            if w not in comp:
                comp.add(w)
                stack.append(w)
    remaining &= comp
    while remaining:
        frontier: list[tuple[float, int, float, np.ndarray]] = []
        for p in list(placed):
            for ei, w in adj[p]:
                if w in placed or w not in remaining:
                    continue
                e = q.edges[ei]
                forward = e.u == p
                d = g.out if forward else g.inc
                vp = cand_of[p]
                if e.elabel < 0:
                    # predicate-variable edge: sample through the plain CSR
                    # (any predicate matches), instead of bailing out
                    starts = d.indptr_all[vp]
                    ends = d.indptr_all[vp + 1]
                    nbr = d.nbr_all
                else:
                    starts = d.indptr_el[e.elabel, vp]
                    ends = d.indptr_el[e.elabel, vp + 1]
                    nbr = d.nbr_el
                degs = ends - starts
                total = int(degs.sum())
                # gather up to a bounded number of children for the next level
                child = _gather_bounded(nbr, starts, degs, bound=_SAMPLE_CHILD)
                child = _filter_by_labels(g, child, q.vertices[w].labels)
                if q.vertices[w].bound_id >= 0:
                    child = child[child == q.vertices[w].bound_id]
                cost = float(total) + 1e3 * optional_rank.get(w, 0)
                raw_fanout = total / max(1, vp.shape[0])
                frontier.append((cost, w, raw_fanout, np.unique(child)))
        if not frontier:
            break
        frontier.sort(key=lambda t: t[:2])
        _, w, raw_fanout, child = frontier[0]
        placed.add(w)
        remaining.discard(w)
        cand_of[w] = child if child.size else np.zeros(1, dtype=np.int64)
        order.append(w)
        fanout[w] = raw_fanout
    if len(order) != len(comp):
        return None
    return order, fanout


def _gather_bounded(nbr: np.ndarray, starts: np.ndarray, degs: np.ndarray, bound: int):
    take = np.minimum(degs, np.maximum(0, bound // max(1, len(starts))) + 1)
    parts = [nbr[s : s + t] for s, t in zip(starts, take) if t > 0]
    return np.concatenate(parts).astype(np.int64) if parts else np.zeros(0, np.int64)


def _filter_by_labels(g: LabeledGraph, verts: np.ndarray, labels) -> np.ndarray:
    if not len(labels) or verts.size == 0:
        return verts
    keep = np.ones(verts.shape[0], dtype=bool)
    for lbl in labels:
        keep &= ((g.label_bitmap[verts, lbl >> 5] >> np.uint32(lbl & 31)) & 1).astype(bool)
    return verts[keep]


# --------------------------------------------------------------------------
# exact subset DP
# --------------------------------------------------------------------------


def dp_order(cm: CostModel, q: QueryGraph, adj, seeds: set[int],
             targets: list[int], start_rows: float,
             optional_rank: dict[int, int]) -> list[int] | None:
    """Minimum estimated total intermediate rows over all legal orders.

    Held-Karp over subsets of ``targets`` (≤ ``DP_MAX_VERTICES``): a state
    is the set of already-bound targets; the transition binds one more
    vertex adjacent to seeds ∪ state, multiplying the running row estimate
    by the cheapest connecting edge's fanout.  Objective is the classic
    C_out sum of intermediate cardinalities.  Because the running row count
    is path-dependent (the cheapest edge into a vertex depends on *when* it
    is bound), each subset keeps the full Pareto frontier over
    (total_cost, rows) — a state dominated on cost alone may still own the
    optimal completion — capped at ``_DP_PARETO_CAP`` entries.
    Optional-group vertices may only be bound once every lower-ranked
    vertex is bound.
    """
    k = len(targets)
    if k == 0:
        return []
    if k > DP_MAX_VERTICES:
        return None
    t_index = {t: i for i, t in enumerate(targets)}
    rank = [optional_rank.get(t, 0) for t in targets]

    def fanout_into(mask: int, wi: int) -> float:
        """Cheapest edge from seeds ∪ mask into targets[wi]; inf if none."""
        w = targets[wi]
        best = float("inf")
        for ei, other in adj[w]:
            oi = t_index.get(other)
            if oi is None:
                if other in seeds:
                    best = min(best, cm.edge_cost(q, ei, other))
            elif mask >> oi & 1:
                best = min(best, cm.edge_cost(q, ei, other))
        return best

    full = (1 << k) - 1
    INF = float("inf")
    # dp[mask] = Pareto set of (total_cost, rows, order) — ascending cost,
    # descending rows
    dp: list[list[tuple[float, float, tuple[int, ...]]]] = \
        [[] for _ in range(full + 1)]
    dp[0] = [(0.0, max(1.0, start_rows), ())]
    for mask in range(full + 1):
        for total, rows, order in dp[mask]:
            for wi in range(k):
                if mask >> wi & 1:
                    continue
                # optional ordering constraint: lower ranks first
                if any(not (mask >> oi & 1) for oi in range(k)
                       if rank[oi] < rank[wi]):
                    continue
                f = fanout_into(mask, wi)
                if f == INF:
                    continue
                nrows = rows * max(f, 1e-3)
                state = (total + nrows, nrows, order + (wi,))
                _pareto_insert(dp[mask | (1 << wi)], state)
    if not dp[full]:
        return None
    best = min(dp[full])  # lowest total cost wins at the full set
    return [targets[wi] for wi in best[2]]


_DP_PARETO_CAP = 32


def _pareto_insert(states: list[tuple[float, float, tuple[int, ...]]],
                   new: tuple[float, float, tuple[int, ...]]) -> None:
    """Keep ``states`` a (cost, rows)-Pareto frontier sorted by cost."""
    nc, nr, _ = new
    for c, r, _o in states:
        if c <= nc and r <= nr:
            return  # dominated
    states[:] = [s for s in states if not (nc <= s[0] and nr <= s[1])]
    states.append(new)
    states.sort()
    if len(states) > _DP_PARETO_CAP:
        del states[_DP_PARETO_CAP:]
