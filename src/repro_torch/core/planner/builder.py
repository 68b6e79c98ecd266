"""The one plan builder: base patterns and OPTIONAL extensions alike.

``build_plan`` turns a :class:`~repro_torch.core.query.QueryGraph` into an
:class:`~repro_torch.core.planner.ir.ExecPlan`:

- **base mode** (``prebound=0``): per connected component, choose a start
  vertex (paper's rank), search a matching order (greedy / sampled / DP per
  ``estimate``), and emit expansion steps; secondary components enter
  through restart steps.
- **extension mode** (``prebound=k``): query vertices ``0..k-1`` are
  pre-bound table columns (OPTIONAL left joins); only the remaining
  vertices get steps, ordered by the same cost model — there is no second
  greedy loop anywhere, and no hardcoded fanout.

Per-step cost-model (or sampled, when available) fanout estimates land in
``est_fanout`` so the executor's capacity presizing runs on real numbers;
cumulative cardinality estimates land in ``est_rows`` for ``explain()``
and the serving-layer estimate-vs-actual metrics.

``force_order`` pins the matching order (tests and the planner benchmark
use it to compare orderings); an illegal order — one that binds a vertex
before any neighbor, or checks a predicate variable before binding it —
raises :class:`PlanError`.  On a multi-component query the forced order is
regrouped per connected component (components enter in order of first
appearance), since cross-component restarts are emitted per component.

When the estimate-driven order would leave two unbound-predicate-variable
edges converging on one vertex (no single step can bind both), the builder
retries once with :func:`~repro_torch.core.planner.order.pvar_first_order`,
which binds pvar edges as tree edges eagerly; only if that also fails is
the query rejected.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.planner.cost import CostModel
from repro_torch.core.planner.ir import (ExecPlan, NTCheck, OrderNotExecutable,
                                   PlanError, Step, np_cmp)
from repro_torch.core.planner.order import (DP_MAX_VERTICES, dp_order, greedy_order,
                                      pvar_first_order, sampled_order)
from repro_torch.core.query import QueryGraph
from repro_torch.index import get_index, prune_candidates, required_signature
from repro_torch.rdf.graph import LabeledGraph
from repro_torch.utils import get_logger

log = get_logger("core.planner")

ESTIMATE_MODES = ("static", "sampled", "dp", "exhaustive")


def build_plan(
    g: LabeledGraph,
    q: QueryGraph,
    *,
    estimate: str = "sampled",
    num_filters: dict[str, list[tuple[str, float]]] | None = None,
    optional_groups: dict[int, int] | None = None,
    use_nlf: bool = False,
    use_deg: bool = False,
    use_sig: bool = True,
    prebound: int = 0,
    prebound_pvars: int = 0,
    force_order: list[int] | None = None,
    observed_fanout: dict[tuple[int, int, int, bool],
                          tuple[float, float]] | None = None,
    device: str = "cuda",
) -> ExecPlan:
    """Build an execution plan for a (sub-)query.

    ``estimate`` selects the order search: ``static`` (cost-model greedy),
    ``sampled`` (paper's candidate-region estimation, greedy fallback), or
    ``dp`` / ``exhaustive`` (optimal order by subset DP for components with
    ≤ 8 free vertices, greedy fallback).  ``prebound`` > 0 switches to
    extension mode: vertices below it are pre-bound base columns and the
    plan only binds the rest (OPTIONAL left joins).  ``use_nlf`` /
    ``use_deg`` correspond to the paper's -NLF / -DEG toggles; ``use_sig``
    enables neighborhood-signature pruning (:mod:`repro_torch.index`) of start
    and restart candidates plus per-step ``sig_mask`` probes.

    ``observed_fanout`` injects workload feedback (see
    :mod:`repro_torch.obs.workload`): per-edge observed (surviving, raw)
    fanouts keyed ``(child, parent, elabel, forward)`` replace the
    static estimates in the cost model, so the order search and the
    executor's capacity presizing both run on observed numbers.  The
    sampled-order shortcut is skipped when feedback is present (its
    sampled fanouts would mask the observed ones).

    ``device`` is where the start/restart signature prune probe runs
    (the ``signature_filter`` kernel on a CUDA device, its plain version
    on ``"cpu"``); it never changes the plan.
    """
    if estimate not in ESTIMATE_MODES:
        raise PlanError(f"unknown estimate mode {estimate!r}; "
                        f"expected one of {ESTIMATE_MODES}")
    t0 = time.perf_counter()
    num_filters = num_filters or {}
    optional_groups = optional_groups or {}
    if q.unsat:
        return ExecPlan(q, 0, np.zeros(0, np.int32), [], [0] if q.n_vertices else [],
                        len(q.pvars), unsat=True)
    if q.n_vertices == 0:
        raise PlanError("empty query")
    cm = CostModel(g, observed=observed_fanout)

    sig_bits = get_index(g).n_bits if use_sig else None

    def attempt(pvar_first: bool) -> ExecPlan:
        if prebound:
            return _build_extension(g, cm, q, prebound, prebound_pvars,
                                    estimate, num_filters, optional_groups,
                                    use_nlf, use_deg, sig_bits, force_order,
                                    pvar_first)
        return _build_base(g, cm, q, estimate, num_filters, optional_groups,
                           use_nlf, use_deg, sig_bits, force_order,
                           pvar_first, device)

    try:
        plan = attempt(pvar_first=False)
    except OrderNotExecutable:
        if force_order is not None:
            raise  # the caller pinned the order; report it as-is
        # the estimate-driven order left an unbound-pvar edge as a non-tree
        # check; retry with an order that binds pvar edges as tree edges
        plan = attempt(pvar_first=True)
    plan.build_ms = (time.perf_counter() - t0) * 1e3
    return plan


# --------------------------------------------------------------------------
# base mode
# --------------------------------------------------------------------------


def _build_base(g, cm: CostModel, q: QueryGraph, estimate, num_filters,
                optional_groups, use_nlf, use_deg, sig_bits, force_order,
                pvar_first: bool = False, device: str = "cuda") -> ExecPlan:
    comps = q.connected_components()
    adj = q.adjacency()
    if force_order is not None:
        if sorted(force_order) != list(range(q.n_vertices)):
            raise PlanError("force_order must be a permutation of the query "
                            "vertices")
        comp_of = {v: i for i, c in enumerate(comps) for v in c}
        comp_rank: list[int] = []
        comp_starts = [0] * len(comps)
        comp_order: list[list[int]] = [[] for _ in comps]
        for v in force_order:
            ci = comp_of[v]
            if ci not in comp_rank:
                comp_rank.append(ci)
                comp_starts[ci] = v
            comp_order[ci].append(v)
        search = "forced"
    else:
        comp_starts = [cm.choose_start_vertex(q, c) for c in comps]
        comp_rank = sorted(
            range(len(comps)), key=lambda i: cm.vertex_freq(q, comp_starts[i])
        )
        comp_order = [[] for _ in comps]  # filled per component below
        search = "greedy" if estimate == "static" else estimate

    steps: list[Step] = []
    global_order: list[int] = []
    placed: set[int] = set()
    edge_used = [False] * len(q.edges)
    start_vertex = comp_starts[comp_rank[0]]
    start_candidates = cm.candidates(q, start_vertex)
    est_fanout: list[float] = []
    est_expand: list[float] = []
    est_rows: list[float] = []
    rows = 1.0
    start_sig = None
    bound_pvars: dict[int, int] = {}  # pvar idx -> order position bound

    for rank_pos, ci in enumerate(comp_rank):
        comp = comps[ci]
        s = comp_starts[ci]
        cands = start_candidates if rank_pos == 0 else cm.candidates(q, s)
        if use_deg and cands.size:
            _, _, mo, mi = _nlf_masks(g, q, s)
            keep = (g.out.degree[cands] >= mo) & (g.inc.degree[cands] >= mi)
            cands = cands[keep]
        s_sig = None
        if sig_bits is not None:
            s_sig = required_signature(sig_bits, q, s, optional_groups)
            if s_sig.any():
                cands = prune_candidates(g, q, s, cands, optional_groups,
                                         device=device)
            else:
                s_sig = None
        if rank_pos == 0:
            start_candidates = cands
            start_sig = s_sig
            rows = float(max(1, cands.shape[0]))
        else:
            steps.append(Step(u=s, parent=-1, elabel=-1, forward=True,
                              labels=q.vertices[s].labels,
                              bound_id=max(q.vertices[s].bound_id, -1),
                              param_slot=q.vertices[s].param_slot,
                              optional_group=optional_groups.get(s, -1),
                              restart_candidates=cands,
                              sig_mask=s_sig))
            est_fanout.append(float(max(1, cands.shape[0])))
            est_expand.append(float(max(1, cands.shape[0])))
            rows *= float(max(1, cands.shape[0]))
            est_rows.append(rows)
        placed.add(s)
        global_order.append(s)

        # matching order within the component
        sampled_fanout: dict[int, float] = {}
        if force_order is not None:
            order = comp_order[ci]
        elif pvar_first:
            targets = set(comp) - {s}
            order = [s] + pvar_first_order(cm, q, adj, {s}, targets,
                                           optional_groups,
                                           bound0=set(bound_pvars))
            search = "pvar-first"
        else:
            order = None
            targets = set(comp) - {s}
            if estimate == "sampled":
                # live-store snapshots expose no raw CSR to sample from;
                # the cost-model greedy order stands in (estimates only —
                # snapshot answers used for candidates stay exact).  When
                # workload feedback is active, sampling is skipped too so
                # the observed fanouts in the cost model drive the order.
                hit = sampled_order(g, q, s, cands, optional_groups) \
                    if (getattr(g, "supports_sampled_order", True)
                        and not cm.observed) else None
                if hit is not None:
                    order, sampled_fanout = hit
                else:
                    search = "greedy"
            elif estimate in ("dp", "exhaustive"):
                tail = dp_order(cm, q, adj, {s}, sorted(targets), rows,
                                optional_groups)
                if tail is not None and len(tail) == len(targets):
                    order = [s] + tail
                else:
                    search = "greedy"
            if order is None:
                order = [s] + greedy_order(cm, q, adj, {s}, targets,
                                           optional_groups)
        # emit steps following `order`
        for w in order[1:]:
            step, f_card, f_raw = _emit_vertex_step(
                g, cm, q, w, placed, adj, edge_used, num_filters,
                optional_groups, use_nlf, use_deg, sig_bits, bound_pvars,
                pos=len(global_order))
            steps.append(step)
            f_presize = sampled_fanout.get(w)
            if (step.u, step.parent, step.elabel,
                    step.forward) in cm.observed:
                f_presize = None  # f_card/f_raw already carry observed data
            elif f_presize is None and step.parent == s and cands.size:
                # first hop off the start vertex: probe the *actual*
                # candidates (bounded sample) instead of the graph average
                f_presize = cm.stats.sampled_fanout(step.elabel, step.forward,
                                                    cands)
            est_fanout.append(f_card if f_presize is None else f_presize)
            est_expand.append(f_raw if f_presize is None
                              else max(f_raw, f_presize))
            rows *= max(f_card, 1e-3)
            est_rows.append(rows)
            placed.add(w)
            global_order.append(w)

    _attach_leftover_edges(q, steps, global_order, edge_used, bound_pvars)

    # start-vertex cheap numeric filters applied on host
    sv = q.vertices[start_vertex]
    start_nf: tuple = ()
    if sv.var and num_filters.get(sv.var) and g.numeric_value is not None:
        start_nf = tuple(num_filters[sv.var])
        vals = g.numeric_value[start_candidates]
        keep = np.ones(start_candidates.shape[0], bool)
        for op, c in start_nf:
            keep &= np_cmp(vals, op, c)
        start_candidates = start_candidates[keep]

    return ExecPlan(
        query=q,
        start_vertex=start_vertex,
        start_candidates=np.sort(start_candidates).astype(np.int32),
        steps=steps,
        order=global_order,
        n_pvars=len(q.pvars),
        n_params=1 + max((v.param_slot for v in q.vertices), default=-1),
        start_param_slot=q.vertices[start_vertex].param_slot,
        start_num_filters=start_nf,
        start_sig=start_sig,
        est_fanout=est_fanout,
        est_expand=est_expand,
        est_rows=est_rows,
        search=search,
    )


# --------------------------------------------------------------------------
# extension mode (OPTIONAL left joins)
# --------------------------------------------------------------------------


def _build_extension(g, cm: CostModel, q: QueryGraph, prebound: int,
                     prebound_pvars: int, estimate, num_filters,
                     optional_groups, use_nlf, use_deg, sig_bits,
                     force_order, pvar_first: bool = False) -> ExecPlan:
    adj = q.adjacency()
    seeds = set(range(prebound))
    targets = [v for v in range(q.n_vertices) if v >= prebound]
    if force_order is not None:
        if sorted(force_order) != targets:
            raise PlanError("force_order must be a permutation of the "
                            "extension vertices")
        order = list(force_order)
        search = "forced"
    elif pvar_first:
        order = pvar_first_order(cm, q, adj, seeds, set(targets),
                                 optional_groups,
                                 bound0=set(range(prebound_pvars)))
        search = "pvar-first"
    else:
        order = None
        search = "greedy"
        if estimate in ("dp", "exhaustive") and len(targets) <= DP_MAX_VERTICES:
            order = dp_order(cm, q, adj, seeds, targets, 1.0, optional_groups)
            if order is not None and len(order) == len(targets):
                search = "dp"
            else:
                order = None
        if order is None:
            order = greedy_order(cm, q, adj, seeds, set(targets),
                                 optional_groups)
    if len(order) != len(targets):
        raise PlanError("OPTIONAL pattern not connected to the base pattern")

    steps: list[Step] = []
    placed = set(seeds)
    edge_used = [False] * len(q.edges)
    global_order = list(range(prebound))
    est_fanout: list[float] = []
    est_expand: list[float] = []
    est_rows: list[float] = []
    rows = 1.0  # per-base-row multiplier: base table size is a runtime input
    # pvars of the base pattern are bound before any extension step runs
    bound_pvars: dict[int, int] = {i: -1 for i in range(prebound_pvars)}
    for w in order:
        step, f_card, f_raw = _emit_vertex_step(
            g, cm, q, w, placed, adj, edge_used, num_filters,
            optional_groups, use_nlf, use_deg, sig_bits, bound_pvars,
            pos=len(global_order))
        steps.append(step)
        est_fanout.append(f_card)
        est_expand.append(f_raw)
        rows *= max(f_card, 1e-3)
        est_rows.append(rows)
        placed.add(w)
        global_order.append(w)

    _attach_leftover_edges(q, steps, global_order, edge_used, bound_pvars,
                           extension=True)

    return ExecPlan(
        query=q,
        start_vertex=0,
        start_candidates=np.zeros(0, np.int32),
        steps=steps,
        order=global_order,
        n_pvars=len(q.pvars),
        est_fanout=est_fanout,
        est_expand=est_expand,
        est_rows=est_rows,
        search=search,
    )


# --------------------------------------------------------------------------
# shared step emission
# --------------------------------------------------------------------------


def _emit_vertex_step(g, cm: CostModel, q: QueryGraph, w: int, placed: set[int],
                      adj, edge_used: list[bool], num_filters,
                      optional_groups, use_nlf, use_deg, sig_bits,
                      bound_pvars: dict[int, int],
                      pos: int) -> tuple[Step, float, float]:
    """Emit the expansion step binding ``w`` from the placed set: cheapest
    tree edge plus every now-resolvable non-tree check.  Returns the step,
    its cost-model cardinality fanout (rows surviving the step's filters
    per input row), and the raw expansion factor (candidates produced per
    input row before filtering — the executor's capacity requirement).

    An edge whose predicate variable is not yet bound MUST be the tree edge
    (the executor's non-tree check rejects rows with unbound M_e), so such
    edges win tree-edge selection outright; if two of them with *different*
    predicate variables converge on ``w``, no single step can bind both and
    the order is rejected rather than silently dropping every row.
    """
    best_ei, best_cost = -1, float("inf")
    best_mandatory = False
    for ei, other in adj[w]:
        if edge_used[ei] or other not in placed:
            continue
        e = q.edges[ei]
        mandatory = e.elabel < 0 and _pvar_idx(q, e) not in bound_pvars
        if mandatory and not best_mandatory:
            best_cost = float("inf")  # unbound-pvar edges preempt the rest
            best_mandatory = True
        elif best_mandatory and not mandatory:
            continue
        cost = cm.edge_cost(q, ei, other)
        if cost < best_cost:
            best_cost, best_ei = cost, ei
    if best_ei < 0:
        raise PlanError(f"vertex {w} not connected to placed set")
    e = q.edges[best_ei]
    edge_used[best_ei] = True
    forward = e.u != w  # parent --> w when parent is subject
    parent = e.u if forward else e.v
    f_card = cm.edge_cost(q, best_ei, parent)
    f_raw = cm.stats.avg_fanout(e.elabel, forward)
    obs = cm.observed_fanout(q, best_ei, parent)
    if obs is not None:
        f_card, f_raw = obs[0], max(obs[0], obs[1])
    if e.pvar is not None:
        bound_pvars.setdefault(_pvar_idx(q, e), pos)
    # non-tree edges resolvable now (both endpoints placed after adding w)
    nts: list[NTCheck] = []
    for ei2, other2 in adj[w]:
        if edge_used[ei2]:
            continue
        e2 = q.edges[ei2]
        if e2.u == e2.v == w:  # self loop
            edge_used[ei2] = True
            _require_bound_pvar(q, e2, bound_pvars, pos)
            nts.append(NTCheck(other=w, elabel=e2.elabel, forward=True,
                               pvar_idx=_pvar_idx(q, e2), self_loop=True))
            continue
        if other2 in placed:
            edge_used[ei2] = True
            _require_bound_pvar(q, e2, bound_pvars, pos)
            fwd = e2.u == other2  # (other --el--> w)?
            nts.append(NTCheck(other=other2, elabel=e2.elabel, forward=fwd,
                               pvar_idx=_pvar_idx(q, e2)))
    om, im, mo, mi = _nlf_masks(g, q, w)
    qv = q.vertices[w]
    sig_mask = None
    if sig_bits is not None and qv.bound_id < 0:
        req = required_signature(sig_bits, q, w, optional_groups)
        if req.any() and e.elabel >= 0:
            # the tree edge itself already guarantees one bit of the
            # required signature (forward expansion: w has an incoming
            # e.elabel edge; backward: an outgoing one) — a probe whose
            # mask holds nothing *beyond* that bit is pure overhead
            probe = req.copy()
            t = e.elabel % sig_bits
            off = ((sig_bits + 31) // 32) if forward else 0
            probe[off + (t >> 5)] &= ~np.uint32(1 << (t & 31))
            if not probe.any():
                req = None
        sig_mask = req if req is not None and req.any() else None
    step = Step(
        u=w,
        parent=parent,
        elabel=e.elabel,
        forward=forward,
        pvar_idx=_pvar_idx(q, e),
        labels=qv.labels,
        bound_id=max(qv.bound_id, -1),
        param_slot=qv.param_slot,
        nontree=tuple(nts),
        min_out_ntypes=mo if use_deg else 0,
        min_in_ntypes=mi if use_deg else 0,
        nlf_out_mask=om if use_nlf else None,
        nlf_in_mask=im if use_nlf else None,
        num_filters=tuple(num_filters.get(qv.var or "", ())),
        optional_group=optional_groups.get(w, -1),
        sig_mask=sig_mask,
    )
    return step, f_card, f_raw


def _require_bound_pvar(q: QueryGraph, e, bound_pvars: dict[int, int],
                        limit: int) -> None:
    """A non-tree check on a predicate variable needs that variable bound by
    a tree edge no later than the checking step (position ``limit``) —
    otherwise the executor would reject every row.  Reject the order
    instead of producing silently-empty results."""
    if e.elabel < 0 and bound_pvars.get(_pvar_idx(q, e), 1 << 30) > limit:
        raise OrderNotExecutable(
            f"matching order checks predicate variable ?{e.pvar} before any "
            "tree edge binds it; this order is not executable")


def _attach_leftover_edges(q: QueryGraph, steps: list[Step],
                           global_order: list[int], edge_used: list[bool],
                           bound_pvars: dict[int, int],
                           extension: bool = False) -> None:
    """Edges whose endpoints were both placed without a connecting step
    become non-tree checks on the later endpoint's step."""
    if all(edge_used):
        return
    for ei, used in enumerate(edge_used):
        if used:
            continue
        e = q.edges[ei]
        later = max(global_order.index(e.u), global_order.index(e.v))
        w = global_order[later]
        for st in steps:
            if st.u == w:
                _require_bound_pvar(q, e, bound_pvars, later)
                other = e.u if e.v == w else e.v
                fwd = e.u == other
                st.nontree = (*st.nontree, NTCheck(other, e.elabel, fwd,
                                                   _pvar_idx(q, e)))
                edge_used[ei] = True
                break
    if not all(edge_used):
        if extension:
            raise PlanError("optional edge between two pre-bound vertices "
                            "unsupported; move it into the base pattern")
        raise PlanError("internal: unassigned query edges remain")


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _pvar_idx(q: QueryGraph, e) -> int:
    return q.pvars.index(e.pvar) if e.pvar is not None else -1


def _nlf_masks(
    g: LabeledGraph, q: QueryGraph, u: int
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Query-side NLF masks + hom-weakened degree minimums for vertex u."""
    stride = g.n_vlabels + 1
    n_types = g.n_elabels * stride
    n_words = (n_types + 31) // 32
    masks = {True: np.zeros(n_words, np.uint32), False: np.zeros(n_words, np.uint32)}
    ntypes = {True: set(), False: set()}
    for e in q.edges:
        if e.elabel < 0:
            continue
        if e.u == u:
            other, out_dir = e.v, True
        elif e.v == u:
            other, out_dir = e.u, False
        else:
            continue
        labels = q.vertices[other].labels
        ts = [e.elabel * stride] if not labels else [
            e.elabel * stride + 1 + l for l in labels
        ]
        for t in ts:
            masks[out_dir][t >> 5] |= np.uint32(1 << (t & 31))
        ntypes[out_dir].add((e.elabel, labels))
    return masks[True], masks[False], len(ntypes[True]), len(ntypes[False])
