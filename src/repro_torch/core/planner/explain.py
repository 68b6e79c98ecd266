"""Human/JSON-facing plan rendering for ``SparqlEngine.explain()`` and the
``/sparql?explain=1`` endpoint: matching order, chosen start vertex, and
per-step fanout / cumulative-cardinality estimates."""

from __future__ import annotations

from repro_torch.core.planner.ir import ExecPlan


def _vertex_name(q, u: int) -> str:
    qv = q.vertices[u]
    if qv.var is not None:
        return "?" + qv.var
    return qv.term or f"_v{u}"


def _predicate_name(maps, elabel: int) -> str | None:
    if maps is None or elabel < 0:
        return None
    try:
        return maps.dict.predicate(int(maps.elabel_to_pred[elabel]))
    except Exception:  # noqa: BLE001 — explain must never fail the query
        return None


def explain_plan(plan: ExecPlan, maps=None) -> dict:
    """JSON-able description of one compiled plan."""
    q = plan.query
    if plan.unsat:
        return {"unsat": True, "order": [], "steps": []}
    steps = []
    for i, s in enumerate(plan.steps):
        rec: dict = {
            "var": _vertex_name(q, s.u),
            "kind": "restart" if s.restart_candidates is not None else "expand",
            "est_fanout": (round(float(plan.est_fanout[i]), 3)
                           if i < len(plan.est_fanout) else None),
            "est_rows": (round(float(plan.est_rows[i]), 1)
                         if i < len(plan.est_rows) else None),
        }
        if s.parent >= 0:
            rec["parent"] = _vertex_name(q, s.parent)
            rec["forward"] = s.forward
        if s.elabel >= 0:
            pred = _predicate_name(maps, s.elabel)
            rec["predicate"] = pred if pred is not None else int(s.elabel)
        elif s.pvar_idx >= 0:
            rec["predicate"] = "?" + q.pvars[s.pvar_idx]
        if s.param_slot >= 0:
            # hoisted constant: the equality check reads params[k] at run
            # time instead of a baked vertex id
            rec["param"] = f"param[{s.param_slot}]"
        elif s.bound_id >= 0:
            rec["bound"] = True
        if s.nontree:
            rec["nontree_checks"] = len(s.nontree)
        if s.sig_mask is not None:
            rec["sig_probe"] = True
        if s.optional_group >= 0:
            rec["optional_group"] = s.optional_group
        if s.restart_candidates is not None:
            rec["restart_candidates"] = int(s.restart_candidates.shape[0])
        steps.append(rec)
    out = {
        "start_vertex": _vertex_name(q, plan.start_vertex),
        "start_candidates": int(plan.start_candidates.shape[0]),
        "order": [_vertex_name(q, u) for u in plan.order],
        "search": plan.search,
        "est_total_rows": round(float(plan.estimated_rows()), 1),
        "build_ms": round(plan.build_ms, 3),
        "steps": steps,
    }
    if plan.n_params:
        out["n_params"] = plan.n_params
        if plan.start_param_slot >= 0:
            out["start_param"] = f"param[{plan.start_param_slot}]"
    return out
