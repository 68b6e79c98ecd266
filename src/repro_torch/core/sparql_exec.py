"""Full SPARQL evaluation: BGP + OPTIONAL + FILTER + UNION (paper §5.1).

The port of ``repro.core.sparql_exec`` onto the torch executor (static
graphs).  Orchestrates the vectorized executor:

- the required basic graph pattern runs first (one ExecPlan);
- each OPTIONAL group becomes an *extension plan* left-joined onto the base
  table: rows with ≥1 optional match take the matched rows, rows with none
  keep the base bindings with nulls — the paper's all-or-nothing OPTIONAL
  semantics realized as a group-level outer join (the nullify-and-keep-
  searching + qualify-and-exclude-duplicate pair collapses into this join,
  so no duplicate-exclusion pass is needed);
- FILTERs: cheap single-variable numeric comparisons are pushed into the
  expansion steps (inline), expensive ones (regex, var-var comparisons)
  are applied to the final table (the paper's strategy);
- UNION branches are evaluated independently and concatenated (SPARQL UNION
  keeps duplicates, as the paper notes).

Compilation and execution are split so the serving layer can share work:
``compile()`` canonicalizes the query (``repro_torch.serve.fingerprint``), keys a
bounded LRU plan cache (``repro_torch.serve.cache.PlanCache``) on the structural
fingerprint, and returns a ``CompiledQuery`` of branch plans + projections;
``execute_compiled()`` runs one.  Alpha-equivalent queries — same shape,
different variable names / triple order — therefore compile exactly once
per engine, and results are renamed back to the caller's variables.

The engine runs on one torch ``device`` (default ``"cuda"``, which raises
without CUDA; ``"cpu"`` runs the kernels' plain versions): the executor's
chunk programs and the planner's signature prune probe both run there.
"""

from __future__ import annotations

import re as _re
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.exec import ExecOpts, Executor, Result
from repro_torch.core.planner import ExecPlan, build_plan, explain_plan, np_cmp
from repro_torch.core.query import QueryGraph, build_query_graph
from repro_torch.obs.workload import qerror
from repro_torch.resilience.cancel import CancelToken, QueryCancelled
from repro_torch.rdf.sparql import (Comparison, GroupPattern, Literal, Regex,
                              SelectQuery, Var, parse_sparql)
from repro_torch.rdf.transform import TransformMaps
from repro_torch.utils import get_logger

log = get_logger("core.sparql")

@dataclass
class QueryResult:
    variables: list[str]  # projected variable names (vertex vars + pvars)
    rows: np.ndarray  # int32 [n, n_vars] vertex ids / edge-label ids / -1=null
    kinds: list[str]  # per column: "vertex" | "predicate"
    count: int = 0
    stats: dict = field(default_factory=dict)

    def decode(self, maps: TransformMaps, limit: int | None = None) -> list[dict]:
        out = []
        n = self.rows.shape[0] if limit is None else min(limit, self.rows.shape[0])
        for i in range(n):
            rec = {}
            for c, var in enumerate(self.variables):
                vid = int(self.rows[i, c])
                if vid < 0:
                    rec[var] = None
                elif self.kinds[c] == "vertex":
                    rec[var] = maps.dict.term(int(maps.vertex_to_term[vid]))
                else:
                    rec[var] = maps.dict.predicate(int(maps.elabel_to_pred[vid]))
            out.append(rec)
        return out


@dataclass
class CompiledOptional:
    """One OPTIONAL group compiled as an extension (left-join) plan."""

    q_ext: QueryGraph       # base vertices + the optional's new vertices
    base_cols: int          # number of pre-bound base columns
    plan: ExecPlan          # extension steps only
    expensive: list         # post-hoc filters on the joined table


@dataclass
class CompiledBranch:
    """One UNION branch: base plan + optional extensions + projection."""

    q: QueryGraph
    plan: ExecPlan
    expensive: list
    optionals: list[CompiledOptional]
    q_all: QueryGraph       # after all optional merges
    variables: list[str]
    kinds: list[str]


@dataclass
class CompiledQuery:
    """A fully compiled query: what the plan cache stores and the executor
    runs.  Variables are canonical names when built via ``compile()``."""

    fingerprint: str
    select: list[str]
    branches: list[CompiledBranch]
    variables: list[str]    # result columns (first branch's projection)
    kinds: list[str]
    plan_ms: float = 0.0    # total planner time (base + extension plans)
    # solution modifiers (post-processing; part of the fingerprint)
    distinct: bool = False
    limit: int | None = None
    offset: int = 0

    @property
    def has_modifiers(self) -> bool:
        return self.distinct or self.limit is not None or self.offset > 0

    @property
    def any_unsat(self) -> bool:
        """Some branch was compiled against a constant/predicate that did
        not exist in the data.  On an immutable graph that verdict is
        final; on a live store the term may be interned by a later update,
        so unsat compilations must not enter the plan cache."""
        return not self.branches or any(
            br.plan.unsat or any(co.plan.unsat for co in br.optionals)
            for br in self.branches)

    def estimated_rows(self) -> float:
        """Planner cardinality estimate for the full query (sum of branch
        base-plan estimates scaled by OPTIONAL extension multipliers ≥ 1:
        a left join never drops base rows)."""
        total = 0.0
        for br in self.branches:
            est = br.plan.estimated_rows()
            for co in br.optionals:
                est *= max(1.0, co.plan.estimated_rows())
            total += est
        return total


class SparqlEngine:
    """End-to-end SPARQL evaluation against one transformed graph.

    ``plan_cache`` (a :class:`repro_torch.serve.cache.PlanCache`) is keyed by the
    query's structural fingerprint, so alpha-equivalent queries share one
    compiled plan.  Pass ``plan_cache=None`` for the default bounded LRU, or
    a pre-sized cache to share stats.  ``device`` (default ``"cuda"``) is
    where the executor and the planner's prune probe run.
    """

    def __init__(self, graph, maps: TransformMaps, opts: ExecOpts | None = None,
                 estimate: str = "sampled", plan_cache=None, device="cuda"):
        from repro_torch.serve.cache import PlanCache

        self.graph = graph
        self.maps = maps
        self.opts = opts or ExecOpts()
        self.estimate = estimate
        self.executor = Executor(graph, self.opts, device=device)
        self.device = self.executor.device
        if plan_cache is None:
            plan_cache = PlanCache(capacity=256)
        self._plan_cache = plan_cache

    # ------------------------------------------------------------------ API
    def compile(self, source: str | SelectQuery):
        """Canonicalize + compile through the plan cache.

        Returns ``(compiled, canon)`` where ``compiled`` is a (possibly
        shared) :class:`CompiledQuery` over canonical variable names and
        ``canon`` is the :class:`~repro_torch.serve.fingerprint.CanonicalQuery`
        carrying this caller's variable renaming.
        """
        from repro_torch.serve.fingerprint import canonicalize_query

        ast = parse_sparql(source) if isinstance(source, str) else source
        canon = canonicalize_query(ast)
        return self.compile_canonical(canon), canon

    def compile_canonical(self, canon, *, with_fresh: bool = False):
        """Compile a pre-canonicalized query through the plan cache.

        With ``with_fresh=True`` returns ``(compiled, fresh)`` where
        ``fresh`` tells whether *this call* built the plan (vs. a cache
        hit) — callers recording plan-search metrics need that rather than
        inferring it from shared cache counters, which races under
        concurrent compilation."""
        compiled = self._plan_cache.get(canon.fingerprint)
        fresh = compiled is None
        if fresh:
            compiled = self._compile_ast(canon.query, canon.fingerprint)
            self._plan_cache.put(canon.fingerprint, compiled)
        return (compiled, fresh) if with_fresh else compiled

    def execute_compiled(self, compiled: CompiledQuery,
                         collect: str = "bindings",
                         profile: bool = False,
                         cancel: CancelToken | None = None) -> QueryResult:
        """Run a compiled query; result columns keep its variable names.

        ``collect="count"`` lets branches without OPTIONALs, post-hoc
        filters or solution modifiers run the executor's count-only path
        (no binding-table materialization or device→host transfer); the
        result then has an exact ``count`` but empty ``rows``.  DISTINCT /
        OFFSET / LIMIT force materialization even for counts — they are
        applied to the assembled table here, after UNION concatenation.
        ``profile=True`` executes with per-step host syncs to fill
        per-step wall times in the stats.  ``cancel`` (a
        :class:`repro_torch.resilience.CancelToken`) is threaded into every
        executor run and checked between branches; on expiry a
        :class:`QueryCancelled` carries the stats accumulated so far."""
        all_rows: list[np.ndarray] = []
        total = 0
        exec_stats: list[dict] = []
        step_card: list[tuple[float, int]] = []
        variables, kinds = compiled.variables, compiled.kinds
        modifiers = compiled.has_modifiers
        executor = self.executor
        for bi, br in enumerate(compiled.branches):
            if cancel is not None:
                cancel.check({"exec": {"branches": exec_stats}})
            try:
                rows, count, info = self._exec_branch(
                    br, collect if not modifiers else "bindings",
                    profile, executor, cancel)
            except QueryCancelled as e:
                # enrich with the completed branches' stats so the 504
                # body can report partial progress
                e.partial_stats = {
                    "exec": {"branches": exec_stats
                             + [{"base": e.partial_stats}]}}
                raise
            total += count
            exec_stats.append(info)
            base = info.get("base") or {}
            for est, actual in zip(br.plan.est_rows,
                                   base.get("step_kept") or []):
                step_card.append((float(est), int(actual)))
            if rows is not None:
                if br.variables != variables:
                    rows = _align_columns(rows, br.variables, variables)
                all_rows.append(rows)
        rows = (np.concatenate(all_rows) if all_rows
                else np.zeros((0, 0), np.int32))
        if modifiers:
            if compiled.distinct:
                rows = np.unique(rows, axis=0)
            if compiled.offset:
                rows = rows[compiled.offset:]
            if compiled.limit is not None:
                rows = rows[: compiled.limit]
            total = int(rows.shape[0])
        elif collect == "bindings":
            total = int(rows.shape[0])
        return QueryResult(list(variables), rows, list(kinds),
                           count=total,
                           stats={"plan_ms": compiled.plan_ms,
                                  "est_rows": compiled.estimated_rows(),
                                  "exec": {"branches": exec_stats},
                                  "step_card": step_card})

    def query(self, sparql: str, collect: str = "bindings",
              timeout_ms: float | None = None,
              cancel: CancelToken | None = None) -> QueryResult:
        """Evaluate a SPARQL string.  ``timeout_ms`` sets a deadline for
        this call (raising :class:`repro_torch.resilience.QueryCancelled`
        on expiry); ``cancel`` passes an externally owned token instead."""
        return self.query_ast(parse_sparql(sparql), collect=collect,
                              timeout_ms=timeout_ms, cancel=cancel)

    def query_ast(self, ast: SelectQuery, collect: str = "bindings",
                  timeout_ms: float | None = None,
                  cancel: CancelToken | None = None) -> QueryResult:
        if cancel is None and timeout_ms is not None:
            cancel = CancelToken(time.monotonic() + timeout_ms / 1e3)
        compiled, canon = self.compile(ast)
        if cancel is not None:
            cancel.check()  # deadline may have expired during plan search
        res = self.execute_compiled(compiled, collect=collect, cancel=cancel)
        res.variables = canon.restore(res.variables)
        return res

    def count(self, sparql: str) -> int:
        return self.query(sparql, collect="count").count

    def explain(self, source: str | SelectQuery,
                analyze: bool = False) -> dict:
        """Describe the (possibly cached) plan for a query without running
        it: matching order, chosen start vertex, and per-step fanout /
        cardinality estimates, with the caller's variable names.

        ``analyze=True`` additionally *executes* the query in profiled mode
        and annotates every step with its measured expansion total,
        surviving rows, overflow retries, and wall time — the
        estimate-vs-actual view (SQL's EXPLAIN ANALYZE)."""
        compiled, canon = self.compile(source)
        run_stats = None
        if analyze:
            res = self.execute_compiled(compiled, profile=True)
            run_stats = res.stats
        out = self.describe_compiled(compiled, run_stats=run_stats,
                                     inverse=canon.inverse)
        if run_stats is not None:
            out["actual_rows"] = res.count
            out["q_error"] = round(qerror(out["est_total_rows"], res.count), 3)
        return out

    def describe_compiled(self, compiled: CompiledQuery,
                          run_stats: dict | None = None,
                          inverse: dict | None = None) -> dict:
        """EXPLAIN-style JSON for an already-compiled query.  With
        ``run_stats`` (a ``QueryResult.stats`` from any execution) the
        steps carry measured counters — the EXPLAIN ANALYZE view without
        re-running.  ``inverse`` maps
        canonical variable names back to the caller's."""
        inverse = inverse or {}

        def restore_names(obj):
            if isinstance(obj, str) and obj.startswith("?"):
                return "?" + inverse.get(obj[1:], obj[1:])
            if isinstance(obj, list):
                return [restore_names(x) for x in obj]
            if isinstance(obj, dict):
                return {k: restore_names(v) for k, v in obj.items()}
            return obj

        branches = []
        for bi, br in enumerate(compiled.branches):
            b = explain_plan(br.plan, self.maps)
            b["optionals"] = [explain_plan(co.plan, self.maps)
                              for co in br.optionals]
            if run_stats is not None:
                binfo = run_stats["exec"]["branches"][bi]
                _annotate_steps(b, binfo.get("base"))
                for oi, od in enumerate(b["optionals"]):
                    opts_info = binfo.get("optionals") or []
                    if oi < len(opts_info):
                        _annotate_steps(od, opts_info[oi])
            branches.append(restore_names(b))
        return {
            "fingerprint": compiled.fingerprint,
            "estimate": self.estimate,
            "plan_ms": round(compiled.plan_ms, 3),
            "est_total_rows": round(compiled.estimated_rows(), 1),
            "branches": branches,
        }

    # --------------------------------------------------------- compilation
    def _compile_ast(self, ast: SelectQuery, fingerprint: str) -> CompiledQuery:
        branches = [self._compile_group(g, ast.select)
                    for g in self._expand_unions(ast.where)]
        first = branches[0] if branches else None
        plan_ms = sum(br.plan.build_ms
                      + sum(co.plan.build_ms for co in br.optionals)
                      for br in branches)
        return CompiledQuery(
            fingerprint=fingerprint, select=list(ast.select),
            branches=branches,
            variables=list(first.variables) if first else [],
            kinds=list(first.kinds) if first else [],
            plan_ms=plan_ms,
            distinct=ast.distinct, limit=ast.limit, offset=ast.offset)

    def _compile_group(self, g: GroupPattern,
                       select: list[str]) -> CompiledBranch:
        q = build_query_graph(g.triples, self.maps)
        cheap, expensive = _split_filters(g.filters, q)
        plan = build_plan(self.graph, q, estimate=self.estimate,
                          num_filters=cheap,
                          use_nlf=self.opts.use_nlf, use_deg=self.opts.use_deg,
                          use_sig=self.opts.use_prune,
                          device=self.device)
        q_all = q
        optionals: list[CompiledOptional] = []
        for og in g.optionals:
            n_base_pvars = len(q_all.pvars)
            q_ext, _, base_cols = _merge_query(q_all, og.triples, self.maps)
            cheap_o, exp_o = _split_filters(og.filters, q_ext)
            # the same planner entry point as the base pattern: vertices
            # below base_cols are pre-bound table columns, pvars below
            # n_base_pvars are bound by the base execution
            ext_plan = build_plan(self.graph, q_ext, estimate=self.estimate,
                                  num_filters=cheap_o,
                                  use_nlf=self.opts.use_nlf,
                                  use_deg=self.opts.use_deg,
                                  use_sig=self.opts.use_prune,
                                  prebound=base_cols,
                                  prebound_pvars=n_base_pvars,
                                  device=self.device)
            optionals.append(CompiledOptional(q_ext, base_cols, ext_plan, exp_o))
            q_all = q_ext
        variables: list[str] = []
        kinds: list[str] = []
        want = select or [v for v in q_all.var_to_vertex] + q_all.pvars
        for var in want:
            variables.append(var)
            kinds.append("vertex" if var in q_all.var_to_vertex
                         else "predicate" if var in q_all.pvars else "vertex")
        return CompiledBranch(q=q, plan=plan, expensive=expensive,
                              optionals=optionals, q_all=q_all,
                              variables=variables, kinds=kinds)

    # ------------------------------------------------------------ execution
    def _exec_branch(self, br: CompiledBranch, collect: str = "bindings",
                     profile: bool = False, executor=None,
                     cancel: CancelToken | None = None):
        """Run one branch; returns ``(rows | None, count, exec_stats)``."""
        executor = self.executor if executor is None else executor
        count_only = (collect == "count" and not br.optionals
                      and not br.expensive)
        res = executor.run(
            br.plan, collect="count" if count_only else "bindings",
            profile=profile, cancel=cancel)
        info: dict = {"base": res.stats}
        if count_only:
            return None, res.count, info
        table, ptable, _ = self._apply_expensive(res.bindings,
                                                 res.pvar_bindings,
                                                 br.q, br.expensive)
        opt_stats: list[dict] = []
        for oi, co in enumerate(br.optionals):
            table, ptable, ost = self._exec_left_join(table, ptable, co,
                                                      profile, executor,
                                                      cancel)
            opt_stats.append(ost)
        if opt_stats:
            info["optionals"] = opt_stats
        q_all = br.q_all
        cols: list[np.ndarray] = []
        for var in br.variables:
            if var in q_all.var_to_vertex:
                cols.append(table[:, q_all.var_to_vertex[var]])
            elif var in q_all.pvars:
                cols.append(ptable[:, q_all.pvars.index(var)])
            else:
                cols.append(np.full(table.shape[0], -1, np.int32))
        rows = np.stack(cols, axis=1) if cols else np.zeros(
            (table.shape[0], 0), np.int32)
        return rows, int(rows.shape[0]), info

    # ----------------------------------------------------------- internals
    def _expand_unions(self, g: GroupPattern) -> list[GroupPattern]:
        """Cartesian expansion of UNION blocks into flat branch groups."""
        branches = [GroupPattern(list(g.triples), list(g.filters),
                                 list(g.optionals), [])]
        for union in g.unions:
            new: list[GroupPattern] = []
            for b in branches:
                for alt in union:
                    for alt_flat in self._expand_unions(alt):
                        nb = GroupPattern(
                            b.triples + alt_flat.triples,
                            b.filters + alt_flat.filters,
                            b.optionals + alt_flat.optionals,
                            [],
                        )
                        new.append(nb)
            branches = new
        return branches

    def _exec_left_join(self, table: np.ndarray, ptable: np.ndarray,
                        co: CompiledOptional, profile: bool = False,
                        executor=None, cancel: CancelToken | None = None):
        """Left-outer join a compiled OPTIONAL extension onto the table."""
        q_ext, plan, expensive = co.q_ext, co.plan, co.expensive
        nq_ext = q_ext.n_vertices
        b0 = np.full((table.shape[0], nq_ext), -1, dtype=np.int32)
        b0[:, : table.shape[1]] = table
        p0 = np.full((table.shape[0], max(1, len(q_ext.pvars))), -1, np.int32)
        p0[:, : ptable.shape[1]] = ptable
        org0 = np.arange(table.shape[0], dtype=np.int32)
        if plan.unsat or table.shape[0] == 0:
            matched = Result(0, np.zeros((0, nq_ext), np.int32),
                             np.zeros((0, max(1, len(q_ext.pvars))), np.int32),
                             np.zeros(0, np.int32))
        else:
            executor = self.executor if executor is None else executor
            matched = executor.run(plan, initial=(b0, p0, org0),
                                   profile=profile, cancel=cancel)
        mt, mp, morg = self._apply_expensive(matched.bindings,
                                             matched.pvar_bindings,
                                             q_ext, expensive,
                                             origins=matched.origins)
        # rows with no optional match: keep base + nulls
        has_match = np.zeros(table.shape[0], dtype=bool)
        if morg.shape[0]:
            has_match[morg] = True
        unmatched = np.flatnonzero(~has_match)
        un_b = np.full((unmatched.shape[0], nq_ext), -1, dtype=np.int32)
        un_b[:, : table.shape[1]] = table[unmatched]
        un_p = np.full((unmatched.shape[0], mp.shape[1]), -1, np.int32)
        un_p[:, : ptable.shape[1]] = ptable[unmatched]
        new_table = np.concatenate([mt, un_b], axis=0)
        new_ptable = np.concatenate([mp, un_p], axis=0)
        return new_table, new_ptable, matched.stats

    def _apply_expensive(self, table, ptable, q: QueryGraph, filters,
                         origins=None):
        """Post-hoc (regex / var-var) filters; returns a plain
        ``(table, ptable, origins)`` — ``origins`` stays ``None`` when the
        caller did not pass source-row ids."""
        keep = np.ones(table.shape[0], dtype=bool)
        g = self.graph
        for f in filters:
            if isinstance(f, Regex):
                col = q.var_to_vertex.get(f.var.name)
                if col is None:
                    continue
                pat = _re.compile(f.pattern)
                vals = table[:, col]
                km = np.zeros(table.shape[0], dtype=bool)
                for i, v in enumerate(vals):
                    if v >= 0:
                        term = self.maps.dict.term(int(self.maps.vertex_to_term[v]))
                        km[i] = bool(pat.search(term.strip('"')))
                keep &= km
            elif isinstance(f, Comparison):
                lv = _col_values(f.lhs, table, q, g)
                rv = _col_values(f.rhs, table, q, g)
                if lv is None or rv is None:
                    continue
                with np.errstate(invalid="ignore"):
                    keep &= np_cmp(lv - rv + 0.0, f.op, 0.0) if np.ndim(rv) else \
                        np_cmp(lv, f.op, float(rv))
        table = table[keep]
        ptable = ptable[keep]
        return table, ptable, origins[keep] if origins is not None else None


# --------------------------------------------------------------------------


def _annotate_steps(plan_desc: dict, exec_stats: dict | None) -> None:
    """Merge one executor run's per-step counters into an explain_plan
    description (in place) — the EXPLAIN ANALYZE view."""
    if not exec_stats:
        return
    for i, rec in enumerate(plan_desc.get("steps", [])):
        for src, dst in (("step_rows", "actual_expanded"),
                         ("step_kept", "actual_rows"),
                         ("step_retries", "retries"),
                         ("step_prune_in", "prune_in"),
                         ("step_prune_out", "prune_out")):
            vals = exec_stats.get(src)
            if vals is not None and i < len(vals):
                rec[dst] = int(vals[i])
        if rec.get("prune_in"):
            rec["prune_ratio"] = round(rec["prune_out"] / rec["prune_in"], 4)
        if "actual_rows" in rec and rec.get("est_rows") is not None:
            rec["q_error"] = round(qerror(rec["est_rows"],
                                          rec["actual_rows"]), 3)
        wall = exec_stats.get("step_wall_ms")
        if wall is not None and i < len(wall):
            rec["wall_ms"] = round(float(wall[i]), 3)
        caps = exec_stats.get("caps")
        if caps and i < len(caps):
            rec["capacity"] = int(caps[i])
    plan_desc["exec"] = {
        "chunks": exec_stats.get("chunks", 0),
        "resumes": exec_stats.get("resumes", 0),
        "compiles": exec_stats.get("compiles", 0),
        "wall_ms": round(float(exec_stats.get("wall_ms", 0.0)), 3),
    }


def _col_values(term, table, q: QueryGraph, g):
    if isinstance(term, Var):
        col = q.var_to_vertex.get(term.name)
        if col is None or g.numeric_value is None:
            return None
        ids = np.clip(table[:, col], 0, g.n_vertices - 1)
        vals = g.numeric_value[ids].copy()
        vals[table[:, col] < 0] = np.nan
        return vals
    if isinstance(term, Literal) and term.numeric is not None:
        return term.numeric
    return None


def _split_filters(filters, q: QueryGraph):
    """cheap: {var: [(op, const)]} pushed inline; expensive: post-hoc list."""
    cheap: dict[str, list[tuple[str, float]]] = {}
    expensive = []
    for f in filters:
        if (isinstance(f, Comparison) and isinstance(f.lhs, Var)
                and isinstance(f.rhs, Literal) and f.rhs.numeric is not None):
            cheap.setdefault(f.lhs.name, []).append((f.op, f.rhs.numeric))
        elif (isinstance(f, Comparison) and isinstance(f.rhs, Var)
              and isinstance(f.lhs, Literal) and f.lhs.numeric is not None):
            flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                       "=": "=", "!=": "!="}[f.op]
            cheap.setdefault(f.rhs.name, []).append((flipped, f.lhs.numeric))
        else:
            expensive.append(f)
    return cheap, expensive


def _merge_query(q_base: QueryGraph, opt_triples, maps):
    """Extend a base query graph with OPTIONAL triples; base vertices keep
    their column indices, new vertices append."""
    from repro_torch.core.query import build_query_graph as _bqg

    # Build combined graph over base + optional triples by rebuilding with
    # the base's variable order fixed first.
    q_ext = QueryGraph()
    q_ext.vertices = [  # copy base vertices
        type(v)(var=v.var, labels=v.labels, bound_id=v.bound_id, term=v.term)
        for v in q_base.vertices
    ]
    q_ext.var_to_vertex = dict(q_base.var_to_vertex)
    q_ext.pvars = list(q_base.pvars)
    q_ext.unsat = q_base.unsat
    # note: base edges already satisfied; extension plan only needs new edges
    tmp = _bqg(opt_triples, maps)
    # remap tmp vertices into q_ext
    remap: dict[int, int] = {}
    for ti, tv in enumerate(tmp.vertices):
        if tv.var is not None and tv.var in q_ext.var_to_vertex:
            idx = q_ext.var_to_vertex[tv.var]
            # merge labels onto the existing vertex (type triples in OPTIONAL)
            merged = tuple(sorted({*q_ext.vertices[idx].labels, *tv.labels}))
            q_ext.vertices[idx].labels = merged
        else:
            idx = len(q_ext.vertices)
            q_ext.vertices.append(
                type(tv)(var=tv.var, labels=tv.labels, bound_id=tv.bound_id,
                         term=tv.term))
            if tv.var is not None:
                q_ext.var_to_vertex[tv.var] = idx
        remap[ti] = idx
    new_edges = []
    for e in tmp.edges:
        pv = e.pvar
        if pv is not None and pv not in q_ext.pvars:
            q_ext.pvars.append(pv)
        new_edges.append(type(e)(remap[e.u], remap[e.v], e.elabel, pv))
    q_ext.edges = new_edges  # ONLY the optional edges (extension steps)
    q_ext.unsat = q_ext.unsat or tmp.unsat
    base_cols = q_base.n_vertices
    return q_ext, remap, base_cols


def _align_columns(rows: np.ndarray, have: list[str], want: list[str]):
    out = np.full((rows.shape[0], len(want)), -1, dtype=np.int32)
    for i, var in enumerate(want):
        if var in have:
            out[:, i] = rows[:, have.index(var)]
    return out
