"""Full SPARQL evaluation: BGP + OPTIONAL + FILTER + UNION (paper §5.1).

The port of ``repro.core.sparql_exec`` onto the torch executor, over a
static graph or a live-store snapshot (``set_graph`` swaps in a newer
one).  Orchestrates the vectorized executor:

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
One level further, ``compile_param`` hoists a query's non-structural
constants into parameters, so every query of a *shape* shares one plan
(a :class:`ParamFamily`), and ``execute_param_batch`` answers many of them
in one batch program (``Executor.run_batch``).

The engine runs on one torch ``device`` (default ``"cuda"``, which raises
without CUDA; ``"cpu"`` runs the kernels' plain versions): the executor's
chunk programs and the planner's signature prune probe both run there.
"""

from __future__ import annotations

import re as _re
import contextlib
import threading
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

_NULL_CM = contextlib.nullcontext()


def _maybe_span(trace, name: str, **meta):
    """A trace span when tracing is on, else a shared no-op context."""
    return trace.span(name, **meta) if trace is not None else _NULL_CM


def _as_trace(trace):
    """Normalize the public ``trace`` argument: False/None → off, True →
    a fresh forced trace (profiled steps), a Trace instance → itself."""
    if trace is None or trace is False:
        return None
    if trace is True:
        from repro_torch.obs import Trace

        return Trace(profile_steps=True)
    return trace

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


@dataclass
class ParamFamily:
    """One parameterized plan shared by every query of a *shape*.

    Built by :meth:`SparqlEngine.compile_param` from a
    :class:`~repro_torch.serve.fingerprint.ParamQuery`: non-structural
    constants are hoisted into ``plan`` parameter slots (inputs of the
    chunk program on the device), so one plan answers any member of the
    family, and :meth:`SparqlEngine.execute_param_batch` answers many
    members in one batch program.  ``variables`` / ``kinds`` use
    shape-canonical names; callers rename per query."""

    shape: str
    query: SelectQuery      # the blinded-canonical shape AST
    q: QueryGraph
    plan: ExecPlan
    expensive: list         # post-hoc filters (shared by all members)
    variables: list[str]
    kinds: list[str]
    n_params: int
    # solution modifiers are part of the shape (serialized un-blinded)
    distinct: bool = False
    limit: int | None = None
    offset: int = 0
    plan_ms: float = 0.0

    @property
    def has_modifiers(self) -> bool:
        return self.distinct or self.limit is not None or self.offset > 0


# cached plan-cache verdict: this shape cannot be parameterized (structural
# reasons only — data-dependent misses are never cached)
_PARAM_INELIGIBLE = object()


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
        from repro_torch.serve.cache import CacheStats, PlanCache

        self.graph = graph
        self.maps = maps
        self.opts = opts or ExecOpts()
        self.estimate = estimate
        self.executor = Executor(graph, self.opts, device=device)
        self.device = self.executor.device
        if plan_cache is None:
            plan_cache = PlanCache(capacity=256)
        self._plan_cache = plan_cache
        # parameterized-family compilation accounting (a hit = a query
        # answered by an already-compiled shape plan)
        self.param_stats = CacheStats()
        # workload feedback: fingerprint -> {"fanouts", "version"} —
        # observed per-edge fanouts injected into the next compile of
        # that fingerprint (see apply_feedback / repro_torch.obs.workload)
        self._feedback: dict[str, dict] = {}
        self._feedback_lock = threading.Lock()

    # ------------------------------------------------------------------ API
    @property
    def plan_cache(self):
        return self._plan_cache

    def set_graph(self, g) -> None:
        """Point the engine at a new graph state (live-store updates).

        A newer :class:`~repro_torch.store.versioned.Snapshot` of the *same*
        base swaps into the existing executor: chunk programs and the plan
        cache survive; only the delta arrays change.  A different base
        (after a compaction, or a plain graph) rebuilds the executor on the
        same device; the plan cache still survives, since plans are
        structural and snapshot execution re-resolves their candidate sets
        per version."""
        self.graph = g
        if (getattr(g, "is_snapshot", False) and self.executor.view is not None
                and g.base is self.executor.graph):
            self.executor.set_snapshot(g)
        else:
            # carry the retry policy and learned degradation levels across
            # the rebuild (plan signatures are structural, so they remain
            # valid keys against the new graph state)
            prev = self.executor
            self.executor = Executor(g, self.opts, device=self.device,
                                     policy=prev.policy,
                                     breaker=prev.breaker)

    def apply_feedback(self, fingerprint: str, fanouts: dict) -> int:
        """Install workload-observed per-edge fanouts for a fingerprint
        and mark its cached plan stale.

        ``fanouts`` maps ``(child, parent, elabel, forward)`` query-vertex
        keys (stable across recompiles of the same canonical query) to
        observed ``(surviving, raw)`` expansion factors — the shape
        :meth:`repro_torch.obs.workload.WorkloadProfile.observed_fanouts`
        produces.  The next :meth:`compile_canonical` of this fingerprint
        re-runs order search with those numbers injected into the cost
        model (plan ``search`` gains a ``+fb<version>`` tag).  Bounded
        (oldest fingerprints evicted) and versioned; results are
        unchanged as multisets — only order search and capacity presizing
        see the feedback.  Returns the new feedback version."""
        clamp = lambda v: float(min(1e6, max(1e-4, v)))  # noqa: E731
        clean = {k: (clamp(c), clamp(r)) for k, (c, r) in fanouts.items()}
        with self._feedback_lock:
            prev = self._feedback.pop(fingerprint, None)
            version = (prev["version"] if prev else 0) + 1
            self._feedback[fingerprint] = {"fanouts": clean,
                                           "version": version}
            while len(self._feedback) > 64:
                self._feedback.pop(next(iter(self._feedback)))
        self._plan_cache.pop(fingerprint)
        return version

    def clear_feedback(self) -> None:
        """Drop all workload feedback (plans recompile without overrides
        on their next cache miss)."""
        with self._feedback_lock:
            self._feedback.clear()

    def feedback_snapshot(self) -> dict[str, int]:
        """fingerprint -> feedback version, for debug endpoints."""
        with self._feedback_lock:
            return {fp: e["version"] for fp, e in self._feedback.items()}

    def compile(self, source: str | SelectQuery, trace=None):
        """Canonicalize + compile through the plan cache.

        Returns ``(compiled, canon)`` where ``compiled`` is a (possibly
        shared) :class:`CompiledQuery` over canonical variable names and
        ``canon`` is the :class:`~repro_torch.serve.fingerprint.CanonicalQuery`
        carrying this caller's variable renaming.
        """
        from repro_torch.serve.fingerprint import canonicalize_query

        if isinstance(source, str):
            with _maybe_span(trace, "parse"):
                ast = parse_sparql(source)
        else:
            ast = source
        with _maybe_span(trace, "fingerprint"):
            canon = canonicalize_query(ast)
        return self.compile_canonical(canon, trace=trace), canon

    def compile_canonical(self, canon, *, with_fresh: bool = False,
                          trace=None):
        """Compile a pre-canonicalized query through the plan cache.

        With ``with_fresh=True`` returns ``(compiled, fresh)`` where
        ``fresh`` tells whether *this call* built the plan (vs. a cache
        hit) — callers recording plan-search metrics need that rather than
        inferring it from shared cache counters, which races under
        concurrent compilation."""
        compiled = self._plan_cache.get(canon.fingerprint)
        fresh = compiled is None
        if trace is not None:
            trace.event("plan_cache", hit=not fresh)
        if fresh:
            with _maybe_span(trace, "plan_search") as sp:
                compiled = self._compile_ast(canon.query, canon.fingerprint)
                if trace is not None:
                    sp.meta.update(
                        plan_ms=round(compiled.plan_ms, 3),
                        est_rows=round(compiled.estimated_rows(), 1),
                        branches=[
                            {"order": explain_plan(br.plan).get("order", []),
                             "search": br.plan.search,
                             "est_rows": round(br.plan.estimated_rows(), 1)}
                            for br in compiled.branches])
            # live store: an unsat verdict is only as old as this snapshot
            # (a later update may intern the missing term), so such queries
            # recompile instead of caching the verdict
            if not (getattr(self.graph, "is_snapshot", False)
                    and compiled.any_unsat):
                self._plan_cache.put(canon.fingerprint, compiled)
        return (compiled, fresh) if with_fresh else compiled

    def compile_param(self, pq, trace=None) -> ParamFamily | None:
        """Compile (through the plan cache) the parameterized plan for a
        :class:`~repro_torch.serve.fingerprint.ParamQuery`'s shape.

        Returns a :class:`ParamFamily`, or ``None`` when the shape cannot
        be parameterized: OPTIONAL/UNION shapes, shapes with no hoistable
        constants, plans whose cross-component restart step would need a
        re-baked candidate set per constant vector — all structural, so the
        verdict is cached — or (data-dependent, never cached) a family
        representative whose constant is missing from the dictionary.
        Callers fall back to :meth:`compile` / :meth:`execute_compiled`.
        Families are cached under the tuple key ``("shape", hash)``, which
        cannot collide with plain fingerprint-string keys."""
        key = ("shape", pq.shape)
        cached = self._plan_cache.get(key)
        if cached is not None:
            self.param_stats.hits += 1
            if trace is not None:
                trace.event("param_cache", hit=True,
                            eligible=cached is not _PARAM_INELIGIBLE)
            return None if cached is _PARAM_INELIGIBLE else cached
        self.param_stats.misses += 1
        if trace is not None:
            trace.event("param_cache", hit=False)
        ast = pq.shape_query
        g = ast.where
        if not pq.consts or g.optionals or g.unions:
            self._plan_cache.put(key, _PARAM_INELIGIBLE)
            return None
        from repro_torch.serve.fingerprint import iter_param_occurrences

        param_ids = {id(t): k
                     for k, t in enumerate(iter_param_occurrences(g))}
        with _maybe_span(trace, "plan_search"):
            q = build_query_graph(g.triples, self.maps, param_ids=param_ids)
            if q.param_missing:
                # the representative's constant is missing; other members
                # may resolve, so no verdict is cached
                return None
            cheap, expensive = _split_filters(g.filters, q)
            if q.unsat:
                # unsat whatever the hoisted constants (a missing predicate
                # or class): final only on an immutable graph
                if not getattr(self.graph, "is_snapshot", False):
                    self._plan_cache.put(key, _PARAM_INELIGIBLE)
                return None
            plan = build_plan(self.graph, q, estimate=self.estimate,
                              num_filters=cheap, use_nlf=self.opts.use_nlf,
                              use_deg=self.opts.use_deg,
                              use_sig=self.opts.use_prune,
                              device=self.device)
        if (plan.n_params != len(pq.consts)
                or any(s.restart_candidates is not None and s.param_slot >= 0
                       for s in plan.steps)):
            # a parameterized constant anchors its own component: its baked
            # restart-candidate set would vary per constant vector
            self._plan_cache.put(key, _PARAM_INELIGIBLE)
            return None
        variables: list[str] = []
        kinds: list[str] = []
        want = ast.select or [v for v in q.var_to_vertex] + q.pvars
        for var in want:
            variables.append(var)
            kinds.append("vertex" if var in q.var_to_vertex
                         else "predicate" if var in q.pvars else "vertex")
        family = ParamFamily(shape=pq.shape, query=ast, q=q, plan=plan,
                             expensive=expensive, variables=variables,
                             kinds=kinds, n_params=len(pq.consts),
                             distinct=ast.distinct, limit=ast.limit,
                             offset=ast.offset, plan_ms=plan.build_ms)
        self._plan_cache.put(key, family)
        return family

    def resolve_params(self, consts) -> np.ndarray:
        """Constant keys (dictionary text form, as
        ``fingerprint.const_key`` makes them) → vertex-id vector; a term
        missing from the dictionary maps to ``-1``, the executor's
        provably-empty sentinel."""
        out = np.empty(len(consts), np.int32)
        for i, c in enumerate(consts):
            vid = self.maps.vertex_of(c)
            out[i] = -1 if vid is None else vid
        return out

    def _param_count_result(self, family: ParamFamily,
                            res: Result) -> QueryResult:
        return QueryResult(
            list(family.variables),
            np.zeros((0, len(family.variables)), np.int32),
            list(family.kinds), count=res.count,
            stats={"plan_ms": family.plan_ms,
                   "exec": {"branches": [{"base": res.stats}]}})

    def execute_param(self, family: ParamFamily, consts,
                      collect: str = "bindings", trace=None,
                      cancel: CancelToken | None = None) -> QueryResult:
        """Run one family member: resolve its constant vector and execute
        the shared parameterized plan.  Result columns carry the shape's
        canonical variable names (callers rename back)."""
        params = self.resolve_params(consts)
        executor = self.executor
        state = executor.pin()
        count_only = (collect == "count" and not family.expensive
                      and not family.has_modifiers)
        with _maybe_span(trace, "execute", branches=1):
            res = executor.run(
                family.plan, collect="count" if count_only else "bindings",
                state=state, trace=trace, params=params, cancel=cancel)
        if count_only:
            return self._param_count_result(family, res)
        return self._finish_param(family, res)

    def execute_param_batch(self, family: ParamFamily, const_rows,
                            collect: str = "bindings",
                            cancel: CancelToken | None = None,
                            trace=None) -> list[QueryResult]:
        """Answer ``B`` members of one family in one batch program
        (:meth:`Executor.run_batch`); each result equals what per-member
        :meth:`execute_param` returns.  ``trace`` records an ``execute``
        span (``lanes`` meta) over the batch program's spans."""
        if not const_rows:
            return []
        if len(const_rows) == 1:
            return [self.execute_param(family, const_rows[0], collect,
                                       trace=trace, cancel=cancel)]
        executor = self.executor
        state = executor.pin()
        mat = np.stack([self.resolve_params(c) for c in const_rows])
        count_only = (collect == "count" and not family.expensive
                      and not family.has_modifiers)
        with _maybe_span(trace, "execute", branches=1,
                         lanes=len(const_rows)):
            results = executor.run_batch(
                family.plan, mat,
                collect="count" if count_only else "bindings",
                state=state, cancel=cancel, trace=trace)
        return [self._param_count_result(family, res) if count_only
                else self._finish_param(family, res) for res in results]

    def _finish_param(self, family: ParamFamily, res: Result) -> QueryResult:
        """Post-executor finish for one family member: post-hoc filters,
        projection, and DISTINCT/OFFSET/LIMIT — the single-branch subset of
        :meth:`execute_compiled`, applied in the same order so results are
        identical to the unparameterized path."""
        table, ptable, _ = self._apply_expensive(res.bindings,
                                                 res.pvar_bindings,
                                                 family.q, family.expensive)
        q = family.q
        cols: list[np.ndarray] = []
        for var in family.variables:
            if var in q.var_to_vertex:
                cols.append(table[:, q.var_to_vertex[var]])
            elif var in q.pvars:
                cols.append(ptable[:, q.pvars.index(var)])
            else:
                cols.append(np.full(table.shape[0], -1, np.int32))
        rows = np.stack(cols, axis=1) if cols else np.zeros(
            (table.shape[0], 0), np.int32)
        if family.distinct:
            rows = np.unique(rows, axis=0)
        if family.offset:
            rows = rows[family.offset:]
        if family.limit is not None:
            rows = rows[: family.limit]
        # est_rows / step_card as execute_compiled reports them (estimates
        # are per shape, shared by every member of the family)
        step_card = [(float(est), int(actual))
                     for est, actual in zip(family.plan.est_rows,
                                            res.stats.get("step_kept") or [])]
        return QueryResult(list(family.variables), rows, list(family.kinds),
                           count=int(rows.shape[0]),
                           stats={"plan_ms": family.plan_ms,
                                  "est_rows": family.plan.estimated_rows(),
                                  "exec": {"branches": [{"base": res.stats}]},
                                  "step_card": step_card})

    def execute_compiled(self, compiled: CompiledQuery,
                         collect: str = "bindings",
                         profile: bool = False, trace=None,
                         cancel: CancelToken | None = None) -> QueryResult:
        """Run a compiled query; result columns keep its variable names.

        ``collect="count"`` lets branches without OPTIONALs, post-hoc
        filters or solution modifiers run the executor's count-only path
        (no binding-table materialization or device→host transfer); the
        result then has an exact ``count`` but empty ``rows``.  DISTINCT /
        OFFSET / LIMIT force materialization even for counts — they are
        applied to the assembled table here, after UNION concatenation.
        ``profile=True`` executes with per-step host syncs to fill
        per-step wall times in the stats.  ``trace`` records an
        ``execute`` span with per-branch / per-chunk / per-step children;
        a forced trace (``profile_steps=True``) implies ``profile``.
        ``cancel`` (a :class:`repro_torch.resilience.CancelToken`) is
        threaded into every executor run and checked between branches; on
        expiry a :class:`QueryCancelled` carries the stats accumulated so
        far."""
        if trace is not None and trace.profile_steps:
            profile = True
        all_rows: list[np.ndarray] = []
        total = 0
        exec_stats: list[dict] = []
        step_card: list[tuple[float, int]] = []
        variables, kinds = compiled.variables, compiled.kinds
        modifiers = compiled.has_modifiers
        # pin one executor AND its state (snapshot + device graph) for the
        # whole query: a concurrent update must not tear a UNION branch or
        # an OPTIONAL join across versions, and a rebuild in set_graph
        # replaces self.executor, so the object itself is captured too
        executor = self.executor
        state = executor.pin()
        with _maybe_span(trace, "execute", branches=len(compiled.branches)):
            for bi, br in enumerate(compiled.branches):
                if cancel is not None:
                    cancel.check({"exec": {"branches": exec_stats}})
                try:
                    with _maybe_span(trace, "branch", index=bi):
                        rows, count, info = self._exec_branch(
                            br, collect if not modifiers else "bindings",
                            profile, executor, state, trace, cancel)
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
              trace=False, timeout_ms: float | None = None,
              cancel: CancelToken | None = None) -> QueryResult:
        """Evaluate a SPARQL string.  ``trace=True`` forces a full trace
        (profiled steps) and attaches the finished span tree as
        ``result.stats["trace"]`` (the :class:`repro_torch.obs.Trace`
        itself as ``stats["trace_obj"]``); a Trace instance may also be
        passed to record into an existing trace.  ``timeout_ms`` sets a
        deadline for this call (raising
        :class:`repro_torch.resilience.QueryCancelled` on expiry);
        ``cancel`` passes an externally owned token instead."""
        t = _as_trace(trace)
        if t is None:
            return self.query_ast(parse_sparql(sparql), collect=collect,
                                  timeout_ms=timeout_ms, cancel=cancel)
        with t.span("parse"):
            ast = parse_sparql(sparql)
        return self.query_ast(ast, collect=collect, trace=t,
                              timeout_ms=timeout_ms, cancel=cancel)

    def query_ast(self, ast: SelectQuery, collect: str = "bindings",
                  trace=False, timeout_ms: float | None = None,
                  cancel: CancelToken | None = None) -> QueryResult:
        if cancel is None and timeout_ms is not None:
            cancel = CancelToken(time.monotonic() + timeout_ms / 1e3)
        t = _as_trace(trace)
        compiled, canon = self.compile(ast, trace=t)
        if cancel is not None:
            cancel.check()  # deadline may have expired during plan search
        res = self.execute_compiled(compiled, collect=collect, trace=t,
                                    cancel=cancel)
        res.variables = canon.restore(res.variables)
        if t is not None:
            t.finish()
            res.stats["trace"] = t.to_dict()
            res.stats["trace_obj"] = t
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

    def explain_param(self, source: str | SelectQuery) -> dict:
        """Describe a query's *parameterized family* plan: the shape hash,
        the hoisted constants with their parameter slots, and the plan with
        ``param[k]`` markers where the executor reads its device inputs
        instead of baked ids.  Returns ``{"parameterized": False, ...}``
        with the plain explain when the shape cannot be parameterized."""
        from repro_torch.serve.fingerprint import parameterize_query

        pq = parameterize_query(source)
        family = self.compile_param(pq)
        if family is None:
            return {"parameterized": False, "shape": pq.shape,
                    "constants": list(pq.consts),
                    "explain": self.explain(source)}
        desc = explain_plan(family.plan, self.maps)
        inv = pq.inverse
        return {
            "parameterized": True,
            "shape": family.shape,
            "params": [{"slot": k, "constant": c}
                       for k, c in enumerate(pq.consts)],
            "variables": [inv.get(v, v) for v in family.variables],
            "plan": desc,
        }

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
        with self._feedback_lock:
            fb = self._feedback.get(fingerprint)
        # feedback fanouts are keyed by branch-0 query-vertex indices
        # (profiles fold branch-0 base stats), so only that branch's base
        # plan sees them; UNION siblings keep static estimates
        branches = [self._compile_group(
                        g, ast.select,
                        observed=fb["fanouts"] if fb and i == 0 else None)
                    for i, g in enumerate(self._expand_unions(ast.where))]
        if fb and branches:
            p = branches[0].plan
            p.search = f"{p.search}+fb{fb['version']}"
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

    def _compile_group(self, g: GroupPattern, select: list[str],
                       observed: dict | None = None) -> CompiledBranch:
        q = build_query_graph(g.triples, self.maps)
        cheap, expensive = _split_filters(g.filters, q)
        plan = build_plan(self.graph, q, estimate=self.estimate,
                          num_filters=cheap,
                          use_nlf=self.opts.use_nlf, use_deg=self.opts.use_deg,
                          use_sig=self.opts.use_prune,
                          observed_fanout=observed, device=self.device)
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
                     state: tuple | None = None, trace=None,
                     cancel: CancelToken | None = None):
        """Run one branch; returns ``(rows | None, count, exec_stats)``."""
        executor = self.executor if executor is None else executor
        count_only = (collect == "count" and not br.optionals
                      and not br.expensive)
        res = executor.run(
            br.plan, collect="count" if count_only else "bindings",
            profile=profile, state=state, trace=trace, cancel=cancel)
        info: dict = {"base": res.stats}
        if count_only:
            return None, res.count, info
        table, ptable, _ = self._apply_expensive(res.bindings,
                                                 res.pvar_bindings,
                                                 br.q, br.expensive)
        opt_stats: list[dict] = []
        for oi, co in enumerate(br.optionals):
            with _maybe_span(trace, "optional", index=oi):
                table, ptable, ost = self._exec_left_join(table, ptable, co,
                                                          profile, executor,
                                                          state, trace,
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
                        executor=None, state: tuple | None = None,
                        trace=None, cancel: CancelToken | None = None):
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
                                   profile=profile, state=state, trace=trace,
                                   cancel=cancel)
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
