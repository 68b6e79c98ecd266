"""Multi-dataset SPARQL HTTP service over the paper's engine, on torch.

The port of ``repro.serve.server``: the same registry, endpoints, bodies
and status codes, with every hosted engine on the registry's torch device
(``device="cuda"`` by default, which raises without CUDA; ``"cpu"`` runs
the kernels' plain versions).

``DatasetRegistry`` hosts several transformed graphs (lubm / bsbm / hetero
/ loaded N-Triples) behind one process: each dataset gets its own
``SparqlEngine`` with a fingerprint-keyed plan cache, an optional result
cache keyed ``(fingerprint, graph_version)``, and a version counter whose
bump is the explicit invalidation point for cached results.

``SparqlHTTPServer`` is a stdlib ``ThreadingHTTPServer`` exposing

- ``GET/POST /sparql`` — ``query`` + optional ``dataset``/``limit``/
  ``timeout_ms``/``explain`` parameters (query string, form body, JSON
  body, or raw ``application/sparql-query``), answering SPARQL-JSON-style
  bindings; ``explain=1`` returns the compiled plan (matching order,
  per-step cardinality estimates) without executing;
- ``GET /healthz`` — liveness + hosted datasets;
- ``GET /metrics`` — Prometheus text exposition;
- ``GET /debug/slow`` — per-dataset slow-query log digest (worst traced
  executions by fingerprint);
- ``GET /debug/trace?id=N`` — one logged trace in full: span tree +
  EXPLAIN-ANALYZE-style plan, or Chrome ``trace_event`` JSON with
  ``format=chrome`` (load in chrome://tracing / Perfetto);
- ``GET /debug/workload`` — per-(dataset, plan) workload profiles:
  q-error accounting, observed fanouts, kernel mix, prune ratios,
  batch-lane fill, plus each engine's applied-feedback versions;
- ``GET /debug/decisions`` — the decision journal (plan-cache hits,
  small-plan probes, batch coalescing, replans, cancellations), newest
  first; filter with ``?kind=`` / ``?limit=``.

``/sparql`` additionally accepts ``trace=1``: the request executes in
profiled mode with a forced :class:`repro_torch.obs.Trace` and the response
carries the span tree under ``"trace"``.  A registry-level
``trace_sample`` rate traces that fraction of ordinary requests on the
fast path (zero-duration step spans) to feed the slow-query log and the
``repro_span_seconds`` histograms without the profiled path's overhead.

Requests flow through the :class:`~repro_torch.serve.scheduler.Scheduler`, so
identical concurrent queries coalesce and overload returns 503 rather than
piling onto the engine.
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from repro_torch.core.exec import ExecOpts, resolve_device
from repro_torch.core.planner import PlanError
from repro_torch.core.query import QueryBuildError
from repro_torch.core.sparql_exec import QueryResult, SparqlEngine
from repro_torch.obs import (DecisionJournal, SlowQueryLog, Trace,
                       WorkloadProfiler)
from repro_torch.rdf.sparql import SparqlError
from repro_torch.resilience import faults
from repro_torch.resilience.cancel import CancelToken, QueryCancelled
from repro_torch.serve.cache import PlanCache, ResultCache
from repro_torch.serve.fingerprint import CanonicalQuery
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import (DeadlineExceeded, Overloaded, Scheduler,
                                   SchedulerError, SchedulerShutdown,
                                   SchedulerStopped)
from repro_torch.utils import get_logger, log_event

log = get_logger("serve.server")


class UnknownDataset(KeyError):
    pass


def _shape_key(shape: str) -> str:
    """Short stable digest of a parameterized shape (the serialized shape
    AST is too long for journal entries / workload profile keys)."""
    return hashlib.sha1(shape.encode()).hexdigest()[:12]


class UpdateNotSupported(ValueError):
    """Dataset registered without ``updatable=True``."""


@dataclass
class HostedDataset:
    name: str
    graph: object
    maps: object
    engine: SparqlEngine
    result_cache: ResultCache
    store: object = None  # VersionedStore when updatable
    version: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock)
    slow_log: SlowQueryLog = field(default_factory=SlowQueryLog)

    def current_graph(self):
        return self.store.snapshot() if self.store is not None else self.graph


class DatasetRegistry:
    """Named graphs + engines, the unit the scheduler executes against.

    Every engine it builds runs on ``device`` (default ``"cuda"``, which
    raises here without CUDA; pass ``"cpu"`` for the plain kernels).  The
    scheduler's workers call into it from several threads at once."""

    def __init__(self, metrics: ServeMetrics | None = None, *,
                 plan_cache_size: int = 256, result_cache_size: int = 0,
                 slow_log_size: int = 32, trace_sample: float = 0.0,
                 feedback: bool = False, qerror_threshold: float = 8.0,
                 feedback_min_runs: int = 5, workload_size: int = 256,
                 journal_size: int = 512, device="cuda"):
        self.device = resolve_device(device)
        self.metrics = metrics or ServeMetrics()
        self._default_plan_cache_size = plan_cache_size
        self._default_result_cache_size = result_cache_size
        self._slow_log_size = slow_log_size
        self.trace_sample = min(1.0, max(0.0, float(trace_sample)))
        # workload intelligence: every completed execution folds into a
        # bounded per-(dataset, plan) profile, every engine choice lands in
        # the journal.  ``feedback=True`` closes the loop — consistently
        # misestimated shapes get their cached plan marked stale and the
        # recompile re-runs order search with observed fanouts.  Off by
        # default: feedback changes plan-cache behaviour (replans evict
        # entries), which opt-in deployments should choose knowingly.
        self.journal = DecisionJournal(journal_size)
        self.workload = WorkloadProfiler(
            max_profiles=workload_size, feedback=feedback,
            qerror_threshold=qerror_threshold, min_runs=feedback_min_runs,
            journal=self.journal)
        self._datasets: dict[str, HostedDataset] = {}
        self._lock = threading.Lock()

    def _journal(self, kind: str, **fields) -> None:
        """Record one engine decision + bump its Prometheus counter."""
        self.journal.record(kind, **{k: v for k, v in fields.items()
                                     if v is not None})
        self.metrics.decisions.inc(kind=kind)

    # ------------------------------------------------------------- hosting
    def register(self, name: str, graph, maps, opts: ExecOpts | None = None,
                 *, plan_cache_size: int | None = None,
                 result_cache_size: int | None = None,
                 updatable: bool = False,
                 store=None) -> HostedDataset:
        """Host a dataset on the registry's device.  ``updatable=True``
        wraps the graph in a
        :class:`~repro_torch.store.versioned.VersionedStore` (or accepts a
        pre-built one via ``store=``): the engine then executes against
        live snapshots and ``POST /update`` mutates the data in place."""
        plan_cache = PlanCache(self._default_plan_cache_size
                               if plan_cache_size is None else plan_cache_size)
        result_cache = ResultCache(self._default_result_cache_size
                                   if result_cache_size is None
                                   else result_cache_size)
        if updatable and store is None:
            from repro_torch.store import VersionedStore
            store = VersionedStore(graph, maps)
        engine_graph = store.snapshot() if store is not None else graph
        engine = SparqlEngine(engine_graph, maps, opts, plan_cache=plan_cache,
                              device=self.device)
        ds = HostedDataset(name=name, graph=graph, maps=maps, engine=engine,
                           result_cache=result_cache, store=store,
                           version=store.version if store is not None else 0,
                           slow_log=SlowQueryLog(self._slow_log_size))
        with self._lock:
            self._datasets[name] = ds
        self.metrics.attach_cache_gauges(name, plan_cache, result_cache)
        self.metrics.attach_param_family_gauge(name, engine)
        self.metrics.attach_breaker_gauges(name, engine)
        return ds

    def get(self, name: str) -> HostedDataset:
        with self._lock:
            ds = self._datasets.get(name)
        if ds is None:
            raise UnknownDataset(name)
        return ds

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._datasets)

    def default_name(self) -> str:
        names = self.names()
        if not names:
            raise UnknownDataset("registry is empty")
        return names[0]

    def version(self, name: str) -> int:
        return self.get(name).version

    def invalidate(self, name: str) -> int:
        """Bump a dataset's graph version; retire its cached results.
        Call after mutating/reloading the graph in place.  The bump and
        the cache invalidation both happen under the dataset lock, and
        ``ResultCache.invalidate`` raises its version watermark — so an
        execution that captured the old version but finishes later cannot
        re-insert a stale result (the insertion race the old code had)."""
        ds = self.get(name)
        with ds.lock:
            stale = ds.version
            ds.version += 1
            return ds.result_cache.invalidate(stale)

    def update(self, name: str, update_text: str) -> dict:
        """Apply SPARQL UPDATE text to an updatable dataset: mutate the
        store, swap the engine to the fresh snapshot, bump the version and
        retire cached results — all under the dataset lock.  The plan
        cache deliberately survives (plans are structural; snapshot
        execution re-resolves their candidate sets)."""
        import time as _time

        ds = self.get(name)
        if ds.store is None:
            raise UpdateNotSupported(
                f"dataset {name!r} is not updatable; register it with "
                "updatable=True")
        t0 = _time.perf_counter()
        with ds.lock:
            before_compactions = ds.store.counters["compactions"]
            res = ds.store.apply_update(update_text)
            changed = bool(res["inserted"] or res["deleted"])
            if changed:
                ds.engine.set_graph(ds.store.snapshot())
                # ds.version can run ahead of the store's counter (the
                # public invalidate() bumps it independently) — always
                # move strictly forward so this update's invalidation
                # cannot be skipped
                ds.version = max(ds.version + 1, ds.store.version)
                res["invalidated"] = ds.result_cache.invalidate(
                    ds.version - 1)
                res["version"] = ds.version
            else:
                res["invalidated"] = 0
            compactions = ds.store.counters["compactions"] - before_compactions
        m = self.metrics
        m.updates.inc(dataset=name, status="ok")
        if res["inserted"]:
            m.update_triples.inc(res["inserted"], dataset=name, op="insert")
        if res["deleted"]:
            m.update_triples.inc(res["deleted"], dataset=name, op="delete")
        if compactions:
            m.compactions.inc(compactions)
        m.update_latency.observe((_time.perf_counter() - t0) * 1e3)
        res["dataset"] = name
        return res

    # ----------------------------------------------------------- execution
    def execute_canonical(self, name: str, canon: CanonicalQuery,
                          version: int, trace: Trace | None = None,
                          cancel: CancelToken | None = None,
                          query_id: str | None = None) -> QueryResult:
        """Execute over canonical variable names (scheduler entry point).

        ``trace`` is a live :class:`repro_torch.obs.Trace` (forced request);
        when absent, ``trace_sample`` of executions get a sampled trace on
        the fast path.  Traced executions bypass the result cache (there is
        nothing to observe about returning a stored object) and feed the
        slow-query log + span histograms.  ``cancel`` is the flight's
        cooperative-cancellation token: the executor polls it at chunk
        boundaries, so expired/abandoned requests stop occupying the
        device."""
        ds = self.get(name)
        key = (canon.fingerprint, version)
        if trace is None and self.trace_sample > 0.0 \
                and random.random() < self.trace_sample:
            trace = Trace(sampled=True)
        if trace is not None:
            # correlation labels for the span tree / Chrome export
            if trace.query_id is None:
                trace.query_id = query_id
            if trace.dataset is None:
                trace.dataset = name
            if trace.thread is None:
                trace.thread = threading.current_thread().name
        if ds.result_cache.enabled and trace is None:
            hit = ds.result_cache.get(key)
            if hit is not None:
                self._journal("result_cache", dataset=name, hit=True,
                              query_id=query_id,
                              fingerprint=canon.fingerprint)
                return hit
        if trace is not None and trace.root.children:
            # scheduler-submitted trace: account the time between the
            # submitting thread's last span and this worker picking it up
            last = trace.root.children[-1]
            gap = trace._now() - (last.t0 + last.dur)
            if gap > 0:
                trace.add("queue_wait", gap)
        compiled, fresh = ds.engine.compile_canonical(canon, with_fresh=True,
                                                      trace=trace)
        if fresh:
            self.metrics.record_plan_search(compiled.plan_ms)
        self._journal("plan_cache", dataset=name, hit=not fresh,
                      query_id=query_id, fingerprint=canon.fingerprint,
                      search=(compiled.branches[0].plan.search
                              if compiled.branches else None))
        try:
            res = ds.engine.execute_compiled(
                compiled, trace=trace,
                profile=trace.profile_steps if trace is not None else False,
                cancel=cancel)
        except QueryCancelled:
            self._journal("cancel", dataset=name, query_id=query_id,
                          fingerprint=canon.fingerprint)
            self.workload.record_cancel(name, canon.fingerprint)
            raise
        est = res.stats.get("est_rows")
        if est is not None:
            self.metrics.record_cardinality(est, res.count)
        for step_est, step_actual in res.stats.get("step_card", ()):
            self.metrics.record_step_cardinality(step_est, step_actual)
        exec_stats = res.stats.get("exec") or {}
        parts = [part
                 for br in exec_stats.get("branches", ())
                 for part in ([br.get("base") or {}]
                              + list(br.get("optionals") or ()))]
        retries = sum(sum(part.get("step_retries", ())) for part in parts)
        if retries:
            self.metrics.exec_retries.inc(retries)
        prune_in = sum(sum(part.get("step_prune_in", ())) for part in parts)
        if prune_in:
            self.metrics.prune_candidates_in.inc(prune_in)
            self.metrics.prune_candidates_out.inc(
                sum(sum(part.get("step_prune_out", ())) for part in parts))
        compiles = sum(part.get("compiles", 0) for part in parts)
        if compiles:
            self.metrics.compile_events.inc(compiles)
        degraded = sum(1 for part in parts if part.get("degraded_level"))
        if degraded:
            self.metrics.degraded.inc(degraded)
        branches = exec_stats.get("branches") or ()
        base = (branches[0].get("base") or {}) if branches else {}
        probe = base.get("small_probe")
        if probe:
            self._journal("small_probe", dataset=name, query_id=query_id,
                          fingerprint=canon.fingerprint,
                          legacy_wins=bool(probe.get("legacy_wins")),
                          t_pipelined_ms=round(
                              probe.get("t_pipelined_ms", 0.0), 3),
                          t_legacy_ms=round(probe.get("t_legacy_ms", 0.0), 3))
        self._journal("execute", dataset=name, query_id=query_id,
                      fingerprint=canon.fingerprint, count=res.count,
                      wall_ms=round(base.get("wall_ms") or 0.0, 3),
                      small_mode=bool(base.get("small_mode")) or None,
                      degraded=int(base.get("degraded_level") or 0) or None,
                      prune=any(v >= 0 for v in
                                base.get("step_prune_in") or ()) or None)
        if base and compiled.branches:
            # fold the run into the workload profile; feedback hints are
            # only possible for single-branch queries (the profile tracks
            # the branch-0 base plan, which for UNIONs is just one member)
            hint = self.workload.observe(
                name, canon.fingerprint, compiled.branches[0].plan, base,
                count=res.count, wall_ms=base.get("wall_ms") or 0.0,
                fingerprint=(canon.fingerprint
                             if len(compiled.branches) == 1 else None))
            if hint is not None:
                fb_version = ds.engine.apply_feedback(hint["fingerprint"],
                                                      hint["fanouts"])
                self.metrics.feedback_replans.inc()
                self._journal("replan", dataset=name, query_id=query_id,
                              fingerprint=hint["fingerprint"],
                              q_error=round(hint["q_error_median"], 2),
                              version=fb_version)
                log_event(log, "feedback_replan", dataset=name,
                          query_id=query_id,
                          fingerprint=hint["fingerprint"],
                          q_error=round(hint["q_error_median"], 2),
                          version=fb_version)
        if trace is not None:
            trace.finish()
            self.metrics.record_trace(trace)
            explain = ds.engine.describe_compiled(compiled,
                                                  run_stats=res.stats,
                                                  inverse=canon.inverse)
            if ds.slow_log.record(canon.fingerprint, trace.dur_ms, trace,
                                  dataset=name, count=res.count,
                                  explain=explain):
                self.metrics.slow_queries.inc(dataset=name)
            res.stats["trace"] = trace.to_dict()
        elif ds.result_cache.enabled and version == ds.version:
            ds.result_cache.put(key, res)
        return res

    def execute_canonical_batch(self, name: str, pqs, version: int,
                                cancel: CancelToken | None = None,
                                query_ids: list[str] | None = None) -> list:
        """Answer a same-shape batch in one parameterized dispatch
        (scheduler batch-leader entry point).

        ``pqs`` is a list of :class:`~repro_torch.serve.fingerprint.ParamQuery`
        sharing one shape; the shape compiles once
        (:meth:`~repro_torch.core.sparql_exec.SparqlEngine.compile_param`) and
        the members execute as one batch program.  Returns one
        ``QueryResult | Exception`` per member, in order, with canonical
        variable names (the scheduler restores each caller's).  Each
        member still probes the result cache under its own exact
        ``(fingerprint, version)`` key — the canonical fingerprint covers
        shape *and* constants, so this is the per-(shape, constants,
        graph_version) keying the batch path needs.  Shapes that cannot
        be parameterized fall back to per-member
        :meth:`execute_canonical`."""
        ds = self.get(name)
        self.metrics.batch_size.observe(len(pqs))
        if len(pqs) >= 2:
            self.metrics.coalesced_queries.inc(len(pqs))
        qids = query_ids or [None] * len(pqs)
        out: list = [None] * len(pqs)
        family = ds.engine.compile_param(pqs[0])
        if family is None:
            self._journal("batch", dataset=name, size=len(pqs),
                          query_id=qids[0], parameterized=False)
            for i, pq in enumerate(pqs):
                try:
                    out[i] = self.execute_canonical(name, pq.canon, version,
                                                    cancel=cancel,
                                                    query_id=qids[i])
                except Exception as e:  # noqa: BLE001 — per-member fan-out
                    out[i] = e
            return out
        self._journal("batch", dataset=name, size=len(pqs),
                      query_id=qids[0], parameterized=True,
                      shape=_shape_key(family.shape))
        todo: list[int] = []
        for i, pq in enumerate(pqs):
            if ds.result_cache.enabled:
                hit = ds.result_cache.get((pq.canon.fingerprint, version))
                if hit is not None:
                    out[i] = hit
                    continue
            todo.append(i)
        if not todo:
            return out
        try:
            results = ds.engine.execute_param_batch(
                family, [pqs[i].consts for i in todo], cancel=cancel)
        except Exception as e:  # noqa: BLE001 — fail the executed members
            for i in todo:
                out[i] = e
            return out
        plan_key = f"shape:{_shape_key(family.shape)}"
        for i, res in zip(todo, results):
            pq = pqs[i]
            # shape-canonical -> caller-original -> exact-canonical names
            names = [pq.canon.rename.get(v, v)
                     for v in pq.restore(res.variables)]
            r = QueryResult(names, res.rows, list(res.kinds),
                            count=res.count, stats=dict(res.stats))
            out[i] = r
            # cardinality accounting on the batch path too: the member
            # stats carry est_rows/step_card like the solo path does
            est = res.stats.get("est_rows")
            if est is not None:
                self.metrics.record_cardinality(est, res.count)
            for step_est, step_actual in res.stats.get("step_card", ()):
                self.metrics.record_step_cardinality(step_est, step_actual)
            mstats = (res.stats.get("exec") or {}).get("branches") or ()
            mbase = (mstats[0].get("base") or {}) if mstats else {}
            if mbase:
                # profile per shape (the unit the parameterized plan is
                # shared at); no feedback from here — the param family has
                # no single fingerprint to mark stale
                self.workload.observe(name, plan_key, family.plan, mbase,
                                      count=res.count,
                                      wall_ms=mbase.get("wall_ms") or 0.0)
            if ds.result_cache.enabled and version == ds.version:
                ds.result_cache.put((pq.canon.fingerprint, version), r)
        return out

    def execute(self, name: str, sparql: str) -> QueryResult:
        """Scheduler-less convenience path (tests, CLIs)."""
        from repro_torch.serve.fingerprint import canonicalize_query
        from repro_torch.rdf.sparql import parse_sparql

        canon = canonicalize_query(parse_sparql(sparql))
        res = self.execute_canonical(name, canon, self.version(name))
        return QueryResult(canon.restore(res.variables), res.rows,
                           list(res.kinds), count=res.count)

    def decode(self, name: str, res: QueryResult,
               limit: int | None = None) -> list[dict]:
        return res.decode(self.get(name).maps, limit=limit)

    def explain(self, name: str, sparql: str, analyze: bool = False) -> dict:
        """Describe the plan (order, start vertex, per-step estimates)
        without executing; compiles through the shared plan cache.
        ``analyze=True`` executes in profiled mode and adds per-step
        actual rows / retries / wall times (``explain=analyze``)."""
        return self.get(name).engine.explain(sparql, analyze=analyze)

    # -------------------------------------------------------- observability
    def workload_snapshot(self, limit: int | None = 50) -> dict:
        """Workload profiles (worst q-error first) plus each engine's
        applied-feedback versions — the ``/debug/workload`` payload."""
        return {
            "profiles": self.workload.snapshot(limit),
            "feedback_enabled": self.workload.feedback,
            "qerror_threshold": self.workload.qerror_threshold,
            "feedback": {n: self.get(n).engine.feedback_snapshot()
                         for n in self.names()},
            "decisions": dict(self.journal.counts),
        }

    def slow_summaries(self, name: str | None = None) -> dict:
        """Slow-query-log digests, per dataset (no span trees)."""
        names = [name] if name is not None else self.names()
        return {n: self.get(n).slow_log.summaries() for n in names}

    def find_trace(self, trace_id: int) -> dict | None:
        """Locate one logged trace entry by id across all datasets."""
        for n in self.names():
            entry = self.get(n).slow_log.get(trace_id)
            if entry is not None:
                return entry
        return None

    def stats(self) -> dict:
        out = {}
        for name in self.names():
            ds = self.get(name)
            g = ds.current_graph()
            rec = {
                "vertices": int(g.n_vertices),
                "edges": int(g.n_edges),
                "version": ds.version,
                "plan_cache": ds.engine.plan_cache.snapshot(),
                "result_cache": ds.result_cache.snapshot(),
                "resilience": ds.engine.executor.resilience_snapshot(),
            }
            if ds.store is not None:
                rec["store"] = {
                    "delta": ds.store.delta_size(),
                    "epoch": ds.store.epoch,
                    **ds.store.counters,
                }
            out[name] = rec
        return out


# ------------------------------------------------------------------- HTTP
def _bindings_json(registry: DatasetRegistry, dataset: str, res: QueryResult,
                   limit: int | None) -> dict:
    rows = registry.decode(dataset, res, limit=limit)
    bindings = []
    for rec in rows:
        b = {}
        for var, term in rec.items():
            if term is None:
                continue
            kind = "literal" if term.startswith('"') else "uri"
            b[var] = {"type": kind, "value": term.strip('"')}
        bindings.append(b)
    return {"head": {"vars": list(res.variables)},
            "results": {"bindings": bindings},
            "stats": {"count": res.count, "returned": len(bindings)}}


class _Handler(BaseHTTPRequestHandler):
    server: "SparqlHTTPServer"  # type: ignore[assignment]
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt: str, *args) -> None:  # route to our logger
        log.debug("%s %s", self.address_string(), fmt % args)

    def _send(self, code: int, body: bytes, ctype: str,
              headers: dict[str, str] | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: dict,
                   headers: dict[str, str] | None = None) -> None:
        self._send(code, json.dumps(obj).encode(),
                   "application/json; charset=utf-8", headers)

    def _error(self, code: int, message: str,
               headers: dict[str, str] | None = None, **extra) -> None:
        self._send_json(code, {"error": message, **extra}, headers)

    # ------------------------------------------------------------ endpoints
    def do_GET(self) -> None:  # noqa: N802 (http.server naming)
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._send_json(200, {"status": "ok",
                                  "datasets": self.server.registry.stats(),
                                  "scheduler": self.server.scheduler.snapshot(),
                                  "faults": faults.describe()})
        elif url.path == "/metrics":
            text = self.server.metrics.registry.render()
            self._send(200, text.encode(), "text/plain; version=0.0.4")
        elif url.path == "/sparql":
            params = {k: v[-1] for k, v in parse_qs(url.query).items()}
            self._handle_sparql(params)
        elif url.path == "/debug/slow":
            params = {k: v[-1] for k, v in parse_qs(url.query).items()}
            try:
                out = self.server.registry.slow_summaries(
                    params.get("dataset"))
            except UnknownDataset as e:
                self._error(404, f"unknown dataset: {e}")
            else:
                self._send_json(200, {"slow": out})
        elif url.path == "/debug/workload":
            params = {k: v[-1] for k, v in parse_qs(url.query).items()}
            try:
                limit = int(params.get("limit", 50))
            except ValueError:
                self._error(400, "non-integer 'limit' parameter")
                return
            self._send_json(200,
                            self.server.registry.workload_snapshot(limit))
        elif url.path == "/debug/decisions":
            params = {k: v[-1] for k, v in parse_qs(url.query).items()}
            try:
                limit = int(params.get("limit", 100))
            except ValueError:
                self._error(400, "non-integer 'limit' parameter")
                return
            journal = self.server.registry.journal
            self._send_json(200, {
                "decisions": journal.snapshot(limit=limit,
                                              kind=params.get("kind")),
                "counts": dict(journal.counts)})
        elif url.path == "/debug/trace":
            params = {k: v[-1] for k, v in parse_qs(url.query).items()}
            try:
                trace_id = int(params["id"])
            except (KeyError, ValueError):
                self._error(400, "missing or non-integer 'id' parameter")
                return
            entry = self.server.registry.find_trace(trace_id)
            if entry is None:
                self._error(404, f"no logged trace with id {trace_id} "
                                 "(evicted, or never recorded)")
                return
            fmt = "chrome" if params.get("format") == "chrome" else "json"
            self._send_json(200, SlowQueryLog.render_entry(entry, fmt))
        else:
            self._error(404, f"no such endpoint: {url.path}")

    def do_POST(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        if url.path not in ("/sparql", "/update"):
            self._error(404, f"no such endpoint: {url.path}")
            return
        body_key = "query" if url.path == "/sparql" else "update"
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        params = {k: v[-1] for k, v in parse_qs(url.query).items()}
        try:
            if ctype == "application/json":
                obj = json.loads(raw.decode() or "{}")
                if not isinstance(obj, dict):
                    self._error(400, "JSON body must be an object")
                    return
                params.update(obj)
            elif ctype == "application/x-www-form-urlencoded":
                params.update({k: v[-1]
                               for k, v in parse_qs(raw.decode()).items()})
            elif raw.strip():  # sparql-query / -update / text/plain: raw body
                params[body_key] = raw.decode()
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            self._error(400, f"bad request body: {e}")
            return
        if (url.path == "/update" and "update" not in params and raw.strip()
                and ctype != "application/json"):
            # curl --data-binary defaults to form-encoding; a raw SPARQL
            # UPDATE body form-parses to garbage keys — fall back to it
            params["update"] = raw.decode()
        if url.path == "/update":
            self._handle_update(params)
        else:
            self._handle_sparql(params)

    def _handle_update(self, params: dict) -> None:
        from repro_torch.store import UpdateError

        update = params.get("update")
        if not update:
            self._error(400, "missing 'update' parameter "
                             "(SPARQL INSERT DATA / DELETE DATA)")
            return
        registry = self.server.registry
        try:
            dataset = params.get("dataset") or registry.default_name()
            res = registry.update(dataset, update)
        except UnknownDataset as e:
            self._error(404, f"unknown dataset: {e}")
        except UpdateNotSupported as e:
            self._error(409, str(e))
        except UpdateError as e:
            self.server.metrics.updates.inc(
                dataset=params.get("dataset") or "?", status="error")
            self._error(400, str(e))
        except Exception as e:  # noqa: BLE001 — keep the handler alive
            log.exception("internal error applying update")
            self._error(500, f"internal error: {e}")
        else:
            self._send_json(200, res)

    def _handle_sparql(self, params: dict) -> None:
        query = params.get("query")
        if not query:
            self._error(400, "missing 'query' parameter")
            return
        registry = self.server.registry
        try:
            dataset = params.get("dataset") or registry.default_name()
            limit = int(params["limit"]) if "limit" in params else None
            timeout_s = (float(params["timeout_ms"]) / 1e3
                         if "timeout_ms" in params else None)
            explain_param = str(params.get("explain", "")).lower()
            explain = explain_param in ("1", "true", "yes", "analyze")
            analyze = explain_param == "analyze"
            trace = (str(params.get("trace", "")).lower()
                     in ("1", "true", "yes"))
        except (ValueError, UnknownDataset) as e:
            self._error(400, str(e))
            return
        if explain:
            # plan description only — no scheduler round-trip.  analyze mode
            # executes the query once, in profiled mode (deliberately slow:
            # per-step host syncs), on this handler thread; it bypasses the
            # scheduler, so a dedicated semaphore bounds how many profiled
            # runs may be in flight — excess analyze requests get 503.
            gate = self.server.analyze_gate if analyze else None
            if gate is not None and not gate.acquire(blocking=False):
                self._error(503, "too many explain=analyze runs in flight")
                return
            try:
                plan = registry.explain(dataset, query, analyze=analyze)
            except UnknownDataset as e:
                self._error(404, f"unknown dataset: {e}")
            except (SparqlError, QueryBuildError, PlanError) as e:
                self._error(400, str(e))
            except Exception as e:  # noqa: BLE001 — keep the handler alive
                log.exception("internal error explaining query")
                self._error(500, f"internal error: {e}")
            else:
                self._send_json(200, {"dataset": dataset, "explain": plan})
            finally:
                if gate is not None:
                    gate.release()
            return
        t0 = time.perf_counter()
        try:
            res = self.server.scheduler.submit(dataset, query,
                                               timeout_s=timeout_s,
                                               trace=trace)
        except UnknownDataset as e:
            self._error(404, f"unknown dataset: {e}")
        except (SparqlError, QueryBuildError, PlanError) as e:
            self._error(400, str(e))
        except Overloaded as e:
            # admission control: tell clients when to come back
            log_event(log, "sparql", dataset=dataset, status="overloaded",
                      ms=round((time.perf_counter() - t0) * 1e3, 3))
            self._error(503, str(e),
                        headers={"Retry-After":
                                 str(max(1, round(e.retry_after_s)))},
                        retry_after_s=round(e.retry_after_s, 3))
        except DeadlineExceeded as e:
            extra = {}
            if e.queue_wait_ms is not None:
                extra["queue_wait_ms"] = round(e.queue_wait_ms, 3)
            if e.exec_ms is not None:
                extra["exec_ms"] = round(e.exec_ms, 3)
            log_event(log, "sparql", dataset=dataset, status="timeout",
                      ms=round((time.perf_counter() - t0) * 1e3, 3), **extra)
            self._error(504, str(e), **extra)
        except QueryCancelled as e:
            # distinct from 500: the engine stopped *cooperatively* at a
            # chunk boundary; surface how far it got before the deadline
            extra = {}
            if e.queue_wait_ms is not None:
                extra["queue_wait_ms"] = round(e.queue_wait_ms, 3)
            if e.exec_ms is not None:
                extra["exec_ms"] = round(e.exec_ms, 3)
            if e.partial_stats:
                parts = [part
                         for br in (e.partial_stats.get("exec") or {})
                         .get("branches", ())
                         for part in [br.get("base") or {}]]
                extra["partial"] = {
                    "branches": len(parts),
                    "chunks": sum(p.get("chunks", 0) for p in parts),
                    "wall_ms": round(sum(p.get("wall_ms", 0.0)
                                         for p in parts), 3),
                }
            log_event(log, "sparql", dataset=dataset, status="cancelled",
                      ms=round((time.perf_counter() - t0) * 1e3, 3))
            self._error(504, f"cancelled: {e}", **extra)
        except (SchedulerShutdown, SchedulerStopped) as e:
            self._error(503, str(e),
                        headers={"Retry-After": "1"})
        except SchedulerError as e:
            self._error(500, str(e))
        except Exception as e:  # noqa: BLE001 — never kill the handler thread
            log.exception("internal error serving query")
            self._error(500, f"internal error: {e}")
        else:
            qid = res.stats.get("query_id")
            log_event(log, "sparql", query_id=qid, dataset=dataset,
                      status="ok", count=res.count,
                      ms=round((time.perf_counter() - t0) * 1e3, 3))
            out = _bindings_json(registry, dataset, res, limit)
            if qid:
                out["query_id"] = qid
            if trace and res.stats.get("trace") is not None:
                out["trace"] = res.stats["trace"]
            self._send_json(200, out,
                            headers={"X-Repro-Query-Id": qid} if qid
                            else None)


class SparqlHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to a registry + scheduler."""

    daemon_threads = True
    # the listen backlog: a burst of clients connects at once (the stdlib's
    # default of 5 drops the others' first SYN for a second)
    request_queue_size = 128

    def __init__(self, address: tuple[str, int], registry: DatasetRegistry,
                 scheduler: Scheduler):
        super().__init__(address, _Handler)
        self.registry = registry
        self.scheduler = scheduler
        self.metrics = scheduler.metrics
        # at most this many profiled explain=analyze executions at once
        self.analyze_gate = threading.BoundedSemaphore(2)


def make_server(registry: DatasetRegistry, host: str = "127.0.0.1",
                port: int = 0, *, workers: int = 4, max_queue: int = 64,
                default_timeout_s: float = 30.0,
                scheduler: Scheduler | None = None) -> SparqlHTTPServer:
    """Build (and start the scheduler of) a ready-to-serve HTTP server.
    ``port=0`` binds an ephemeral port (see ``server.server_address``)."""
    if scheduler is None:
        scheduler = Scheduler(registry, workers=workers, max_queue=max_queue,
                              default_timeout_s=default_timeout_s,
                              metrics=registry.metrics)
    scheduler.start()
    server = SparqlHTTPServer((host, port), registry, scheduler)
    log.info("sparql service on http://%s:%d/sparql (datasets: %s)",
             *server.server_address[:2], ",".join(registry.names()) or "-")
    return server


def serve_in_thread(server: SparqlHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="sparql-http")
    t.start()
    return t
