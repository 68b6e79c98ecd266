"""RDF query serving CLI — a thin layer over :mod:`repro_torch.serve`.

Workload mode (default) builds the requested dataset(s), hosts them in a
:class:`~repro_torch.serve.server.DatasetRegistry`, and drives the query mix
through the concurrent :class:`~repro_torch.serve.scheduler.Scheduler` with N
closed-loop client threads, printing per-query cold/warm latency, cache
hit-rates, and service percentiles:

    python -m repro_torch.launch.serve --dataset lubm --scale 1 --clients 4

HTTP mode exposes the same registry over ``GET/POST /sparql`` (+
``/healthz``, ``/metrics``) and blocks until interrupted:

    python -m repro_torch.launch.serve --dataset lubm,bsbm --http --port 8080

The engines run on ``--device`` (default ``cuda``, which fails without
CUDA; ``--device cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core import ExecOpts, SparqlEngine
from repro_torch.rdf.generator import generate_bsbm, generate_hetero, generate_lubm
from repro_torch.rdf.transform import type_aware_transform
from repro_torch.rdf.workloads import BSBM_QUERIES, HETERO_QUERIES, LUBM_QUERIES
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.server import DatasetRegistry, make_server
from repro_torch.utils import get_logger

log = get_logger("launch.serve")

WORKLOADS = {"lubm": LUBM_QUERIES, "hetero": HETERO_QUERIES,
             "bsbm": BSBM_QUERIES}


class QueryService:
    """Compiled-plan-cached engine wrapper with latency accounting.

    Kept as the minimal single-dataset embedding of the serving stack (the
    full registry/scheduler/HTTP path lives in :mod:`repro_torch.serve`)."""

    def __init__(self, graph, maps, opts: ExecOpts | None = None,
                 device="cuda"):
        self.engine = SparqlEngine(graph, maps, opts or ExecOpts(),
                                   device=device)
        self.latencies_ms: list[float] = []

    def execute(self, sparql: str):
        t0 = time.perf_counter()
        res = self.engine.query(sparql)
        dt = (time.perf_counter() - t0) * 1e3
        self.latencies_ms.append(dt)
        return res, dt

    def stats(self) -> dict:
        arr = np.asarray(self.latencies_ms)
        if arr.size == 0:
            return {}
        return {"n": int(arr.size), "mean_ms": float(arr.mean()),
                "p50_ms": float(np.percentile(arr, 50)),
                "p95_ms": float(np.percentile(arr, 95)),
                "p99_ms": float(np.percentile(arr, 99)),
                "max_ms": float(arr.max()),
                "plan_cache": self.engine.plan_cache.snapshot()}


def build_dataset(name: str, scale: int, density: float):
    if name == "lubm":
        st = generate_lubm(scale=scale, density=density)
    elif name == "hetero":
        st = generate_hetero(n_entities=scale * 10000)
    elif name == "bsbm":
        st = generate_bsbm(n_products=scale * 500)
    else:
        raise SystemExit(f"unknown dataset {name}")
    st.finalize()
    g, maps = type_aware_transform(st)
    return g, maps, WORKLOADS[name]


def _build_registry(args) -> tuple[DatasetRegistry, dict[str, dict[str, str]]]:
    metrics = ServeMetrics()
    registry = DatasetRegistry(metrics,
                               result_cache_size=args.result_cache_size,
                               slow_log_size=args.slow_log,
                               trace_sample=args.trace_sample,
                               feedback=not getattr(args, "no_feedback",
                                                    False),
                               qerror_threshold=getattr(
                                   args, "feedback_threshold", 8.0),
                               feedback_min_runs=getattr(
                                   args, "feedback_min_runs", 5),
                               journal_size=getattr(args, "journal_size",
                                                    512),
                               device=args.device)
    workloads: dict[str, dict[str, str]] = {}
    for name in args.dataset.split(","):
        name = name.strip()
        t0 = time.time()
        g, maps, queries = build_dataset(name, args.scale, args.density)
        registry.register(name, g, maps,
                          updatable=getattr(args, "updatable", False))
        workloads[name] = queries
        log.info("dataset %s built: %s in %.1fs", name, g.stats(),
                 time.time() - t0)
    return registry, workloads


def _run_workload(args, registry: DatasetRegistry,
                  workloads: dict[str, dict[str, str]]) -> dict:
    if args.queries:
        known = {n for queries in workloads.values() for n in queries}
        unknown = [n for n in args.queries.split(",") if n not in known]
        if unknown:
            raise SystemExit(f"unknown queries {unknown}; known: "
                             f"{sorted(known)}")
    scheduler = Scheduler(registry, workers=args.workers,
                          max_queue=args.max_queue,
                          default_timeout_s=args.timeout_s,
                          metrics=registry.metrics).start()
    results: dict[str, dict] = {}
    try:
        with ThreadPoolExecutor(max_workers=args.clients) as pool:
            for r in range(args.repeat):
                futs = {}
                for ds, queries in workloads.items():
                    names = (args.queries.split(",") if args.queries
                             else sorted(queries))
                    for name in (n for n in names if n in queries):
                        key = f"{ds}.{name}"
                        futs[key] = pool.submit(
                            _timed_submit, scheduler, ds, queries[name])
                for key, fut in futs.items():
                    res, dt = fut.result()
                    rec = results.setdefault(
                        key, {"count": res.count, "first_ms": dt,
                              "warm_ms": []})
                    if r > 0:
                        rec["warm_ms"].append(dt)
    finally:
        scheduler.stop()

    for key, rec in sorted(results.items()):
        warm = rec.pop("warm_ms")
        # all warm rounds count — a single surviving round under-reports
        rec["warm_mean_ms"] = float(np.mean(warm)) if warm else float("nan")
        rec["warm_min_ms"] = float(np.min(warm)) if warm else float("nan")
        print(f"{key:14s} count={rec['count']:8d} "
              f"cold={rec['first_ms']:9.2f}ms "
              f"warm_mean={rec['warm_mean_ms']:9.2f}ms "
              f"warm_min={rec['warm_min_ms']:9.2f}ms")

    summary = {"service": registry.metrics.summary(),
               "scheduler": {"coalesced": registry.metrics.coalesced.total()},
               "datasets": registry.stats()}
    for ds, st in summary["datasets"].items():
        pc, rc = st["plan_cache"], st["result_cache"]
        print(f"{ds}: plan-cache hit-rate={pc['hit_rate']:.2%} "
              f"({pc['hits']}/{pc['hits'] + pc['misses']}), "
              f"result-cache hit-rate={rc['hit_rate']:.2%}" +
              ("" if rc["capacity"] else " (disabled)"))
    svc = summary["service"]
    print(f"service: qps={svc['qps']:.1f} p50={svc['p50_ms']:.2f}ms "
          f"p95={svc['p95_ms']:.2f}ms p99={svc['p99_ms']:.2f}ms "
          f"coalesced={summary['scheduler']['coalesced']:.0f}")
    wl = registry.workload_snapshot(limit=5)
    replans = sum(v for ds in wl["feedback"].values() for v in ds.values())
    print(f"workload: {len(registry.workload)} profiles, "
          f"decisions={sum(wl['decisions'].values()):.0f} "
          f"{dict(wl['decisions'])}, feedback_replans={replans}")
    for prof in wl["profiles"]:
        if prof["q_error_median"] > 2.0:
            print(f"  misestimated {prof['dataset']}/"
                  f"{prof['plan_key'][:16]}: q-error median="
                  f"{prof['q_error_median']:.1f} over {prof['runs']} runs"
                  + (f" (replanned x{prof['replans']})"
                     if prof["replans"] else ""))
    summary["workload"] = wl
    if args.json:
        print(json.dumps({"queries": results, **summary}, indent=None))
    return results


def _timed_submit(scheduler: Scheduler, dataset: str, sparql: str):
    t0 = time.perf_counter()
    res = scheduler.submit(dataset, sparql)
    return res, (time.perf_counter() - t0) * 1e3


def _run_http(args, registry: DatasetRegistry) -> None:
    server = make_server(registry, host=args.host, port=args.port,
                         workers=args.workers, max_queue=args.max_queue,
                         default_timeout_s=args.timeout_s)
    host, port = server.server_address[:2]
    print(f"serving http://{host}:{port}/sparql "
          f"(datasets: {','.join(registry.names())}; "
          f"also /healthz, /metrics) — Ctrl-C to stop", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.scheduler.stop()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="lubm",
                    help="comma list of lubm/hetero/bsbm (all hosted at once)")
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--density", type=float, default=0.6)
    ap.add_argument("--queries", default=None, help="comma list of names")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--clients", type=int, default=4,
                    help="closed-loop client threads (workload mode)")
    ap.add_argument("--workers", type=int, default=4,
                    help="scheduler worker threads")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission control: max queued flights")
    ap.add_argument("--timeout-s", type=float, default=60.0,
                    help="per-request deadline")
    ap.add_argument("--result-cache-size", type=int, default=0,
                    help="entries per dataset (0 disables result caching)")
    ap.add_argument("--trace-sample", type=float, default=0.0,
                    help="fraction of requests traced on the fast path to "
                         "feed /debug/slow and span histograms (0 disables)")
    ap.add_argument("--slow-log", type=int, default=32,
                    help="worst traced executions kept per dataset "
                         "(0 disables the slow-query log)")
    obs = ap.add_argument_group(
        "workload intelligence", "q-error accounting, decision journal, "
        "observed-cardinality feedback (see README 'Observability')")
    obs.add_argument("--no-feedback", action="store_true",
                     help="disable observed-cardinality feedback into the "
                          "planner (profiles and the journal stay on)")
    obs.add_argument("--feedback-threshold", type=float, default=8.0,
                     help="median worst-step q-error above which a cached "
                          "plan is marked stale for re-planning")
    obs.add_argument("--feedback-min-runs", type=int, default=5,
                     help="runs a shape must accumulate before feedback "
                          "can trigger")
    obs.add_argument("--journal-size", type=int, default=512,
                     help="decision-journal ring buffer entries")
    obs.add_argument("--log-json", action="store_true",
                     help="one-JSON-object-per-line logs (same as "
                          "REPRO_LOG_FORMAT=json)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--http", action="store_true",
                    help="serve HTTP instead of running the workload")
    ap.add_argument("--updatable", action="store_true",
                    help="host datasets behind a VersionedStore so POST "
                         "/update (SPARQL INSERT DATA / DELETE DATA) works")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="torch device of every hosted engine (cuda fails "
                         "without CUDA; cpu runs the plain kernels)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    res = ap.add_argument_group(
        "resilience", "fault injection + degraded-mode execution knobs "
        "(see README 'Resilience')")
    res.add_argument("--fault-spec", default=None, metavar="SPEC",
                     help="deterministic fault injection, e.g. "
                          "'dispatch:oom:0.05;compile:latency:0.1:20' — "
                          "site:kind[:rate[:latency_ms]] entries joined "
                          "with ';' (sites: compile, dispatch, delta_merge, "
                          "store_commit; kinds: oom, compile_error, latency, "
                          "poison)")
    res.add_argument("--fault-seed", type=int, default=0,
                     help="seed for the per-spec fault RNG streams (same "
                          "seed + spec + request order => same faults)")
    res.add_argument("--retry-max", type=int, default=None,
                     help="transient-fault retries per degradation level "
                          "before escalating (default 2)")
    res.add_argument("--retry-backoff-ms", type=float, default=None,
                     help="base backoff between transient-fault retries, "
                          "doubled per attempt (default 5ms)")
    res.add_argument("--breaker-cooldown-s", type=float, default=None,
                     help="how long a plan stays at its degraded level "
                          "before re-probing one level lower (default 30s)")
    args = ap.parse_args(argv)

    if args.log_json:
        from repro_torch.utils import set_json_logging
        set_json_logging(True)

    # retry/breaker knobs travel via env so every engine the registry
    # builds (RetryPolicy.from_env) picks them up without plumbing
    import os

    if args.retry_max is not None:
        os.environ["REPRO_RETRY_MAX"] = str(args.retry_max)
    if args.retry_backoff_ms is not None:
        os.environ["REPRO_RETRY_BACKOFF_MS"] = str(args.retry_backoff_ms)
    if args.breaker_cooldown_s is not None:
        os.environ["REPRO_BREAKER_COOLDOWN_S"] = str(args.breaker_cooldown_s)
    if args.fault_spec:
        from repro_torch.resilience import faults
        faults.install(faults.FaultInjector(
            faults.parse_fault_spec(args.fault_spec), seed=args.fault_seed))
        log.warning("fault injection active: %s (seed=%d)",
                    args.fault_spec, args.fault_seed)

    for ds in args.dataset.split(","):
        if ds.strip() not in WORKLOADS:
            raise SystemExit(f"unknown dataset {ds.strip()}")
    registry, workloads = _build_registry(args)
    if args.http:
        _run_http(args, registry)
    else:
        _run_workload(args, registry, workloads)


if __name__ == "__main__":
    main()
