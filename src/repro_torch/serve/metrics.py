"""Serving metrics: counters, gauges, latency histograms, and a
Prometheus-style text exposition for the ``/metrics`` endpoint.

Stdlib-only and thread-safe.  Histograms keep fixed cumulative buckets for
exposition plus a bounded reservoir of recent samples so the CLI can print
exact p50/p95/p99 over the recent window.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items()) or [((), 0.0)]
        for key, val in items:
            lines.append(f"{self.name}{_fmt_labels(dict(key))} {val:g}")
        return lines


class Gauge:
    def __init__(self, name: str, help: str = "", fn=None):
        self.name, self.help = name, help
        self._value = 0.0
        self._fn = fn  # optional callable sampled at render time
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value

    def render(self) -> list[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} gauge",
                f"{self.name} {self.value():g}"]


DEFAULT_BUCKETS_MS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                      1000, 2500, 5000, 10000, math.inf)

# Log-spaced 1µs .. 10s ladder (seconds) for trace-span histograms: spans
# range from sub-ms cache probes to multi-second first-dispatch compiles,
# so the default ms ladder would dump everything in its two edge buckets.
FINE_BUCKETS_S = tuple(m * 10.0 ** e
                       for e in range(-6, 1) for m in (1, 2.5, 5)) + \
                 (10.0, math.inf)


class Histogram:
    """Latency histogram in milliseconds."""

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_BUCKETS_MS, reservoir: int = 8192):
        self.name, self.help = name, help
        self.buckets = tuple(buckets)
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0
        self._recent: deque[float] = deque(maxlen=reservoir)
        self._lock = threading.Lock()

    def observe(self, ms: float) -> None:
        with self._lock:
            self._sum += ms
            self._count += 1
            self._recent.append(ms)
            for i, b in enumerate(self.buckets):
                if ms <= b:
                    self._counts[i] += 1
                    break

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, p: float) -> float:
        """Exact percentile over the recent-sample reservoir."""
        with self._lock:
            data = sorted(self._recent)
        if not data:
            return float("nan")
        idx = min(len(data) - 1, max(0, int(round(p / 100.0 * (len(data) - 1)))))
        return data[idx]

    def summary(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
        return {"count": count,
                "mean_ms": (total / count) if count else float("nan"),
                "p50_ms": self.percentile(50),
                "p95_ms": self.percentile(95),
                "p99_ms": self.percentile(99)}

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            counts, total, count = list(self._counts), self._sum, self._count
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            le = "+Inf" if math.isinf(b) else f"{b:g}"
            lines.append(f'{self.name}_bucket{{le="{le}"}} {cum}')
        lines.append(f"{self.name}_sum {total:g}")
        lines.append(f"{self.name}_count {count}")
        return lines


class LabeledHistogram:
    """A family of histograms sharing one metric name, split by a single
    label (e.g. ``repro_span_seconds{span="compile"}``).  Children are
    created on first observation; unit is whatever the bucket ladder is in
    (`FINE_BUCKETS_S` = seconds)."""

    def __init__(self, name: str, help: str = "", label: str = "label",
                 buckets=DEFAULT_BUCKETS_MS, reservoir: int = 1024):
        self.name, self.help, self.label = name, help, label
        self.buckets = tuple(buckets)
        self._reservoir = reservoir
        self._children: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def child(self, value: str) -> Histogram:
        with self._lock:
            h = self._children.get(value)
            if h is None:
                h = Histogram(self.name, buckets=self.buckets,
                              reservoir=self._reservoir)
                self._children[value] = h
            return h

    def observe(self, value: str, x: float) -> None:
        self.child(value).observe(x)

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            children = sorted(self._children.items())
        for lv, h in children:
            with h._lock:
                counts, total, count = list(h._counts), h._sum, h._count
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                le = "+Inf" if math.isinf(b) else f"{b:g}"
                lines.append(f'{self.name}_bucket{{{self.label}="{lv}",'
                             f'le="{le}"}} {cum}')
            lines.append(f'{self.name}_sum{{{self.label}="{lv}"}} {total:g}')
            lines.append(f'{self.name}_count{{{self.label}="{lv}"}} {count}')
        return lines


class LabeledGauge:
    """A gauge family split by a single label (e.g. per-dataset in-flight
    query counts)."""

    def __init__(self, name: str, help: str = "", label: str = "label"):
        self.name, self.help, self.label = name, help, label
        self._values: dict[str, float] = {}
        self._lock = threading.Lock()

    def set(self, value: str, v: float) -> None:
        with self._lock:
            self._values[value] = float(v)

    def inc(self, value: str, n: float = 1.0) -> None:
        with self._lock:
            self._values[value] = self._values.get(value, 0.0) + n

    def dec(self, value: str, n: float = 1.0) -> None:
        self.inc(value, -n)

    def value(self, value: str) -> float:
        with self._lock:
            return self._values.get(value, 0.0)

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._values.items())
        for lv, v in items:
            lines.append(f'{self.name}{{{self.label}="{lv}"}} {v:g}')
        return lines


class MetricsRegistry:
    """Holds metrics and renders the Prometheus text exposition."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _register(self, metric):
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
        return m if m is not None else self._register(Counter(name, help))

    def gauge(self, name: str, help: str = "", fn=None) -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
        return m if m is not None else self._register(Gauge(name, help, fn))

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
        return m if m is not None else self._register(Histogram(name, help, **kw))

    def labeled_histogram(self, name: str, help: str = "",
                          **kw) -> LabeledHistogram:
        with self._lock:
            m = self._metrics.get(name)
        return m if m is not None else self._register(
            LabeledHistogram(name, help, **kw))

    def labeled_gauge(self, name: str, help: str = "",
                      label: str = "label") -> LabeledGauge:
        with self._lock:
            m = self._metrics.get(name)
        return m if m is not None else self._register(
            LabeledGauge(name, help, label))

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


class ServeMetrics:
    """The serving subsystem's metric bundle (QPS window, latency, caches)."""

    QPS_WINDOW_S = 60.0

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.requests = r.counter(
            "repro_requests_total", "SPARQL requests by dataset and status")
        self.coalesced = r.counter(
            "repro_coalesced_total",
            "requests served by attaching to an identical in-flight query")
        self.latency = r.histogram(
            "repro_request_latency_ms", "end-to-end request latency (ms)")
        self.inflight = r.gauge(
            "repro_inflight_requests", "requests admitted and not yet done")
        self.queue_depth = r.gauge(
            "repro_queue_depth", "flights waiting for a worker")
        self.qps = r.gauge("repro_qps",
                           f"completions / s over the last "
                           f"{int(self.QPS_WINDOW_S)}s", fn=self._qps)
        self.plan_search = r.histogram(
            "repro_plan_search_ms",
            "planner order-search + compile time per fresh plan (ms)")
        self.card_error = r.histogram(
            "repro_cardinality_error_log10",
            "abs log10 ratio of planner-estimated to actual result rows",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 3.0, math.inf))
        self.step_card_error = r.histogram(
            "repro_step_cardinality_error_log10",
            "abs log10 ratio of per-step estimated to actual binding-table "
            "rows (feeds the executor capacity schedule)",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 3.0, math.inf))
        self.qerror = r.labeled_histogram(
            "repro_qerror_log10",
            "log10 q-error (max(est/actual, actual/est), +1-smoothed) of "
            "cardinality estimates, by scope: whole-query vs per-step",
            label="scope", buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 3.0, math.inf),
            reservoir=1024)
        self.feedback_replans = r.counter(
            "repro_feedback_replans_total",
            "cached plans marked stale by workload q-error feedback "
            "(next compile re-runs order search with observed fanouts)")
        self.decisions = r.counter(
            "repro_decisions_total",
            "decision-journal entries recorded, by decision kind")
        self.exec_retries = r.counter(
            "repro_exec_step_retries_total",
            "executor capacity overflows (suffix-resume re-entries)")
        self.prune_candidates_in = r.counter(
            "repro_prune_candidates_in_total",
            "expansion candidates entering neighborhood-signature probes")
        self.prune_candidates_out = r.counter(
            "repro_prune_candidates_out_total",
            "expansion candidates surviving neighborhood-signature probes")
        self.updates = r.counter(
            "repro_updates_total", "SPARQL UPDATE requests by dataset/status")
        self.update_triples = r.counter(
            "repro_update_triples_total",
            "triples applied via SPARQL UPDATE, by dataset and op")
        self.update_latency = r.histogram(
            "repro_update_latency_ms",
            "end-to-end /update latency incl. snapshot + cache invalidation")
        self.compactions = r.counter(
            "repro_store_compactions_total",
            "live-store delta compactions (base graph rebuilds)")
        self.span_seconds = r.labeled_histogram(
            "repro_span_seconds",
            "top-level trace span duration in seconds, by span name",
            label="span", buckets=FINE_BUCKETS_S, reservoir=1024)
        self.compile_events = r.counter(
            "repro_compile_events_total",
            "fresh chunk-program builds observed on the query path")
        self.traces = r.counter(
            "repro_traces_total", "traces recorded, by mode (forced/sampled)")
        self.slow_queries = r.counter(
            "repro_slow_log_inserts_total",
            "executions admitted to a dataset's slow-query log")
        self.dataset_inflight = r.labeled_gauge(
            "repro_dataset_inflight_queries",
            "queries submitted and not yet completed, per dataset",
            label="dataset")
        self.batch_size = r.histogram(
            "repro_batch_size",
            "queries answered per batched device dispatch (1 = unbatched)",
            buckets=(1, 2, 4, 8, 16, 32, 64, math.inf))
        self.coalesced_queries = r.counter(
            "repro_coalesced_queries_total",
            "queries answered via same-shape batched dispatch (lanes of "
            "batches with size >= 2)")
        self.cancelled = r.counter(
            "repro_cancelled_total",
            "executions stopped cooperatively (deadline expiry, waiter "
            "abandonment, or shutdown) after starting on the device")
        self.degraded = r.counter(
            "repro_degraded_dispatch_total",
            "query executions that completed at a degraded ladder level "
            "after transient faults (OOM/compile failure)")
        self._completions: deque[float] = deque(maxlen=65536)
        self._started = time.monotonic()
        self._lock = threading.Lock()

    def record(self, dataset: str, status: str, ms: float) -> None:
        self.requests.inc(dataset=dataset, status=status)
        self.latency.observe(ms)
        with self._lock:
            self._completions.append(time.monotonic())

    def record_plan_search(self, ms: float) -> None:
        """Planner wall time for a freshly compiled (cache-miss) query."""
        self.plan_search.observe(ms)

    def bind_queue_depth(self, fn) -> None:
        """Make the queue-depth gauge sample ``fn()`` at render time (the
        scheduler binds its live queue size here at start())."""
        self.queue_depth._fn = fn

    def record_trace(self, trace) -> None:
        """Fold one finished trace into the span histograms: every span in
        the tree lands in ``repro_span_seconds{span=...}``.  (Compile
        events are counted from ``Result.stats`` on *every* execution, not
        here, so traced runs are not double-counted.)"""
        self.traces.inc(mode="forced" if trace.profile_steps else "sampled")

        def walk(span):
            self.span_seconds.observe(span.name, span.dur)
            for c in span.children:
                walk(c)

        for child in trace.root.children:
            walk(child)

    def record_cardinality(self, estimated: float, actual: int) -> None:
        """Estimate-vs-actual error as |log10((est+1)/(actual+1))| — 0 is a
        perfect estimate, 1 is an order of magnitude off either way.  The
        same value is log10 of the (+1-smoothed) q-error, so it also lands
        in ``repro_qerror_log10{scope="query"}``."""
        err = abs(math.log10((max(0.0, estimated) + 1.0) / (actual + 1.0)))
        self.card_error.observe(err)
        self.qerror.observe("query", err)

    def record_step_cardinality(self, estimated: float, actual: int) -> None:
        """Per-plan-step estimate-vs-actual row error (same log10 scale).
        Large values here mean the executor's capacity schedule starts from
        bad guesses and leans on suffix-resume doublings."""
        err = abs(math.log10((max(0.0, estimated) + 1.0) / (actual + 1.0)))
        self.step_card_error.observe(err)
        self.qerror.observe("step", err)

    def _qps(self) -> float:
        now = time.monotonic()
        with self._lock:
            n = sum(1 for t in self._completions
                    if now - t <= self.QPS_WINDOW_S)
        window = min(self.QPS_WINDOW_S, max(now - self._started, 1e-9))
        return n / window

    def attach_cache_gauges(self, dataset: str, plan_cache, result_cache) -> None:
        """Expose a dataset's cache counters as render-time gauges."""
        r = self.registry
        for kind, cache in (("plan", plan_cache), ("result", result_cache)):
            if cache is None:
                continue
            for stat in ("hits", "misses", "evictions"):
                r.gauge(f"repro_{kind}_cache_{stat}_{dataset}",
                        f"{kind} cache {stat} for dataset {dataset}",
                        fn=lambda c=cache, s=stat: getattr(c.stats, s))
            r.gauge(f"repro_{kind}_cache_hit_ratio_{dataset}",
                    f"{kind} cache hit ratio for dataset {dataset}",
                    fn=lambda c=cache: c.stats.hit_rate)

    def attach_param_family_gauge(self, dataset: str, engine) -> None:
        """Expose an engine's parameterized-family plan-cache hit ratio
        (hits = queries answered by an already-compiled shape plan) as
        render-time gauges, like :meth:`attach_cache_gauges`."""
        r = self.registry
        for stat in ("hits", "misses"):
            r.gauge(f"repro_param_family_{stat}_{dataset}",
                    f"param-family plan-cache {stat} for dataset {dataset}",
                    fn=lambda e=engine, s=stat: getattr(e.param_stats, s))
        r.gauge(f"repro_param_family_hit_ratio_{dataset}",
                f"param-family plan-cache hit ratio for dataset {dataset}",
                fn=lambda e=engine: e.param_stats.hit_rate)

    def attach_breaker_gauges(self, dataset: str, engine) -> None:
        """Expose an engine executor's degradation-breaker state (plans
        currently pinned to a degraded ladder level) as render-time gauges,
        like :meth:`attach_cache_gauges`."""
        r = self.registry

        def snap(e=engine):
            try:
                return e.executor.resilience_snapshot()
            except Exception:  # noqa: BLE001 — gauges must never raise
                return {}

        r.gauge(f"repro_degraded_plans_{dataset}",
                f"plans running at a degraded ladder level for {dataset}",
                fn=lambda: snap().get("degraded_plans", 0))
        r.gauge(f"repro_degraded_max_level_{dataset}",
                f"highest active degradation ladder level for {dataset}",
                fn=lambda: snap().get("max_level", 0))

    def summary(self) -> dict:
        out = {"requests": self.requests.total(),
               "coalesced": self.coalesced.total(),
               "qps": round(self._qps(), 2),
               **self.latency.summary()}
        if self.cancelled.total():
            out["cancelled"] = self.cancelled.total()
        if self.degraded.total():
            out["degraded"] = self.degraded.total()
        if self.plan_search.count:
            out["plan_search_p50_ms"] = self.plan_search.percentile(50)
        if self.card_error.count:
            out["card_error_p50_log10"] = self.card_error.percentile(50)
        return out
