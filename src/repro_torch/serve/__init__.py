"""repro_torch.serve — the concurrent SPARQL serving subsystem, the port
of ``repro.serve`` onto the torch engine.

Layers (bottom-up):

- :mod:`repro_torch.serve.fingerprint` — structural query canonicalization; the
  cache key that lets alpha-equivalent queries share one compiled plan;
- :mod:`repro_torch.serve.cache` — bounded LRU plan/result caches with stats;
- :mod:`repro_torch.serve.metrics` — counters/gauges/histograms + Prometheus text;
- :mod:`repro_torch.serve.scheduler` — admission control, deadlines, and
  coalescing of identical in-flight queries over a worker pool;
- :mod:`repro_torch.serve.server` — multi-dataset registry + stdlib
  ``ThreadingHTTPServer`` (``/sparql``, ``/healthz``, ``/metrics``).

Submodules are imported lazily so the low-level pieces (``cache``,
``fingerprint``) stay importable from ``repro_torch.core`` without pulling the
HTTP stack (which itself imports ``repro_torch.core``) into a cycle.
"""

from __future__ import annotations

_EXPORTS = {
    "CanonicalQuery": "repro_torch.serve.fingerprint",
    "canonicalize_query": "repro_torch.serve.fingerprint",
    "fingerprint_query": "repro_torch.serve.fingerprint",
    "serialize_query": "repro_torch.serve.fingerprint",
    "CacheStats": "repro_torch.serve.cache",
    "LRUCache": "repro_torch.serve.cache",
    "PlanCache": "repro_torch.serve.cache",
    "ResultCache": "repro_torch.serve.cache",
    "Counter": "repro_torch.serve.metrics",
    "Gauge": "repro_torch.serve.metrics",
    "Histogram": "repro_torch.serve.metrics",
    "LabeledGauge": "repro_torch.serve.metrics",
    "LabeledHistogram": "repro_torch.serve.metrics",
    "MetricsRegistry": "repro_torch.serve.metrics",
    "ServeMetrics": "repro_torch.serve.metrics",
    "DeadlineExceeded": "repro_torch.serve.scheduler",
    "Overloaded": "repro_torch.serve.scheduler",
    "Scheduler": "repro_torch.serve.scheduler",
    "SchedulerError": "repro_torch.serve.scheduler",
    "DatasetRegistry": "repro_torch.serve.server",
    "HostedDataset": "repro_torch.serve.server",
    "SparqlHTTPServer": "repro_torch.serve.server",
    "UnknownDataset": "repro_torch.serve.server",
    "UpdateNotSupported": "repro_torch.serve.server",
    "make_server": "repro_torch.serve.server",
    "serve_in_thread": "repro_torch.serve.server",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.serve' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__() -> list[str]:
    return __all__
