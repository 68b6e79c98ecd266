"""repro_torch.obs — tracing, the slow-query log and workload intelligence.

``Trace`` collects a tree of spans for one request — parse → fingerprint →
plan → compile (a chunk program's build) → per-chunk dispatch →
device wait → per-step kernel — cheaply enough to stay in the serving hot
path (off by default, sampled or forced per request).  ``SlowQueryLog``
keeps the N worst traces per dataset for the ``/debug/slow`` endpoint;
``chrome_trace`` renders a trace as Chrome's ``trace_event`` JSON.

:mod:`repro_torch.obs.workload` aggregates *across* queries: per-plan-shape
``WorkloadProfile`` q-error accounting, a ``DecisionJournal`` of engine
choices, and the observed-fanout feedback loop into the planner; the
offline ``python -m repro_torch.obs.report`` CLI merges profiles and
slow-log entries into one report.  Stdlib copies of ``repro.obs``.
"""

from repro_torch.obs.slowlog import SlowQueryLog
from repro_torch.obs.trace import Span, Trace, chrome_trace
from repro_torch.obs.workload import (DecisionJournal, WorkloadProfile,
                                      WorkloadProfiler, qerror, qerror_log10)

__all__ = ["Span", "Trace", "SlowQueryLog", "chrome_trace",
           "WorkloadProfile", "WorkloadProfiler", "DecisionJournal",
           "qerror", "qerror_log10"]
