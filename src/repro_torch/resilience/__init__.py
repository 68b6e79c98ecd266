"""Resilience primitives for the serve path.

Three pieces, designed to compose:

- :mod:`repro_torch.resilience.cancel` -- cooperative cancellation.  A
  :class:`CancelToken` carries an absolute ``time.monotonic()`` deadline
  from ``scheduler.submit`` / ``?timeout_ms`` down into the executor's
  chunk loop; :class:`QueryCancelled` surfaces with partial stats.
- :mod:`repro_torch.resilience.policy` -- transient-fault retry with bounded
  exponential backoff, a degradation ladder (smaller capacity schedule
  -> no fused kernel -> legacy executor), and a per-plan-signature
  breaker that remembers the working degraded config and re-probes a
  less-degraded level after a cooldown.
- :mod:`repro_torch.resilience.faults` -- deterministic, seeded fault
  injection at named sites (compile, dispatch, delta_merge,
  store_commit) so chaos tests are reproducible.
"""

from repro_torch.resilience.cancel import CancelToken, QueryCancelled
from repro_torch.resilience.faults import FaultInjector, FaultSpec, InjectedFault, parse_fault_spec
from repro_torch.resilience.policy import (
    MAX_LEVEL,
    DegradationBreaker,
    RetryPolicy,
    degrade_opts,
    is_transient_fault,
)

__all__ = [
    "CancelToken",
    "QueryCancelled",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "parse_fault_spec",
    "RetryPolicy",
    "DegradationBreaker",
    "degrade_opts",
    "is_transient_fault",
    "MAX_LEVEL",
]
