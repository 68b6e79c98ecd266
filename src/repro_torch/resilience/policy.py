"""Transient-fault policy: retry, degradation ladder, breaker.

The executor wraps each top-level ``run`` in this policy.  A transient
fault (RESOURCE_EXHAUSTED / injected OOM / compile failure) is retried
a bounded number of times with exponential backoff at the current
degradation level; when retries are exhausted the run escalates one
ladder level and starts over from host inputs (runs are pure with
respect to their numpy inputs, so a re-run is safe):

- level 0: normal config
- level 1: halved chunk + halved capacity schedule (cap_slack * 0.5,
  init_cap / 2) + synchronous dispatch (async_chunks=1)
- level 2: level 1 + fused kernel disabled
- level 3: legacy executor (no capacity schedule, no suffix resume)

A per-plan-signature :class:`DegradationBreaker` remembers the level
that last worked so subsequent runs of the same plan skip the failing
configs, and re-probes one level lower after a cooldown -- the same
probe-and-remember shape as the executor's ``_small_plan`` machinery.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, replace
from time import monotonic

from repro_torch.resilience.faults import InjectedFault

MAX_LEVEL = 3

_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "resource_exhausted", "out of memory", "OOM")


def is_transient_fault(exc: BaseException) -> bool:
    """True for faults worth retrying/degrading over (OOM-shaped)."""
    if isinstance(exc, InjectedFault):
        return exc.kind in ("oom", "compile_error")
    if isinstance(exc, MemoryError):
        return True
    text = str(exc)
    return any(m in text for m in _TRANSIENT_MARKERS)


def degrade_opts(opts, level: int):
    """Return a degraded copy of an ``ExecOpts`` for a ladder level.

    Works on any dataclass with the executor's option fields; imports
    nothing from ``repro_torch.core`` to stay cycle-free.
    """
    if level <= 0:
        return opts
    if level >= MAX_LEVEL:
        return replace(
            opts,
            cap_schedule=False,
            suffix_resume=False,
            async_chunks=1,
            use_fused=False,
            chunk=max(512, opts.chunk // 2),
        )
    out = replace(
        opts,
        chunk=max(512, opts.chunk // 2),
        init_cap=max(1024, opts.init_cap // 2),
        cap_slack=opts.cap_slack * 0.5,
        async_chunks=1,
    )
    if level >= 2:
        out = replace(out, use_fused=False)
    return out


@dataclass(frozen=True)
class RetryPolicy:
    max_retries: int = 2  # same-level retries before escalating
    backoff_s: float = 0.005
    backoff_max_s: float = 0.25
    cooldown_s: float = 30.0  # breaker re-probe cooldown

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(
            max_retries=int(os.environ.get("REPRO_RETRY_MAX", "2")),
            backoff_s=float(os.environ.get("REPRO_RETRY_BACKOFF_MS", "5")) / 1e3,
            cooldown_s=float(os.environ.get("REPRO_BREAKER_COOLDOWN_S", "30")),
        )

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_s * (2**attempt), self.backoff_max_s)


class DegradationBreaker:
    """Per-plan-signature memory of the working degradation level."""

    def __init__(self, cooldown_s: float = 30.0) -> None:
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        # sig -> (level, probe_at): run at `level`; once monotonic() >=
        # probe_at, optimistically probe one level lower.
        self._state: dict[object, tuple[int, float]] = {}

    def level(self, sig, now: float | None = None) -> int:
        now = monotonic() if now is None else now
        with self._lock:
            ent = self._state.get(sig)
            if ent is None:
                return 0
            lvl, probe_at = ent
            if now >= probe_at:
                return max(0, lvl - 1)
            return lvl

    def record_failure(self, sig, level: int, now: float | None = None) -> int:
        """Escalate past a failed level; returns the next level to try."""
        now = monotonic() if now is None else now
        nxt = min(level + 1, MAX_LEVEL)
        with self._lock:
            self._state[sig] = (nxt, now + self.cooldown_s)
        return nxt

    def record_success(self, sig, level: int, now: float | None = None) -> None:
        now = monotonic() if now is None else now
        with self._lock:
            if level <= 0:
                self._state.pop(sig, None)
            else:
                self._state[sig] = (level, now + self.cooldown_s)

    def snapshot(self) -> dict:
        with self._lock:
            levels = [lvl for lvl, _ in self._state.values()]
            return {
                "degraded_plans": len(levels),
                "max_level": max(levels, default=0),
                "levels": {str(lv): levels.count(lv) for lv in sorted(set(levels))},
            }
