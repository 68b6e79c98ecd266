"""Workload intelligence: q-error accounting + decision journal.

Aggregates *across* queries what :mod:`repro_torch.obs.trace` records for one:
every completed execution folds its ``Result.stats`` into a bounded
per-``(dataset, plan_key)`` :class:`WorkloadProfile` — per-step
observed-vs-estimated cardinality accounting (q-error), kernel mix,
prune ratios, suffix-resume/retry counts, batch-lane fill, degradation
levels — while a :class:`DecisionJournal` ring buffer records each
engine choice (plan-cache hit/miss, small-plan probe, batch coalesce,
prune, breaker level, cancellation) with its inputs.

The profiler also closes the loop: when a profile's median worst-step
q-error exceeds ``qerror_threshold`` over the last ``min_runs`` runs,
:meth:`WorkloadProfiler.observe` returns a *replan hint* carrying the
observed per-edge fanouts, keyed ``(child, parent, elabel, forward)``
over stable query-vertex indices so they survive an order-search re-run
(the caller feeds them to ``SparqlEngine.apply_feedback``, which marks
the cached plan stale; see ``core/planner/cost.py``).  Feedback is
bounded (``max_replans`` per profile), versioned, and purely an
estimator override — results stay bit-identical as multisets.

Everything here is host-side bookkeeping on numbers the executor
already produces; nothing touches the device.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from collections import Counter, OrderedDict, deque

__all__ = [
    "qerror",
    "qerror_log10",
    "WorkloadProfile",
    "WorkloadProfiler",
    "DecisionJournal",
]

# observed fanouts are clamped into this range before they reach the
# cost model — a pathological run must not poison planning forever
_FANOUT_MIN = 1e-4
_FANOUT_MAX = 1e6


def qerror(estimated: float, actual: float) -> float:
    """Symmetric relative cardinality error, >= 1.0 (1.0 = exact).

    Both sides are +1-smoothed so empty results don't divide by zero;
    ``log10(qerror(e, a))`` equals the absolute log-ratio the
    ``repro_cardinality_error_log10`` metrics have always recorded.
    """
    e = max(0.0, float(estimated)) + 1.0
    a = max(0.0, float(actual)) + 1.0
    return max(e / a, a / e)


def qerror_log10(estimated: float, actual: float) -> float:
    return math.log10(qerror(estimated, actual))


def _median(vals) -> float:
    s = sorted(vals)
    if not s:
        return 0.0
    n = len(s)
    mid = n // 2
    return float(s[mid]) if n % 2 else float((s[mid - 1] + s[mid]) / 2.0)


class DecisionJournal:
    """Bounded ring buffer of engine decisions with their inputs.

    Entries are plain dicts ``{"seq", "t", "kind", ...fields}`` — newest
    first in :meth:`snapshot`.  ``record`` is cheap enough for the hot
    path (one deque append under a lock); readers get copies.
    """

    def __init__(self, size: int = 512):
        self._buf: deque[dict] = deque(maxlen=max(1, int(size)))
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self.counts: Counter[str] = Counter()

    def record(self, kind: str, **fields) -> None:
        entry = {"seq": next(self._seq), "t": time.time(), "kind": kind}
        entry.update(fields)
        with self._lock:
            self._buf.append(entry)
            self.counts[kind] += 1

    def snapshot(self, limit: int | None = None,
                 kind: str | None = None) -> list[dict]:
        with self._lock:
            entries = list(self._buf)
        entries.reverse()  # newest first
        if kind is not None:
            entries = [e for e in entries if e["kind"] == kind]
        if limit is not None:
            entries = entries[: max(0, int(limit))]
        return [dict(e) for e in entries]

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


class WorkloadProfile:
    """Aggregated execution statistics for one (dataset, plan_key).

    Per-step aggregates use ratio-of-sums (``sum_kept / sum_in``) so one
    tiny run cannot dominate the observed fanout, plus a bounded deque
    of recent per-run q-errors for the median-based replan trigger.
    Step-level state resets when the plan signature changes (a replan or
    live-store drift re-ordered the steps); run counters are cumulative.
    """

    def __init__(self, dataset: str, plan_key: str, window: int = 32):
        self.dataset = dataset
        self.plan_key = plan_key
        self.window = max(2, int(window))
        self.runs = 0
        self.wall_ms_total = 0.0
        self.last_wall_ms = 0.0
        self.rows_total = 0
        self.kernels: Counter[str] = Counter()
        self.degraded: Counter[int] = Counter()
        self.resumes = 0
        self.compiles = 0
        self.retries = 0
        self.batched_runs = 0
        self.batch_fill_sum = 0.0
        self.cancels = 0
        self.replans = 0
        self.feedback_version = 0
        self.runs_since_replan = 0
        self.fingerprint: str | None = None
        self.search: str | None = None
        # per-run q-error deques (worst step / end-to-end)
        self.run_qerrs: deque[float] = deque(maxlen=self.window)
        self.e2e_qerrs: deque[float] = deque(maxlen=self.window)
        self._sig: int | None = None
        self._reset_steps(0)

    def _reset_steps(self, n: int) -> None:
        self.n_steps = n
        self.est_rows: list[float] = [0.0] * n
        self.sum_in = [0] * n
        self.sum_kept = [0] * n
        self.sum_expanded = [0] * n
        self.sum_prune_in = [0] * n
        self.sum_prune_out = [0] * n
        self.sum_retries = [0] * n
        self.step_qerrs: list[deque[float]] = [
            deque(maxlen=self.window) for _ in range(n)]
        # (child, parent, elabel, forward) per step; -1 parent = restart
        self.step_edges: list[tuple[int, int, int, bool] | None] = [None] * n

    # -- folding -----------------------------------------------------------

    def fold(self, plan, stats: dict, *, count: int, wall_ms: float,
             fingerprint: str | None = None) -> None:
        """Fold one completed run.  ``plan`` is the branch-0 base
        ``ExecPlan`` (duck-typed: est_rows / steps / start_candidates /
        signature / search); ``stats`` its base ``Result.stats``."""
        sig = hash(plan.signature())
        if sig != self._sig:
            self._sig = sig
            self._reset_steps(len(plan.steps))
            self.est_rows = [float(x) for x in plan.est_rows][: self.n_steps]
            for i, s in enumerate(plan.steps[: self.n_steps]):
                self.step_edges[i] = (int(s.u), int(s.parent),
                                      int(s.elabel), bool(s.forward))
        if fingerprint is not None:
            self.fingerprint = fingerprint
        self.search = getattr(plan, "search", None)
        self.runs += 1
        self.runs_since_replan += 1
        self.wall_ms_total += float(wall_ms)
        self.last_wall_ms = float(wall_ms)
        self.rows_total += int(count)

        kept = [int(x) for x in (stats.get("step_kept") or [])]
        expanded = [int(x) for x in (stats.get("step_rows") or [])]
        retries = [int(x) for x in (stats.get("step_retries") or [])]
        p_in = [int(x) for x in (stats.get("step_prune_in") or [])]
        p_out = [int(x) for x in (stats.get("step_prune_out") or [])]
        try:
            n0 = int(plan.start_candidates.shape[0])
        except AttributeError:
            n0 = 0

        worst = 1.0
        inputs = n0
        for i in range(min(self.n_steps, len(kept))):
            self.sum_in[i] += inputs
            self.sum_kept[i] += kept[i]
            if i < len(expanded):
                self.sum_expanded[i] += expanded[i]
            if i < len(retries):
                self.sum_retries[i] += retries[i]
                self.retries += retries[i]
            if i < len(p_in) and p_in[i] >= 0:
                self.sum_prune_in[i] += p_in[i]
                self.sum_prune_out[i] += max(0, p_out[i])
            if i < len(self.est_rows):
                qe = qerror(self.est_rows[i], kept[i])
                self.step_qerrs[i].append(qe)
                worst = max(worst, qe)
            inputs = kept[i]
        self.run_qerrs.append(worst)
        est_total = self.est_rows[-1] if self.est_rows else float(max(1, n0))
        self.e2e_qerrs.append(qerror(est_total, count))

        for k in stats.get("step_kernels") or []:
            self.kernels[str(k)] += 1
        self.degraded[int(stats.get("degraded_level") or 0)] += 1
        self.resumes += int(stats.get("resumes") or 0)
        self.compiles += int(stats.get("compiles") or 0)
        if stats.get("batched"):
            self.batched_runs += 1
            self.batch_fill_sum += float(stats.get("batch_fill") or 1.0)

    # -- derived -----------------------------------------------------------

    def median_qerror(self, last: int | None = None) -> float:
        vals = list(self.run_qerrs)
        if last is not None:
            vals = vals[-last:]
        return _median(vals) if vals else 1.0

    def observed_fanouts(self) -> dict[tuple[int, int, int, bool],
                                       tuple[float, float]]:
        """Per-edge observed (surviving, raw-expansion) fanouts, keyed by
        ``(child, parent, elabel, forward)`` query-vertex indices.
        Restart steps (parent == -1) and never-fed steps are skipped."""
        out: dict[tuple[int, int, int, bool], tuple[float, float]] = {}
        for i in range(self.n_steps):
            edge = self.step_edges[i]
            if edge is None or edge[1] < 0 or self.sum_in[i] <= 0:
                continue
            card = self.sum_kept[i] / self.sum_in[i]
            raw = self.sum_expanded[i] / self.sum_in[i]
            clamp = lambda v: min(_FANOUT_MAX, max(_FANOUT_MIN, v))  # noqa: E731
            out[edge] = (clamp(card), clamp(max(raw, card)))
        return out

    def snapshot(self) -> dict:
        steps = []
        for i in range(self.n_steps):
            rec = {
                "est_rows": self.est_rows[i] if i < len(self.est_rows) else None,
                "obs_rows": (self.sum_kept[i] / self.runs) if self.runs else 0.0,
                "q_error_median": _median(self.step_qerrs[i])
                if self.step_qerrs[i] else None,
                "retries": self.sum_retries[i],
            }
            if self.sum_in[i] > 0:
                rec["obs_fanout"] = self.sum_kept[i] / self.sum_in[i]
            if self.sum_prune_in[i] > 0:
                rec["prune_ratio"] = 1.0 - (self.sum_prune_out[i]
                                            / self.sum_prune_in[i])
            steps.append(rec)
        return {
            "dataset": self.dataset,
            "plan_key": self.plan_key,
            "fingerprint": self.fingerprint,
            "search": self.search,
            "runs": self.runs,
            "rows_total": self.rows_total,
            "wall_ms_total": self.wall_ms_total,
            "last_wall_ms": self.last_wall_ms,
            "q_error_median": self.median_qerror(),
            "q_error_max": max(self.run_qerrs) if self.run_qerrs else 1.0,
            "e2e_q_error_median": _median(self.e2e_qerrs)
            if self.e2e_qerrs else 1.0,
            "kernels": dict(self.kernels),
            "degraded": {str(k): v for k, v in sorted(self.degraded.items())},
            "resumes": self.resumes,
            "compiles": self.compiles,
            "retries": self.retries,
            "batched_runs": self.batched_runs,
            "batch_fill_avg": (self.batch_fill_sum / self.batched_runs)
            if self.batched_runs else None,
            "cancels": self.cancels,
            "replans": self.replans,
            "feedback_version": self.feedback_version,
            "steps": steps,
        }


class WorkloadProfiler:
    """Bounded LRU of :class:`WorkloadProfile` + replan trigger.

    ``observe`` folds one run and returns either ``None`` or a replan
    hint ``{"fingerprint", "fanouts", "q_error_median", "version"}``
    when feedback is enabled and the profile has been consistently
    misestimated.  The profiler never mutates the engine itself — the
    caller owns applying the hint (and journaling it), which keeps this
    module import-free of :mod:`repro_torch.core`.
    """

    def __init__(self, *, max_profiles: int = 256, window: int = 32,
                 feedback: bool = False, qerror_threshold: float = 8.0,
                 min_runs: int = 5, max_replans: int = 3,
                 journal: DecisionJournal | None = None):
        self.max_profiles = max(1, int(max_profiles))
        self.window = int(window)
        self.feedback = bool(feedback)
        self.qerror_threshold = float(qerror_threshold)
        self.min_runs = max(1, int(min_runs))
        self.max_replans = max(0, int(max_replans))
        self.journal = journal
        self._profiles: OrderedDict[tuple[str, str], WorkloadProfile] = \
            OrderedDict()
        self._lock = threading.Lock()
        self.evictions = 0

    def _get(self, dataset: str, plan_key: str) -> WorkloadProfile:
        key = (dataset, plan_key)
        prof = self._profiles.get(key)
        if prof is None:
            prof = WorkloadProfile(dataset, plan_key, window=self.window)
            self._profiles[key] = prof
            while len(self._profiles) > self.max_profiles:
                self._profiles.popitem(last=False)
                self.evictions += 1
        else:
            self._profiles.move_to_end(key)
        return prof

    def observe(self, dataset: str, plan_key: str, plan, stats: dict, *,
                count: int, wall_ms: float,
                fingerprint: str | None = None) -> dict | None:
        with self._lock:
            prof = self._get(dataset, plan_key)
            prof.fold(plan, stats, count=count, wall_ms=wall_ms,
                      fingerprint=fingerprint)
            if not self.feedback or prof.fingerprint is None:
                return None
            if (prof.replans >= self.max_replans
                    or prof.runs_since_replan < self.min_runs
                    or len(prof.run_qerrs) < self.min_runs):
                return None
            med = prof.median_qerror(last=self.min_runs)
            if med <= self.qerror_threshold:
                return None
            fanouts = prof.observed_fanouts()
            if not fanouts:
                return None
            prof.replans += 1
            prof.feedback_version += 1
            prof.runs_since_replan = 0
            prof.run_qerrs.clear()
            for dq in prof.step_qerrs:
                dq.clear()
            return {"fingerprint": prof.fingerprint, "fanouts": fanouts,
                    "q_error_median": med, "version": prof.feedback_version,
                    "dataset": dataset, "plan_key": plan_key}

    def record_cancel(self, dataset: str, plan_key: str) -> None:
        with self._lock:
            if (dataset, plan_key) in self._profiles:
                self._profiles[(dataset, plan_key)].cancels += 1

    def snapshot(self, limit: int | None = None) -> list[dict]:
        with self._lock:
            profs = list(self._profiles.values())
        out = [p.snapshot() for p in profs]
        out.sort(key=lambda d: (d["q_error_median"], d["runs"]), reverse=True)
        if limit is not None:
            out = out[: max(0, int(limit))]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._profiles)
