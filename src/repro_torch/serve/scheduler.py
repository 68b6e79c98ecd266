"""Thread-based request scheduler with admission control and micro-batching.

Requests are canonicalized on the submitting thread (cheap, pure-Python)
and keyed ``(dataset, fingerprint, graph_version)``.  Concurrent requests
with the same key *coalesce*: one flight executes, every waiter gets the
shared result with its own variable names restored — the serving-layer
analogue of the engine's shared-plan compilation, applied to execution.

Distinct queries of the same *shape* (same structure, different constants)
additionally coalesce into one **batched dispatch**: the submitting thread
parameterizes the query (``fingerprint.parameterize_query``), flights are
grouped by ``(dataset, shape, graph_version)``, and the worker that picks
up the first such flight *claims* up to ``batch_max - 1`` same-shape
queued peers and answers the whole batch in one batch program via
``registry.execute_canonical_batch`` — splitting results back per request.
A ``batch_window_ms`` micro-deadline optionally holds a lone eligible
flight briefly to let peers arrive.  Forced-trace flights never coalesce
or batch (each requester wants *their* execution observed), but their
traces carry a ``batch_assemble`` span so batched and solo timelines stay
comparable.

Admission control bounds the number of queued flights (excess submissions
fail fast with :class:`Overloaded`) and every request carries a deadline:
waiters stop waiting when it passes, and a flight that is still queued past
its deadline is dropped without executing.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field

from repro_torch.core.sparql_exec import QueryResult
from repro_torch.rdf.sparql import SelectQuery, parse_sparql
from repro_torch.resilience.cancel import CancelToken, QueryCancelled
from repro_torch.serve.fingerprint import (CanonicalQuery, ParamQuery,
                                     canonicalize_query, parameterize_query)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.utils import get_logger

log = get_logger("serve.scheduler")


def _maybe_span(trace, name: str, **meta):
    return (trace.span(name, **meta) if trace is not None
            else contextlib.nullcontext())


# correlation ids: one per *flight* (coalesced waiters share their leader's
# id — the id names the execution, not the HTTP request).  A short random
# process prefix keeps ids from different server processes distinguishable
# in merged logs.
_qid_prefix = uuid.uuid4().hex[:6]
_qid_counter = itertools.count(1)


def next_query_id() -> str:
    """Process-unique correlation id for one scheduled flight."""
    return f"{_qid_prefix}-{next(_qid_counter):06d}"


class SchedulerError(RuntimeError):
    pass


class Overloaded(SchedulerError):
    """Admission control rejected the request (queue full).

    ``retry_after_s`` estimates when the queue should have drained enough
    to accept new work (surfaced as the HTTP ``Retry-After`` header)."""

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(SchedulerError):
    """The request's deadline passed before a result was ready.

    ``queue_wait_ms`` / ``exec_ms`` split where the time went (queued vs.
    executing) so clients can tune their backoff."""

    def __init__(self, message: str, queue_wait_ms: float | None = None,
                 exec_ms: float | None = None) -> None:
        super().__init__(message)
        self.queue_wait_ms = queue_wait_ms
        self.exec_ms = exec_ms


class SchedulerStopped(SchedulerError):
    """submit() called on a scheduler that is not running."""


class SchedulerShutdown(SchedulerError):
    """The scheduler stopped while this flight was still unfinished."""


@dataclass
class _Flight:
    key: tuple
    dataset: str
    canonical: CanonicalQuery
    version: int
    deadline: float  # absolute monotonic; max over attached waiters
    done: threading.Event = field(default_factory=threading.Event)
    result: QueryResult | None = None
    error: Exception | None = None
    waiters: int = 1
    trace: object | None = None  # repro_torch.obs.Trace for forced-trace requests
    query_id: str = ""  # correlation id, threaded through traces/logs/journal
    # same-shape batching: the parameterized form (None = batching-
    # ineligible), the batch key (dataset, shape, version), and whether a
    # batch leader already claimed this flight (its worker then skips it)
    param: ParamQuery | None = None
    bkey: tuple | None = None
    claimed: bool = False
    # cooperative cancellation: the token travels into the executor's chunk
    # loop; queue-wait vs. execution timing feeds 504 error bodies
    cancel: CancelToken = field(default_factory=CancelToken)
    t_submit: float = 0.0  # monotonic, set at enqueue
    t_start: float | None = None  # monotonic, set when a worker picks it up

    def timing_ms(self, now: float | None = None) -> tuple[float, float]:
        """(queue_wait_ms, exec_ms) as of ``now``."""
        now = time.monotonic() if now is None else now
        if self.t_start is None:
            return max(0.0, now - self.t_submit) * 1e3, 0.0
        return (max(0.0, self.t_start - self.t_submit) * 1e3,
                max(0.0, now - self.t_start) * 1e3)


_SENTINEL = object()


class Scheduler:
    """Request queue + worker pool in front of a dataset registry.

    ``registry`` needs two methods: ``version(dataset) -> int`` and
    ``execute_canonical(dataset, canonical, version) -> QueryResult`` (see
    :class:`repro_torch.serve.server.DatasetRegistry`).
    """

    def __init__(self, registry, *, workers: int = 4, max_queue: int = 64,
                 default_timeout_s: float = 30.0,
                 metrics: ServeMetrics | None = None,
                 batch_max: int = 16, batch_window_ms: float = 0.0):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.registry = registry
        self.max_queue = max_queue
        self.default_timeout_s = default_timeout_s
        self.metrics = metrics or ServeMetrics()
        # same-shape batching: at most batch_max queries per dispatch;
        # batch_max <= 1 disables batching entirely.  batch_window_ms > 0
        # holds a lone eligible flight that long for peers to arrive
        # (trades a bounded latency bump for batching under light load).
        self.batch_max = batch_max
        self.batch_window_s = max(0.0, batch_window_ms) / 1e3
        self._can_batch = (batch_max > 1 and callable(
            getattr(registry, "execute_canonical_batch", None)))
        # duck-typed registries (tests, custom backends) may not know the
        # ``cancel`` / ``query_id`` kwargs — probe the signatures once
        def _accepts(fn, name: str) -> bool:
            try:
                import inspect

                return fn is not None and name in inspect.signature(
                    fn).parameters
            except (TypeError, ValueError):
                return False

        reg_exec = getattr(registry, "execute_canonical", None)
        reg_batch = getattr(registry, "execute_canonical_batch", None)
        self._reg_accepts_cancel = _accepts(reg_exec, "cancel")
        self._reg_accepts_qid = _accepts(reg_exec, "query_id")
        self._batch_accepts_cancel = _accepts(reg_batch, "cancel")
        self._batch_accepts_qids = _accepts(reg_batch, "query_ids")
        # EMA of execution time, for the Overloaded Retry-After estimate
        self._ema_exec_ms = 50.0
        self._queue: queue.Queue = queue.Queue()
        self._inflight: dict[tuple, _Flight] = {}
        self._pending: dict[tuple, list[_Flight]] = {}  # bkey -> queued
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._running = False
        self._n_workers = workers

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "Scheduler":
        with self._lock:
            if self._running:
                return self
            self._running = True
        self.metrics.bind_queue_depth(self._queue.qsize)
        for i in range(self._n_workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"serve-worker-{i}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self, wait: bool = True) -> None:
        """Stop the worker pool.

        Every unfinished flight is failed with :class:`SchedulerShutdown`
        (waking all its waiters) and in-flight executions are cancelled via
        their tokens, so no waiter blocks past shutdown.  A worker thread
        that fails to join (stuck in a non-cooperative call) is *logged* as
        leaked rather than silently dropped — its flight has already been
        failed, so nothing waits on it."""
        with self._lock:
            if not self._running:
                return
            self._running = False
            inflight = list(self._inflight.values())
        # cancel running executions first so stuck workers get a chance to
        # exit at their next chunk boundary before the join deadline
        for f in inflight:
            f.cancel.cancel("scheduler shutdown")
        # fail every unfinished flight *now*: waiters wake immediately with
        # SchedulerShutdown instead of riding out the worker join below
        failed = 0
        with self._lock:
            for f in list(self._inflight.values()):
                if not f.done.is_set():
                    failed += 1
                self._finish_locked(f, error=SchedulerShutdown(
                    "scheduler stopped before this flight finished"))
            self._pending.clear()
        for _ in self._threads:
            self._queue.put(_SENTINEL)
        leaked: list[str] = []
        if wait:
            for t in self._threads:
                t.join(timeout=5.0)
                if t.is_alive():
                    leaked.append(t.name)
        self._threads.clear()
        # sweep flights a concurrent submit may have registered between the
        # _running flip and its queue put
        with self._lock:
            remaining = [f for f in self._inflight.values()
                         if not f.done.is_set()]
            self._inflight.clear()
            self._pending.clear()
        failed += len(remaining)
        for f in remaining:
            self._finish(f, error=SchedulerShutdown(
                "scheduler stopped before this flight finished"))
        if leaked:
            log.warning(
                "scheduler stop: %d worker thread(s) failed to join within "
                "5s and leaked: %s (their flights were failed with "
                "SchedulerShutdown)", len(leaked), ", ".join(leaked))
        if failed:
            log.info("scheduler stop: failed %d unfinished flight(s) with "
                     "SchedulerShutdown", failed)

    def __enter__(self) -> "Scheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- submit
    def submit(self, dataset: str, query: str | SelectQuery | CanonicalQuery,
               timeout_s: float | None = None,
               trace: bool = False) -> QueryResult:
        """Execute (or join) a query; returns bindings with the caller's
        variable names.  Raises ``Overloaded`` / ``DeadlineExceeded`` /
        parse and plan errors from the engine.

        ``trace=True`` forces a profiled :class:`repro_torch.obs.Trace` for this
        request: the result's ``stats["trace"]`` carries the span tree.
        Forced-trace flights never coalesce (each requester wants *their*
        execution observed), and parse/canonicalize happen inside the trace
        so the span sum accounts for the submitting thread's work too."""
        if not self._running:
            raise SchedulerStopped("scheduler is not running; call start()")
        t0 = time.perf_counter()
        t = None
        if trace:
            from repro_torch.obs import Trace
            t = Trace(profile_steps=True)
        pq: ParamQuery | None = None
        if isinstance(query, CanonicalQuery):
            canon = query
        else:
            if isinstance(query, str):
                with _maybe_span(t, "parse"):
                    query = parse_sparql(query)
            with _maybe_span(t, "fingerprint"):
                if t is None and self._can_batch:
                    # shape + constants in one pass (canonicalization is a
                    # sub-step of parameterization, so no duplicate work)
                    pq = parameterize_query(query)
                    canon = pq.canon
                    if not pq.consts:
                        pq = None
                else:
                    canon = canonicalize_query(query)
        version = self.registry.version(dataset)
        timeout = self.default_timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + timeout
        key = (dataset, canon.fingerprint, version)
        if t is not None:
            # unique tail: a forced trace must execute, never coalesce
            key = key + (("trace", t.trace_id),)

        with self._lock:
            flight = self._inflight.get(key)
            if flight is not None and not flight.done.is_set():
                flight.waiters += 1
                flight.deadline = max(flight.deadline, deadline)
                flight.cancel.extend(deadline)
                self.metrics.coalesced.inc()
                coalesced = True
            else:
                if self._queue.qsize() >= self.max_queue:
                    self.metrics.record(dataset, "overloaded",
                                        (time.perf_counter() - t0) * 1e3)
                    raise Overloaded(
                        f"queue full ({self.max_queue} flights pending)",
                        retry_after_s=self.retry_after_s())
                flight = _Flight(key=key, dataset=dataset, canonical=canon,
                                 version=version, deadline=deadline, trace=t,
                                 query_id=next_query_id(),
                                 cancel=CancelToken(deadline),
                                 t_submit=time.monotonic())
                if t is not None:
                    t.query_id = flight.query_id
                    t.dataset = dataset
                if pq is not None:
                    flight.param = pq
                    flight.bkey = (dataset, pq.shape, version)
                    self._pending.setdefault(flight.bkey, []).append(flight)
                self._inflight[key] = flight
                self._queue.put(flight)
                coalesced = False
        self.metrics.inflight.inc()
        self.metrics.dataset_inflight.inc(dataset)
        self.metrics.queue_depth.set(self._queue.qsize())
        try:
            finished = flight.done.wait(max(0.0, deadline - time.monotonic()))
            ms = (time.perf_counter() - t0) * 1e3
            if not finished:
                self.metrics.record(dataset, "timeout", ms)
                qw, ex = flight.timing_ms()
                raise DeadlineExceeded(
                    f"no result within {timeout:.3f}s "
                    f"({'coalesced' if coalesced else 'leader'})",
                    queue_wait_ms=qw, exec_ms=ex)
            if flight.error is not None:
                status = ("timeout" if isinstance(flight.error,
                                                  DeadlineExceeded)
                          else "cancelled" if isinstance(flight.error,
                                                         QueryCancelled)
                          else "error")
                self.metrics.record(dataset, status, ms)
                raise flight.error
            self.metrics.record(dataset, "ok", ms)
            res = flight.result
            assert res is not None
            stats = dict(res.stats)
            stats["query_id"] = flight.query_id
            return QueryResult(canon.restore(res.variables), res.rows,
                               list(res.kinds), count=res.count,
                               stats=stats)
        finally:
            self.metrics.inflight.dec()
            self.metrics.dataset_inflight.dec(dataset)
            with self._lock:
                flight.waiters -= 1
                abandoned = flight.waiters <= 0 and not flight.done.is_set()
            if abandoned:
                # every waiter is gone (timed out or errored): cancel the
                # execution so it stops occupying the device
                flight.cancel.cancel("all waiters abandoned the flight")

    # ----------------------------------------------------------- finalize
    def _finish_locked(self, flight: _Flight,
                       result: QueryResult | None = None,
                       error: Exception | None = None) -> None:
        """Finalize a flight exactly once (caller holds the lock):
        de-register it, store the outcome, wake every waiter.  Idempotent —
        shutdown and a slow worker may race to finish the same flight."""
        if self._inflight.get(flight.key) is flight:
            del self._inflight[flight.key]
        self._unpend(flight)
        if flight.done.is_set():
            return
        flight.result, flight.error = result, error
        if result is not None and flight.t_start is not None:
            _, exec_ms = flight.timing_ms()
            self._ema_exec_ms = 0.8 * self._ema_exec_ms + 0.2 * exec_ms
        flight.done.set()

    def _finish(self, flight: _Flight, result: QueryResult | None = None,
                error: Exception | None = None) -> None:
        with self._lock:
            self._finish_locked(flight, result=result, error=error)

    def retry_after_s(self) -> float:
        """Seconds until the queue has likely drained enough to retry:
        per-worker backlog times the execution-time EMA, clamped to
        [0.5s, 30s].  Feeds the 503 ``Retry-After`` header."""
        backlog = self._queue.qsize() / max(1, self._n_workers)
        return min(30.0, max(0.5, backlog * self._ema_exec_ms / 1e3))

    # ------------------------------------------------------------- worker
    def _worker(self) -> None:
        while True:
            flight = self._queue.get()
            if flight is _SENTINEL:
                return
            self.metrics.queue_depth.set(self._queue.qsize())
            # expiry check and de-registration are atomic with submit's
            # attach/deadline-extend, so no request can coalesce onto a
            # flight that is about to be declared dead; a claimed flight
            # was (or is being) answered by a batch leader — skip it
            with self._lock:
                if flight.claimed:
                    continue
                dead = (time.monotonic() > flight.deadline
                        or flight.cancel.cancelled)
                if dead:
                    qw, ex = flight.timing_ms()
                    self._finish_locked(flight, error=DeadlineExceeded(
                        "expired while queued (admission backlog)",
                        queue_wait_ms=qw, exec_ms=ex))
            if dead:
                continue
            flight.t_start = time.monotonic()
            if flight.param is not None and flight.trace is None:
                self._run_batch(flight)
                continue
            if flight.trace is not None:
                flight.trace.thread = threading.current_thread().name
                # forced traces never batch; record the (empty) assembly
                # phase so batched and solo timelines stay comparable
                t_asm = time.perf_counter()
                flight.trace.add("batch_assemble",
                                 time.perf_counter() - t_asm, batch=1)
            err: Exception | None = None
            result = None
            try:
                # pass trace/cancel only when applicable so duck-typed
                # registries that don't know the kwargs (tests, custom
                # backends) keep working
                kwargs = {}
                if flight.trace is not None:
                    kwargs["trace"] = flight.trace
                if self._reg_accepts_cancel:
                    kwargs["cancel"] = flight.cancel
                if self._reg_accepts_qid:
                    kwargs["query_id"] = flight.query_id
                result = self.registry.execute_canonical(
                    flight.dataset, flight.canonical, flight.version,
                    **kwargs)
            except QueryCancelled as e:
                self.metrics.cancelled.inc()
                if e.queue_wait_ms is None:
                    e.queue_wait_ms, e.exec_ms = flight.timing_ms()
                err = e
            except Exception as e:  # noqa: BLE001 — fan the error out
                err = e
            self._finish(flight, result=result, error=err)

    # ----------------------------------------------------------- batching
    def _unpend(self, flight: _Flight) -> None:
        """Drop a flight from its batch-pending list (caller holds lock)."""
        if flight.bkey is None:
            return
        pend = self._pending.get(flight.bkey)
        if pend is not None:
            try:
                pend.remove(flight)
            except ValueError:
                pass
            if not pend:
                self._pending.pop(flight.bkey, None)

    def _claim_peers(self, leader: _Flight, n: int) -> list[_Flight]:
        """Claim up to ``n`` queued same-shape peers (caller holds lock).
        Expired peers found along the way are failed in place."""
        pend = self._pending.get(leader.bkey)
        if not pend or n <= 0:
            return []
        now = time.monotonic()
        taken: list[_Flight] = []
        kept: list[_Flight] = []
        # copy: _finish_locked on an expired peer unpends it from `pend`
        for f in list(pend):
            if f is leader or f.claimed:
                continue
            if now > f.deadline or f.cancel.cancelled:
                f.claimed = True
                qw, ex = f.timing_ms(now)
                self._finish_locked(f, error=DeadlineExceeded(
                    "expired while queued (admission backlog)",
                    queue_wait_ms=qw, exec_ms=ex))
            elif len(taken) < n:
                f.claimed = True
                taken.append(f)
            else:
                kept.append(f)
        if kept:
            self._pending[leader.bkey] = kept
        else:
            self._pending.pop(leader.bkey, None)
        return taken

    def _run_batch(self, leader: _Flight) -> None:
        """Lead a same-shape batch: claim queued peers, answer the whole
        batch via ``registry.execute_canonical_batch`` (one batch program
        when the shape parameterizes), fan results back out."""
        batch = [leader]
        with self._lock:
            self._unpend(leader)
            batch += self._claim_peers(leader, self.batch_max - 1)
        if len(batch) < self.batch_max and self.batch_window_s > 0:
            # micro-deadline: hold an under-full batch briefly so arrivals
            # still in the parse/fingerprint stage can join — batching
            # amortizes so steeply that a few ms of queueing is repaid
            # whenever there is any same-shape pressure at all
            time.sleep(min(self.batch_window_s,
                           max(0.0, leader.deadline - time.monotonic())))
            with self._lock:
                batch += self._claim_peers(leader,
                                           self.batch_max - len(batch))
        now = time.monotonic()
        for f in batch:
            if f.t_start is None:
                f.t_start = now
        # one token for the whole dispatch: live until the *latest* member
        # deadline, and cancelled only when every member's token is — a
        # batch keeps running as long as anyone still wants its answer
        group = CancelToken(max(f.deadline for f in batch))
        try:
            kwargs = {"cancel": group} if self._batch_accepts_cancel else {}
            if self._batch_accepts_qids:
                kwargs["query_ids"] = [f.query_id for f in batch]
            out = self.registry.execute_canonical_batch(
                leader.dataset, [f.param for f in batch], leader.version,
                **kwargs)
            if len(out) != len(batch):
                raise SchedulerError(
                    f"registry returned {len(out)} results for a batch "
                    f"of {len(batch)}")
        except QueryCancelled as e:
            self.metrics.cancelled.inc(len(batch))
            out = [e] * len(batch)
        except Exception as e:  # noqa: BLE001 — fan the error out
            out = [e] * len(batch)
        with self._lock:
            for f, r in zip(batch, out):
                if isinstance(r, Exception):
                    self._finish_locked(f, error=r)
                else:
                    self._finish_locked(f, result=r)

    # -------------------------------------------------------------- stats
    def snapshot(self) -> dict:
        with self._lock:
            inflight = len(self._inflight)
            alive = sum(1 for t in self._threads if t.is_alive())
        return {"inflight": inflight, "queued": self._queue.qsize(),
                "workers": self._n_workers, "workers_alive": alive,
                "running": self._running, "max_queue": self.max_queue,
                "retry_after_s": round(self.retry_after_s(), 3),
                "ema_exec_ms": round(self._ema_exec_ms, 3),
                **self.metrics.summary()}
