"""Allocation-light nested span traces for one query execution.

A :class:`Trace` is owned by a single logical request.  Code on the query
path receives ``trace=None`` by default and guards every annotation with
``if trace is not None`` — the disabled path costs one pointer compare.
Spans form a tree; timestamps are seconds relative to the trace origin
(``time.perf_counter`` based, so only durations and intra-trace offsets
are meaningful).

Span tree construction is stack-based: ``with trace.span("execute"): ...``
nests everything opened inside under it.  Spans may also be attached
post-hoc with a known duration (``trace.add``) — the executor uses that to
report per-step device wall times measured by its profiled path — or as
zero-duration events (``trace.event``).

A trace is *not* generally thread-safe; the serving layer hands it from
the submitting thread to the scheduler worker sequentially (parse spans
finish before the flight is enqueued), which is safe.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import time
from typing import Any, Iterator

_ids = itertools.count(1)


class Span:
    """One node of the span tree.  ``t0``/``dur`` are seconds relative to
    the owning trace's origin."""

    __slots__ = ("name", "t0", "dur", "meta", "children")

    def __init__(self, name: str, t0: float, meta: dict | None = None):
        self.name = name
        self.t0 = t0
        self.dur = 0.0
        self.meta: dict[str, Any] = meta if meta is not None else {}
        self.children: list[Span] = []

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"name": self.name,
                             "t0_ms": round(self.t0 * 1e3, 4),
                             "dur_ms": round(self.dur * 1e3, 4)}
        if self.meta:
            d["meta"] = self.meta
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, t0={self.t0 * 1e3:.3f}ms, "
                f"dur={self.dur * 1e3:.3f}ms, {len(self.children)} children)")


class Trace:
    """A single request's span tree.

    ``profile_steps=True`` marks a *forced* trace: the engine executes in
    profiled mode (per-step host syncs) so step spans carry real device
    wall times and the span sum accounts for end-to-end wall time.
    Sampled traces keep the fast execution path and report per-step
    counters with zero-duration step spans instead.
    """

    __slots__ = ("trace_id", "name", "origin", "root", "_stack",
                 "profile_steps", "sampled", "query_id", "dataset", "thread")

    def __init__(self, name: str = "query", *, profile_steps: bool = False,
                 sampled: bool = False):
        self.trace_id = next(_ids)
        self.name = name
        self.origin = time.perf_counter()
        self.root = Span(name, 0.0)
        self._stack: list[Span] = [self.root]
        self.profile_steps = profile_steps
        self.sampled = sampled
        # correlation labels, filled by the serving layer: the scheduler's
        # query_id, the dataset served, and the worker thread that ran it
        self.query_id: str | None = None
        self.dataset: str | None = None
        self.thread: str | None = None

    # ------------------------------------------------------------ recording
    def _now(self) -> float:
        return time.perf_counter() - self.origin

    @contextlib.contextmanager
    def span(self, name: str, **meta: Any) -> Iterator[Span]:
        s = Span(name, self._now(), meta or None)
        parent = self._stack[-1]
        parent.children.append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.dur = self._now() - s.t0
            self._stack.pop()

    def add(self, name: str, dur_s: float = 0.0, **meta: Any) -> Span:
        """Attach a completed span (known duration) under the current one."""
        s = Span(name, self._now() - dur_s, meta or None)
        s.dur = dur_s
        self._stack[-1].children.append(s)
        return s

    def event(self, name: str, **meta: Any) -> Span:
        """Zero-duration marker (plan-cache hit, compile detection, ...)."""
        return self.add(name, 0.0, **meta)

    def finish(self) -> "Trace":
        """Close the root span; safe to call more than once."""
        self.root.dur = self._now()
        del self._stack[1:]
        return self

    # ----------------------------------------------------------- inspection
    @property
    def dur_ms(self) -> float:
        return self.root.dur * 1e3

    def span_sum_ms(self) -> float:
        """Sum of top-level child durations — the accounted-for share of
        the end-to-end wall time."""
        return sum(c.dur for c in self.root.children) * 1e3

    def find(self, name: str) -> list[Span]:
        out: list[Span] = []

        def walk(s: Span) -> None:
            if s.name == name:
                out.append(s)
            for c in s.children:
                walk(c)

        walk(self.root)
        return out

    def to_dict(self) -> dict:
        d = {"id": self.trace_id,
             "sampled": self.sampled,
             "profiled": self.profile_steps,
             "dur_ms": round(self.dur_ms, 4),
             "span_sum_ms": round(self.span_sum_ms(), 4),
             "root": self.root.to_dict()}
        if self.query_id is not None:
            d["query_id"] = self.query_id
        if self.dataset is not None:
            d["dataset"] = self.dataset
        if self.thread is not None:
            d["thread"] = self.thread
        return d


def _chrome_events(span: Span, pid: int, tid: int, out: list[dict]) -> None:
    args = {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                else repr(v))
            for k, v in (span.meta or {}).items()}
    out.append({"name": span.name, "ph": "X", "pid": pid, "tid": tid,
                "ts": round(span.t0 * 1e6, 3),
                "dur": round(span.dur * 1e6, 3), "args": args})
    for c in span.children:
        _chrome_events(c, pid, tid, out)


def chrome_trace(traces: "Trace | list[Trace]", as_text: bool = False):
    """Render one or more traces as Chrome ``trace_event`` JSON (load in
    chrome://tracing or https://ui.perfetto.dev).

    Traces are grouped into one process lane per dataset (``Trace.dataset``;
    unlabeled traces share the default ``repro`` process) with
    ``process_name`` / ``thread_name`` metadata events, so Perfetto shows
    dataset and worker-thread names instead of bare pids/tids.  Each trace
    is its own thread lane, labeled with the worker thread that ran it
    (when the serving layer recorded one) plus the trace id / query id.
    """
    if isinstance(traces, Trace):
        traces = [traces]
    events: list[dict] = []
    meta: list[dict] = []
    pids: dict[str | None, int] = {}
    for tid, t in enumerate(traces, start=1):
        ds = t.dataset
        pid = pids.get(ds)
        if pid is None:
            pid = pids[ds] = len(pids) + 1
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0,
                         "args": {"name": f"dataset:{ds}" if ds else "repro"}})
        label = t.thread or t.name
        suffix = t.query_id or f"#{t.trace_id}"
        meta.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                     "args": {"name": f"{label} {suffix}"}})
        _chrome_events(t.root, pid, tid, events)
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    return json.dumps(doc) if as_text else doc
