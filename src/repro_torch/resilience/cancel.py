"""Cooperative cancellation.

A :class:`CancelToken` is created where a deadline is known (the
scheduler's ``submit``, or ``SparqlEngine.query(timeout_ms=...)``) and
threaded by reference down to the executor's chunk loop.  The executor
polls it at chunk boundaries and suffix-resume re-entries -- the
natural yield points of the freeze-at-overflow design -- so an expired
or abandoned flight stops dispatching within one chunk.

Deadlines are absolute ``time.monotonic()`` values, which makes the
token safe to extend when a coalescing scheduler attaches a second
waiter with a later deadline.
"""

from __future__ import annotations

import threading
import time


class QueryCancelled(RuntimeError):
    """A query was cancelled mid-execution (deadline or abandonment).

    ``partial_stats`` holds whatever execution stats had accumulated by
    the time the cancel was observed; the serve layer surfaces a
    compact subset in the HTTP 504 body.
    """

    def __init__(
        self,
        message: str = "query cancelled",
        *,
        partial_stats: dict | None = None,
        queue_wait_ms: float | None = None,
        exec_ms: float | None = None,
    ) -> None:
        super().__init__(message)
        self.partial_stats = partial_stats or {}
        self.queue_wait_ms = queue_wait_ms
        self.exec_ms = exec_ms


class CancelToken:
    """Thread-safe cancellation handle with an optional absolute deadline."""

    __slots__ = ("_lock", "deadline", "_cancelled", "_reason")

    def __init__(self, deadline: float | None = None) -> None:
        self._lock = threading.Lock()
        self.deadline = deadline  # absolute time.monotonic(), or None
        self._cancelled = False
        self._reason: str | None = None

    def cancel(self, reason: str = "cancelled") -> None:
        with self._lock:
            if not self._cancelled:
                self._cancelled = True
                self._reason = reason

    def extend(self, deadline: float | None) -> None:
        """Push the deadline later (never earlier); ``None`` clears it."""
        with self._lock:
            if deadline is None:
                self.deadline = None
            elif self.deadline is not None:
                self.deadline = max(self.deadline, deadline)

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def reason(self) -> str | None:
        if self._cancelled:
            return self._reason
        if self.deadline is not None and time.monotonic() >= self.deadline:
            return "deadline exceeded"
        return None

    @property
    def expired(self) -> bool:
        if self._cancelled:
            return True
        d = self.deadline
        return d is not None and time.monotonic() >= d

    def remaining(self) -> float | None:
        """Seconds until the deadline (None if no deadline). <=0 if past."""
        d = self.deadline
        if d is None:
            return None
        return d - time.monotonic()

    def check(self, partial_stats: dict | None = None) -> None:
        """Raise :class:`QueryCancelled` if cancelled or past deadline."""
        if self.expired:
            raise QueryCancelled(
                f"query cancelled: {self.reason or 'cancelled'}",
                partial_stats=dict(partial_stats) if partial_stats else {},
            )
