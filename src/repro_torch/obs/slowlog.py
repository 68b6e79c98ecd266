"""Bounded in-memory slow-query log: the N worst traces, one per query
fingerprint.

Recording is O(capacity) with a plain scan for the eviction victim —
capacities are tens of entries, so a heap would only add bookkeeping.
Entries carry the finished trace, the annotated (EXPLAIN ANALYZE style)
plan description, and enough identity to re-run the query.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from repro_torch.obs.trace import Trace, chrome_trace


class SlowQueryLog:
    """Keep the ``capacity`` slowest traces seen, keyed by fingerprint.

    A repeated fingerprint keeps its single worst observation (the log
    answers "which *queries* are slow", not "which executions"), and a new
    fingerprint evicts the current fastest entry once the log is full —
    only if the newcomer is slower.
    """

    def __init__(self, capacity: int = 32):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = capacity
        self._by_fp: dict[str, dict] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_fp)

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def record(self, fingerprint: str, wall_ms: float, trace: Trace,
               **extra: Any) -> bool:
        """Offer one finished execution; returns True if it was kept."""
        if not self.enabled:
            return False
        entry = {"id": trace.trace_id, "fingerprint": fingerprint,
                 "wall_ms": round(float(wall_ms), 3),
                 "recorded_at": time.time(), "trace": trace, **extra}
        with self._lock:
            prev = self._by_fp.get(fingerprint)
            if prev is not None:
                if wall_ms <= prev["wall_ms"]:
                    return False
                self._by_fp[fingerprint] = entry
                return True
            if len(self._by_fp) >= self.capacity:
                fastest = min(self._by_fp.values(),
                              key=lambda e: e["wall_ms"])
                if wall_ms <= fastest["wall_ms"]:
                    return False
                del self._by_fp[fastest["fingerprint"]]
            self._by_fp[fingerprint] = entry
            return True

    def get(self, trace_id: int) -> dict | None:
        with self._lock:
            for e in self._by_fp.values():
                if e["id"] == trace_id:
                    return e
        return None

    def entries(self) -> list[dict]:
        """All entries, slowest first."""
        with self._lock:
            items = list(self._by_fp.values())
        return sorted(items, key=lambda e: -e["wall_ms"])

    def summaries(self) -> list[dict]:
        """JSON-able digest, slowest first (no span trees)."""
        out = []
        for e in self.entries():
            out.append({k: v for k, v in e.items()
                        if k not in ("trace", "explain")})
        return out

    @staticmethod
    def render_entry(entry: dict, fmt: str = "json") -> dict:
        """Full JSON view of one entry; ``fmt="chrome"`` swaps the span
        tree for Chrome trace_event JSON."""
        trace: Trace = entry["trace"]
        out = {k: v for k, v in entry.items() if k != "trace"}
        if fmt == "chrome":
            return chrome_trace(trace)
        out["trace"] = trace.to_dict()
        return out

    def clear(self) -> None:
        with self._lock:
            self._by_fp.clear()
