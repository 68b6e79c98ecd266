"""Straggler detection & mitigation hooks.

Training: ``StepTimeTracker`` keeps a rolling window of per-step wall times;
steps slower than ``factor`` × rolling-median are flagged.  On a real
multi-host fleet the flags feed the controller that evicts/replaces slow
hosts; on this container they surface in metrics and tests.

Engine serving: ``ChunkRebalancer`` consumes per-chunk execution times and
re-deals the heaviest chunks the next round (the paper's dynamic chunk
distribution, closed-loop version).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.utils import get_logger

log = get_logger("train.straggler")


@dataclass
class StepTimeTracker:
    window: int = 50
    factor: float = 2.0
    times: deque = field(default_factory=lambda: deque(maxlen=256))
    flagged: list = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self.times.append(seconds)
        if len(self.times) < 8:
            return False
        med = float(np.median(list(self.times)[-self.window:]))
        is_straggler = seconds > self.factor * med
        if is_straggler:
            self.flagged.append((step, seconds, med))
            log.warning("straggler step %d: %.3fs vs median %.3fs",
                        step, seconds, med)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


@dataclass
class ChunkRebalancer:
    """Re-deal engine work chunks based on observed chunk times."""

    n_shards: int
    history: dict = field(default_factory=dict)  # chunk_id -> ema seconds
    alpha: float = 0.5

    def observe(self, chunk_id: int, seconds: float) -> None:
        prev = self.history.get(chunk_id)
        self.history[chunk_id] = (seconds if prev is None
                                  else self.alpha * seconds
                                  + (1 - self.alpha) * prev)

    def assign(self, chunk_ids: list[int]) -> list[list[int]]:
        """LPT re-assignment using observed times (unknown chunks = median)."""
        default = (float(np.median(list(self.history.values())))
                   if self.history else 1.0)
        est = {c: self.history.get(c, default) for c in chunk_ids}
        order = sorted(chunk_ids, key=lambda c: -est[c])
        loads = np.zeros(self.n_shards)
        out: list[list[int]] = [[] for _ in range(self.n_shards)]
        for c in order:
            s = int(np.argmin(loads))
            out[s].append(c)
            loads[s] += est[c]
        return out
