"""Wall-clock timing helpers used by benchmarks and the straggler tracker."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import torch


@dataclass
class Timer:
    """Accumulating timer: ``with timer.span("phase"): ...``; per-phase totals."""

    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(1, self.counts.get(name, 0))

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{k:40s} total={v * 1e3:10.2f}ms n={self.counts[k]:5d} "
            f"mean={self.mean(k) * 1e3:8.3f}ms"
            for k, v in rows
        )


def timed(fn: Callable, *args, repeats: int = 3, warmup: int = 1, **kwargs):
    """Best-effort microbenchmark: returns (result, seconds_per_call).

    Mirrors the paper's protocol (5 runs, drop best/worst, average the rest)
    when ``repeats >= 3``; each call's time runs until the CUDA devices
    holding the result's tensors have finished (see :func:`_block`).
    """
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        _block(result)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _block(result)
        times.append(time.perf_counter() - t0)
    times.sort()
    if len(times) >= 3:
        times = times[1:-1]  # drop best and worst, like the paper
    return result, sum(times) / len(times)


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in ``x``: a tensor, or tensors nested
    in tuples, lists, dict values and dataclass fields (a ``Result``)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    return out


def _block(x) -> None:
    """Wait until every CUDA device holding a tensor of ``x`` has finished
    its queued work (a CPU result needs no wait)."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)
