"""The traced window: ``torch.profiler`` over the card.

:class:`Traced` records the card's activity (the kernels, copies and
fills of every thread) and nothing of the host, so the window it traces
runs at nearly its untraced pace.  ``stop`` ends the profile and returns
the record that the per-layer readers (``portbench/metrics``) take: the
device events as arrays.
"""

from __future__ import annotations

import time

import numpy as np


class Traced:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        """End the window (after a device sync) and return its record."""
        self.torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        t_read = time.perf_counter()
        self.prof.__exit__(None, None, None)
        rec = read_events(self.prof.profiler.kineto_results.events(),
                          self.torch.autograd.DeviceType.CUDA)
        rec["window_s"] = window_s
        rec["read_s"] = time.perf_counter() - t_read
        return rec


def read_events(events, device_type) -> dict:
    """The record of a profile's device events: ``names``, ``name_idx``,
    ``start_ns`` and ``end_ns``, in start order."""
    names: dict[str, int] = {}
    idx, start, end = [], [], []
    for e in events:
        if e.device_type() != device_type:
            continue
        nm = e.name()
        k = names.get(nm)
        if k is None:
            k = names[nm] = len(names)
        idx.append(k)
        s = e.start_ns()
        start.append(s)
        end.append(s + e.duration_ns())
    order = np.argsort(np.asarray(start, dtype=np.int64), kind="stable")
    return {
        "names": list(names),
        "name_idx": np.asarray(idx, dtype=np.int64)[order],
        "start_ns": np.asarray(start, dtype=np.int64)[order],
        "end_ns": np.asarray(end, dtype=np.int64)[order],
    }


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def busy_s(rec: dict) -> float:
    """Seconds in which some operation ran on the device: the union of
    the device events' intervals."""
    s, e = rec["start_ns"], rec["end_ns"]
    if s.size == 0:
        return 0.0
    run_end = np.maximum.accumulate(e)
    # an interval opens a new busy stretch where it starts after every
    # earlier one ended
    new = np.ones(s.shape, bool)
    new[1:] = s[1:] > run_end[:-1]
    starts = s[new]
    ends = np.append(run_end[np.flatnonzero(new)[1:] - 1], run_end[-1])
    return float((ends - starts).sum()) / 1e9


def breakdown(rec: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle stretches, summed by the pair of operations around them."""
    dur = (rec["end_ns"] - rec["start_ns"]) / 1e9
    by = np.bincount(rec["name_idx"], weights=dur,
                     minlength=len(rec["names"]))
    top = np.argsort(-by)[:10]
    ops = [[rec["names"][i][:120], float(by[i])] for i in top if by[i] > 0]
    s, e = rec["start_ns"], rec["end_ns"]
    gaps: dict[str, float] = {}
    if s.size > 1:
        run_end = np.maximum.accumulate(e)
        g = (s[1:] - run_end[:-1]) / 1e9
        n = len(rec["names"])
        pair = rec["name_idx"][:-1] * n + rec["name_idx"][1:]
        tot = np.bincount(pair[g > 0], weights=g[g > 0], minlength=n * n)
        short = [_short(nm) for nm in rec["names"]]
        for k in np.argsort(-tot)[:10]:
            if tot[k] > 0:
                key = f"host between {short[k // n]} and {short[k % n]}"
                gaps[key] = gaps.get(key, 0.0) + float(tot[k])
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": ops, "idle_gaps": [[k, v] for k, v in idle]}


def _short(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].split("<", 1)[0].strip()[:60]
