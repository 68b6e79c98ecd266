"""Deterministic fault injection for chaos testing.

Named sites are wired into the hot path (``fire(site)`` is a no-op
attribute check when no injector is installed):

- ``compile``       -- a fresh jit compile in ``Executor._get_fn``
- ``dispatch``      -- every chunk dispatch, suffix-resume re-entry,
                       profiled-chunk step, and batched dispatch
- ``delta_merge``   -- merging versioned-store delta CSRs into dense
                       arrays (``Executor._snapshot_arrays``)
- ``store_commit``  -- ``VersionedStore.apply_update`` after validation,
                       before mutation

Kinds:

- ``oom``           -- raises :class:`InjectedFault` whose message
                       contains ``RESOURCE_EXHAUSTED`` (the transient
                       policy treats it like a real device OOM)
- ``compile_error`` -- raises :class:`InjectedFault` (transient)
- ``latency``       -- sleeps ``latency_ms`` then continues
- ``poison``        -- returns True; the dispatch site corrupts the
                       chunk's result so end-to-end checks can detect
                       silent wrong answers

Specs are parsed from ``site:kind[:rate[:latency_ms]]`` strings joined
with ``;`` (env ``REPRO_FAULTS``, seeded by ``REPRO_FAULT_SEED``).
Each spec gets its own ``random.Random`` stream derived from
(seed, spec index), so a given (spec, seed) pair fires at the exact
same sequence of site visits on every run.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, replace
from random import Random

SITES = ("compile", "dispatch", "delta_merge", "store_commit")
KINDS = ("oom", "compile_error", "latency", "poison")


class InjectedFault(RuntimeError):
    """A fault raised by the injection harness (never by real code)."""

    def __init__(self, site: str, kind: str, message: str | None = None) -> None:
        if message is None:
            message = f"injected {kind} at {site}"
            if kind == "oom":
                message += ": RESOURCE_EXHAUSTED (simulated out of memory)"
        super().__init__(message)
        self.site = site
        self.kind = kind


@dataclass(frozen=True)
class FaultSpec:
    site: str
    kind: str
    rate: float = 1.0  # probability of firing per site visit
    times: int | None = None  # stop firing after this many (None = unlimited)
    latency_ms: float = 0.0  # for kind == "latency"

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; expected one of {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {KINDS}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate}")


def parse_fault_spec(text: str) -> tuple[FaultSpec, ...]:
    """Parse ``"site:kind[:rate[:latency_ms]];..."`` into FaultSpecs."""
    specs: list[FaultSpec] = []
    for part in text.replace(",", ";").split(";"):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) < 2:
            raise ValueError(f"bad fault spec {part!r}; want site:kind[:rate[:latency_ms]]")
        site, kind = bits[0], bits[1]
        rate = float(bits[2]) if len(bits) > 2 else 1.0
        latency_ms = float(bits[3]) if len(bits) > 3 else 0.0
        specs.append(FaultSpec(site=site, kind=kind, rate=rate, latency_ms=latency_ms))
    return tuple(specs)


class FaultInjector:
    """Seeded injector; thread-safe; counts every fire per (site, kind)."""

    def __init__(self, specs, seed: int = 0) -> None:
        if isinstance(specs, str):
            specs = parse_fault_spec(specs)
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._rng = {i: Random(self.seed * 1_000_003 + i) for i in range(len(self.specs))}
        self._fired = {i: 0 for i in range(len(self.specs))}
        self.counters: dict[tuple[str, str], int] = {}
        self._by_site: dict[str, list[int]] = {}
        for i, s in enumerate(self.specs):
            self._by_site.setdefault(s.site, []).append(i)

    def fire(self, site: str) -> bool:
        """Visit a site. Raises/sleeps per matching specs; True => poison."""
        idxs = self._by_site.get(site)
        if not idxs:
            return False
        actions: list[FaultSpec] = []
        with self._lock:
            for i in idxs:
                spec = self.specs[i]
                if spec.times is not None and self._fired[i] >= spec.times:
                    continue
                if spec.rate < 1.0 and self._rng[i].random() >= spec.rate:
                    continue
                self._fired[i] += 1
                key = (spec.site, spec.kind)
                self.counters[key] = self.counters.get(key, 0) + 1
                actions.append(spec)
        poison = False
        for spec in actions:
            if spec.kind == "latency":
                if spec.latency_ms > 0:
                    time.sleep(spec.latency_ms / 1e3)
            elif spec.kind == "poison":
                poison = True
            else:  # oom | compile_error
                raise InjectedFault(site, spec.kind)
        return poison

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "specs": [
                    f"{s.site}:{s.kind}:{s.rate}" + (f":{s.latency_ms}" if s.latency_ms else "")
                    for s in self.specs
                ],
                "fired": {f"{site}:{kind}": n for (site, kind), n in sorted(self.counters.items())},
            }


# ---------------------------------------------------------------------------
# Module-level active injector. ``fire`` is called from the executor hot
# path, so the inactive case must stay a couple of attribute loads.

_active: FaultInjector | None = None
_env_checked = False


def _load_env() -> None:
    global _active, _env_checked
    _env_checked = True
    spec = os.environ.get("REPRO_FAULTS", "").strip()
    if spec:
        seed = int(os.environ.get("REPRO_FAULT_SEED", "0"))
        _active = FaultInjector(parse_fault_spec(spec), seed=seed)


def active() -> FaultInjector | None:
    if not _env_checked:
        _load_env()
    return _active


def install(injector: FaultInjector | None) -> FaultInjector | None:
    """Install (or clear) the active injector; returns the previous one."""
    global _active, _env_checked
    prev = active()
    _active = injector
    _env_checked = True
    return prev


def fire(site: str) -> bool:
    inj = _active
    if inj is None:
        if _env_checked:
            return False
        inj = active()
        if inj is None:
            return False
    return inj.fire(site)


def describe() -> dict | None:
    inj = active()
    return inj.snapshot() if inj is not None else None


@contextmanager
def inject(spec, seed: int = 0, times: int | None = None):
    """Scoped injector for tests: ``with faults.inject("dispatch:oom", times=3):``."""
    specs = parse_fault_spec(spec) if isinstance(spec, str) else tuple(spec)
    if times is not None:
        specs = tuple(replace(s, times=times) for s in specs)
    inj = FaultInjector(specs, seed=seed)
    prev = install(inj)
    try:
        yield inj
    finally:
        install(prev)
