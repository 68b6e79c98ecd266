"""One run of one cell: set-up, the measured window, the check, the line.

:func:`run` is the whole run after the look for a card (``run.py`` makes
that look and passes ``device="cuda"``); tests call it on the CPU at a
small size.  Progress and set-up details go to standard error; the result
goes back as the last line's fields.
"""

from __future__ import annotations

import gc
import statistics
import sys
import threading
import time

import numpy as np

from portbench import manifest, system, traffic
from portbench.check import Checker
from portbench.gen import lubm
from portbench.reference import bgp


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class Clients:
    """Closed-loop clients: each sends its next request when its last one
    returned, from the window's opening until its close; requests in
    flight at the close are waited for."""

    def __init__(self, n: int, call, streams):
        self.n = n
        self.call = call
        self.streams = streams
        self.records: list[list[tuple]] = [[] for _ in range(n)]
        self.t_open = self.t_close = 0.0
        self._go = threading.Barrier(n + 1)

    def _client(self, k: int) -> None:
        it, out, call = self.streams[k], self.records[k], self.call
        self._go.wait()
        while time.perf_counter() < self.t_close:
            req = next(it)
            t0 = time.perf_counter()
            try:
                res, err = call(req.text), None
            except Exception as e:  # noqa: BLE001 - a failed request
                res, err = None, e
            out.append((req, t0, time.perf_counter(), res, err))

    def run(self, seconds: float, grace_s: float = 60.0,
            on_open=None) -> list[threading.Thread]:
        threads = [threading.Thread(target=self._client, args=(k,),
                                    daemon=True, name=f"client-{k}")
                   for k in range(self.n)]
        for t in threads:
            t.start()
        if on_open is not None:
            on_open()
        self.t_open = time.perf_counter()
        self.t_close = self.t_open + seconds
        self._go.wait()
        deadline = self.t_close + grace_s
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return [t for t in threads if t.is_alive()]


def _small_probes(results) -> list:
    out = []
    for res in results:
        for br in (res.stats.get("exec") or {}).get("branches") or ():
            probe = (br.get("base") or {}).get("small_probe")
            if probe:
                out.append(probe)
    return out


def _warm(sys_, mix, traf, clients: int, seconds: float) -> dict:
    """Every query of the mix alone, then the mix's own load for
    ``seconds`` from a stream the window never sends (salt 1), and, for
    the scheduler, each family batch size up to ``batch_max``."""
    call = system.call_for(sys_, mix)
    warm = {}
    probes = []
    stream = traf.stream(0, salt=1)
    first: dict[str, str] = {}
    while len(first) < len(traf.templates):
        req = next(stream)
        first.setdefault(req.query, req.text)
    for _ in range(2):
        for q, text in first.items():
            t = time.perf_counter()
            res = call(text)
            warm.setdefault(q, []).append(time.perf_counter() - t)
            probes += _small_probes([res])
    if mix["entry"] == "scheduler":
        texts: dict[str, list[str]] = {}
        for _ in range(64 * len(traf.templates)):
            req = next(stream)
            texts.setdefault(req.query, []).append(req.text)
        system.warm_batches(sys_, texts, sys_.cfg["serving"]["batch_max"])
    load = Clients(clients, call, [traf.stream(k, salt=2)
                                   for k in range(clients)])
    stuck = load.run(seconds)
    if stuck:
        raise RuntimeError(f"{len(stuck)} warm-up clients did not return")
    errs = [r[4] for rs in load.records for r in rs if r[4] is not None]
    if errs:
        raise RuntimeError(f"warm-up request failed: {errs[0]!r}")
    return {"solo_s": {q: [round(x, 4) for x in v] for q, v in warm.items()},
            "load_requests": sum(len(r) for r in load.records),
            "small_probe": probes}


def reference_graph(ds, closure: bool = True,
                    term_id: dict | None = None) -> bgp.Graph:
    return bgp.Graph(ds.terms, ds.predicates, ds.s, ds.p, ds.o,
                     closure=closure, term_id=term_id)


def run(manifest_: dict, cell_name: str, seed: int, seconds: float,
        trace: bool, device: str = "cuda", t_start: float | None = None,
        cfg: dict | None = None, mix: dict | None = None) -> dict:
    """One run; returns the last line's object.  ``cfg`` / ``mix``
    replace the cell's files (tests use small ones)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell_ = manifest.cell(manifest_, cell_name)
    cfg = cfg or manifest.config(manifest_, cell_)
    mix = mix or manifest.mix(cell_)
    on_card = device == "cuda"

    t = time.perf_counter()
    if on_card:
        from repro_torch.kernels import _build

        fresh = [p.name for p in _build.build_all().values()]
        log(f"kernels: {len(fresh)} libraries ready in "
            f"{time.perf_counter() - t:.3f} s under {_build.BUILD_DIR}")
    t = time.perf_counter()
    ds = lubm.generate(cfg, seed)
    log(f"generated {ds.n_triples} triples, {len(ds.terms)} terms in "
        f"{time.perf_counter() - t:.3f} s")
    sys_ = system.build(cfg, mix, ds, device)
    log(f"system: {sys_.phases}")
    traf = traffic.Traffic(mix, ds, seed)
    clients = int(mix["clients"])
    t = time.perf_counter()
    warm = _warm(sys_, mix, traf, clients, float(mix["warmup_s"]))
    log(f"warm-up in {time.perf_counter() - t:.3f} s: {warm}")

    # --- the window
    gc0 = [d["collections"] for d in gc.get_stats()]
    keys0 = sys_.engine.executor.program_keys()
    traced = None
    sched = sys_.scheduler
    if trace:
        from portbench.trace import Traced

        traced = Traced(torch)
        if sched is not None:
            h0 = sched.metrics.batch_size.summary()
    call = system.call_for(sys_, mix)
    load = Clients(clients, call, [traf.stream(k) for k in range(clients)])
    setup = {}

    def opened():
        setup["setup_s"] = time.perf_counter() - t_start
        if traced is not None:
            traced.start()

    stuck = load.run(seconds, on_open=opened)
    rec = traced.stop() if traced is not None else None
    if trace and sched is not None:
        h1 = sched.metrics.batch_size.summary()
        rec["batch_count"] = h1["count"] - h0["count"]
        rec["batch_sum"] = (h1["count"] * (h1["mean_ms"] if h1["count"] else 0)
                            - h0["count"] * (h0["mean_ms"] if h0["count"]
                                             else 0))
    new_programs = len(sys_.engine.executor.program_keys() - keys0)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}

    records = [r for rs in load.records for r in rs]
    done = [r for r in records if r[3] is not None]
    failed = [r for r in records if r[4] is not None]
    in_window = [r for r in done if r[2] <= load.t_close]
    lat_ms = [(r[2] - r[1]) * 1e3 for r in records]
    log(f"window: {len(records)} requests, {len(done)} answered "
        f"({len(in_window)} by the close), {len(failed)} failed, "
        f"{len(stuck)} clients still waiting; {new_programs} chunk programs "
        f"built in the window; peak {peak} B")
    for r in failed[:3]:
        log(f"failed request {r[0].query}: {r[4]!r}")
    by_q: dict[str, list[float]] = {}
    for r in records:
        by_q.setdefault(r[0].query, []).append((r[2] - r[1]) * 1e3)
    log("latency ms by query (n, median, p95): " + ", ".join(
        f"{q} ({len(v)}, {statistics.median(v):.2f}, "
        f"{statistics.quantiles(v, n=20)[18] if len(v) > 1 else v[0]:.2f})"
        for q, v in sorted(by_q.items())))
    edges = np.arange(0.0, seconds + 5.0, 5.0)
    done_at = np.array([r[2] - load.t_open for r in done])
    log(f"answers a second in each 5 s of the window: "
        f"{(np.histogram(done_at, bins=edges)[0] / 5.0).tolist()}")
    log(f"gc collections in the window by generation: "
        f"{[d['collections'] - c for d, c in zip(gc.get_stats(), gc0)]}")

    # --- the program's state goes before the reference runs
    if sched is not None:
        sched.stop()
    maps = sys_.maps
    del sys_, call, load
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    term_id = ds.term_ids()
    ref = reference_graph(ds, term_id=term_id)
    t_graph = time.perf_counter() - t
    checker = Checker(ds, ref, maps, term_id)
    verdict = checker.judge((r[0].text, r[3]) for r in done)
    log(f"reference: graph in {t_graph:.3f} s, {verdict['distinct']} "
        f"distinct answers judged in {time.perf_counter() - t:.3f} s")

    checks = {"wrong_answers": {"value": verdict["wrong"], "limit": 0},
              "failed_requests": {"value": len(failed), "limit": 0},
              "unanswered": {"value": len(stuck), "limit": 0}}
    correct = bool(records) and all(c["value"] <= c["limit"]
                                    for c in checks.values())
    values = {"setup_s": setup["setup_s"],
              "qps": len(in_window) / seconds,
              "p95_ms": (statistics.quantiles(lat_ms, n=20)[18]
                         if len(lat_ms) >= 2 else None)}
    breakdown = None
    if rec is not None:
        from portbench import trace as trace_mod

        rec["queries"] = len(done)
        rec["latencies_ms"] = lat_ms
        dev["busy_s"] = trace_mod.busy_s(rec)
        dev["window_s"] = rec["window_s"]
        for m in manifest.cell_metrics(manifest_, cell_name, True):
            got = manifest.reader(m["name"])(rec)
            values[m["name"]] = None if got is None else got[0]
        breakdown = trace_mod.breakdown(rec)
        log(f"trace: {rec['name_idx'].shape[0]} device events, read in "
            f"{rec['read_s']:.3f} s")
    line = manifest.result_line(
        manifest_, cell_name, trace, values, correct=correct,
        attempted=len(records), failed=len(failed) + len(stuck),
        device=dev, checks=checks, breakdown=breakdown)
    return line
