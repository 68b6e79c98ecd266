"""Offline workload report: merge profiles, slow-log, and bench traces.

``python -m repro_torch.obs.report`` turns the observability surfaces this
package accumulates at runtime into one reviewable document:

- ``--workload FILE`` — the ``GET /debug/workload`` payload (or a bare
  list of :meth:`WorkloadProfile.snapshot` dicts): worst-misestimated
  shapes, prune wins, kernel mix, degradation and replan history;
- ``--slow FILE`` — the ``GET /debug/slow`` payload: slowest traced
  executions per dataset;
- ``--bench-csv FILE`` — ``benchmarks.run`` CSV output (``name,
  us_per_call,derived``): slowest benchmark entries;
- ``--trace FILE`` — Chrome ``trace_event`` JSON (``--trace-out`` /
  ``/debug/trace?format=chrome``): where the wall time went, by span;
- ``--demo`` — build a small in-process LUBM+BSBM registry on
  ``--device`` (default ``cuda``; ``cpu`` for the plain kernels), drive
  the standard query mix through the scheduler with feedback enabled, and
  report on that (no files needed).

``--format md`` (default) renders GitHub-flavored markdown; ``--format
json`` emits the merged report object.  ``--out FILE`` writes instead of
printing.  The port of ``repro.obs.report``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

__all__ = ["build_report", "render_markdown", "demo_report", "main"]


# --------------------------------------------------------------- loaders
def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _norm_workload(obj) -> dict:
    """Accept the /debug/workload payload or a bare profile list."""
    if isinstance(obj, list):
        return {"profiles": obj, "feedback": {}, "decisions": {}}
    return {"profiles": obj.get("profiles", []),
            "feedback": obj.get("feedback", {}),
            "decisions": obj.get("decisions", {}),
            "feedback_enabled": obj.get("feedback_enabled")}


def _norm_slow(obj) -> dict:
    """Accept the /debug/slow payload ({"slow": {ds: [...]}}) or the bare
    per-dataset mapping."""
    if isinstance(obj, dict) and isinstance(obj.get("slow"), dict):
        return obj["slow"]
    return obj if isinstance(obj, dict) else {}


def _load_bench_csv(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 2 or parts[0] in ("", "name"):
                continue
            try:
                us = float(parts[1])
            except ValueError:
                continue
            rows.append({"name": parts[0], "us_per_call": us,
                         "derived": ",".join(parts[2:]).strip()})
    return rows


# -------------------------------------------------------------- sections
def _misestimated(profiles: list[dict], limit: int = 10) -> list[dict]:
    ranked = sorted(profiles, key=lambda p: p.get("q_error_median", 1.0),
                    reverse=True)
    return [{
        "dataset": p["dataset"], "plan_key": p["plan_key"],
        "runs": p["runs"], "q_error_median": round(p["q_error_median"], 2),
        "q_error_max": round(p.get("q_error_max", 1.0), 2),
        "e2e_q_error_median": round(p.get("e2e_q_error_median", 1.0), 2),
        "replans": p.get("replans", 0),
        "feedback_version": p.get("feedback_version", 0),
        "search": p.get("search"),
    } for p in ranked[:limit] if p.get("q_error_median", 1.0) > 1.0]


def _prune_wins(profiles: list[dict], limit: int = 10) -> list[dict]:
    wins = []
    for p in profiles:
        for i, s in enumerate(p.get("steps", ())):
            ratio = s.get("prune_ratio")
            if ratio:
                wins.append({"dataset": p["dataset"],
                             "plan_key": p["plan_key"], "step": i,
                             "prune_ratio": round(ratio, 3),
                             "runs": p["runs"]})
    wins.sort(key=lambda w: w["prune_ratio"] * w["runs"], reverse=True)
    return wins[:limit]


def _kernel_mix(profiles: list[dict]) -> dict[str, int]:
    mix: dict[str, int] = {}
    for p in profiles:
        for k, v in (p.get("kernels") or {}).items():
            mix[k] = mix.get(k, 0) + int(v)
    return dict(sorted(mix.items(), key=lambda kv: -kv[1]))


def _degradations(profiles: list[dict]) -> list[dict]:
    out = []
    for p in profiles:
        levels = {k: v for k, v in (p.get("degraded") or {}).items()
                  if k not in ("0", 0) and v}
        if levels or p.get("cancels"):
            out.append({"dataset": p["dataset"], "plan_key": p["plan_key"],
                        "degraded_runs": levels,
                        "cancels": p.get("cancels", 0),
                        "retries": p.get("retries", 0)})
    return out


def _replans(profiles: list[dict], feedback: dict) -> dict:
    return {
        "replanned_profiles": [
            {"dataset": p["dataset"], "plan_key": p["plan_key"],
             "replans": p["replans"],
             "feedback_version": p.get("feedback_version", 0),
             "search": p.get("search")}
            for p in profiles if p.get("replans")],
        "engine_feedback": feedback,
    }


def _trace_summary(trace_doc: dict, limit: int = 15) -> list[dict]:
    """Top spans by duration from Chrome trace_event JSON."""
    events = trace_doc.get("traceEvents", []) if isinstance(trace_doc, dict) \
        else []
    spans = [e for e in events if e.get("ph") == "X"]
    spans.sort(key=lambda e: -e.get("dur", 0.0))
    return [{"name": e.get("name"), "ms": round(e.get("dur", 0.0) / 1e3, 3)}
            for e in spans[:limit]]


# --------------------------------------------------------------- report
def build_report(workload: dict | list | None = None,
                 slow: dict | None = None,
                 bench: list[dict] | None = None,
                 trace: dict | None = None) -> dict:
    """Merge the loaded surfaces into one JSON-able report object."""
    report: dict = {}
    if workload is not None:
        wl = _norm_workload(workload)
        profiles = wl["profiles"]
        report["workload"] = {
            "n_profiles": len(profiles),
            "feedback_enabled": wl.get("feedback_enabled"),
            "decisions": wl.get("decisions", {}),
            "misestimated": _misestimated(profiles),
            "prune_wins": _prune_wins(profiles),
            "kernel_mix": _kernel_mix(profiles),
            "degradations": _degradations(profiles),
            "replans": _replans(profiles, wl.get("feedback", {})),
        }
    if slow is not None:
        entries = [{"dataset": ds, **{k: v for k, v in e.items()
                                      if k in ("fingerprint", "wall_ms",
                                               "count", "id")}}
                   for ds, items in _norm_slow(slow).items()
                   for e in items]
        entries.sort(key=lambda e: -e.get("wall_ms", 0.0))
        report["slow_queries"] = entries[:15]
    if bench is not None:
        timed = [r for r in bench if not r["name"].startswith("_meta")]
        timed.sort(key=lambda r: -r["us_per_call"])
        meta = {r["name"]: r for r in bench if r["name"].startswith("_meta")}
        report["bench"] = {
            "n_entries": len(timed),
            "slowest": timed[:15],
            "total_seconds": round(
                meta["_meta.total_seconds"]["us_per_call"] / 1e6, 1)
            if "_meta.total_seconds" in meta else None,
        }
    if trace is not None:
        report["trace_spans"] = _trace_summary(trace)
    return report


# -------------------------------------------------------------- markdown
def _md_table(rows: list[dict], cols: list[str]) -> list[str]:
    if not rows:
        return ["*(none)*", ""]
    out = ["| " + " | ".join(cols) + " |",
           "|" + "|".join("---" for _ in cols) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(r.get(c, "")) for c in cols) + " |")
    out.append("")
    return out


def render_markdown(report: dict) -> str:
    lines = ["# Workload report", ""]
    wl = report.get("workload")
    if wl:
        lines += [f"## Workload profiles ({wl['n_profiles']})", ""]
        if wl.get("decisions"):
            lines += ["Decisions: " + ", ".join(
                f"{k}={v}" for k, v in sorted(wl["decisions"].items())), ""]
        lines += ["### Top misestimated shapes", ""]
        lines += _md_table(wl["misestimated"],
                           ["dataset", "plan_key", "runs", "q_error_median",
                            "q_error_max", "replans", "search"])
        lines += ["### Top prune wins", ""]
        lines += _md_table(wl["prune_wins"],
                           ["dataset", "plan_key", "step", "prune_ratio",
                            "runs"])
        if wl.get("kernel_mix"):
            lines += ["### Kernel mix", ""]
            lines += _md_table([{"kernel": k, "runs": v}
                                for k, v in wl["kernel_mix"].items()],
                               ["kernel", "runs"])
        if wl.get("degradations"):
            lines += ["### Degradations / cancellations", ""]
            lines += _md_table(wl["degradations"],
                               ["dataset", "plan_key", "degraded_runs",
                                "cancels", "retries"])
        rp = wl.get("replans", {})
        if rp.get("replanned_profiles"):
            lines += ["### Feedback replans", ""]
            lines += _md_table(rp["replanned_profiles"],
                               ["dataset", "plan_key", "replans",
                                "feedback_version", "search"])
    if report.get("slow_queries") is not None:
        lines += ["## Slow queries", ""]
        lines += _md_table(report["slow_queries"],
                           ["dataset", "fingerprint", "wall_ms", "count"])
    bench = report.get("bench")
    if bench:
        total = (f" (total {bench['total_seconds']}s)"
                 if bench.get("total_seconds") else "")
        lines += [f"## Bench summary: {bench['n_entries']} entries{total}",
                  ""]
        lines += _md_table(bench["slowest"],
                           ["name", "us_per_call", "derived"])
    if report.get("trace_spans"):
        lines += ["## Trace: slowest spans", ""]
        lines += _md_table(report["trace_spans"], ["name", "ms"])
    return "\n".join(lines)


# ------------------------------------------------------------------ demo
def demo_report(rounds: int = 4, device="cuda") -> dict:
    """Build a small LUBM+BSBM registry on ``device``, drive the standard
    query mix through the scheduler with feedback enabled, and report on
    it."""
    from repro_torch.rdf.generator import generate_bsbm, generate_lubm
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.workloads import BSBM_QUERIES, LUBM_QUERIES
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.server import DatasetRegistry

    registry = DatasetRegistry(feedback=True, feedback_min_runs=3,
                               qerror_threshold=4.0, trace_sample=1.0,
                               device=device)
    for name, store, queries in (
            ("lubm", generate_lubm(scale=1, density=0.5), LUBM_QUERIES),
            ("bsbm", generate_bsbm(n_products=200), BSBM_QUERIES)):
        store.finalize()
        g, maps = type_aware_transform(store)
        registry.register(name, g, maps)
    workloads = {"lubm": LUBM_QUERIES, "bsbm": BSBM_QUERIES}
    scheduler = Scheduler(registry, workers=2,
                          metrics=registry.metrics).start()
    try:
        for _ in range(max(1, rounds)):
            for ds, queries in workloads.items():
                for q in queries.values():
                    with contextlib.suppress(Exception):
                        scheduler.submit(ds, q, timeout_s=120.0)
    finally:
        scheduler.stop()
    return build_report(workload=registry.workload_snapshot(limit=None),
                        slow=registry.slow_summaries())


# ------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Merge workload profiles, slow-log, and bench traces "
                    "into one markdown/JSON report.")
    ap.add_argument("--workload", metavar="FILE",
                    help="GET /debug/workload JSON (or bare profile list)")
    ap.add_argument("--slow", metavar="FILE", help="GET /debug/slow JSON")
    ap.add_argument("--bench-csv", metavar="FILE",
                    help="benchmarks.run CSV output")
    ap.add_argument("--trace", metavar="FILE",
                    help="Chrome trace_event JSON (--trace-out)")
    ap.add_argument("--demo", action="store_true",
                    help="run a small in-process LUBM+BSBM workload with "
                         "feedback enabled and report on it")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="torch device of the --demo registry")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    ap.add_argument("--out", metavar="FILE", help="write instead of print")
    args = ap.parse_args(argv)

    if args.demo:
        report = demo_report(device=args.device)
        if args.bench_csv:
            report.update(build_report(bench=_load_bench_csv(args.bench_csv)))
        if args.trace:
            report.update(build_report(trace=_load_json(args.trace)))
    else:
        if not any((args.workload, args.slow, args.bench_csv, args.trace)):
            ap.error("nothing to report on: pass --workload/--slow/"
                     "--bench-csv/--trace or --demo")
        report = build_report(
            workload=_load_json(args.workload) if args.workload else None,
            slow=_load_json(args.slow) if args.slow else None,
            bench=_load_bench_csv(args.bench_csv) if args.bench_csv else None,
            trace=_load_json(args.trace) if args.trace else None)

    text = (json.dumps(report, indent=2, default=str)
            if args.format == "json" else render_markdown(report))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        try:
            print(text)
        except BrokenPipeError:  # e.g. `report ... | head`
            sys.stderr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
