"""The manifest (``BENCHMARK.json``) and what it says of one cell.

Everything a cell needs is found by name: its configuration's file is the
manifest's ``file`` entry, its traffic is ``mixes/<traffic>.json``, its
queries ``queries/<name>.rq``, and each per-layer metric is read by
``metrics/<metric>.py``.  :func:`cell_metrics` says which metrics a run
of a cell prints, and :func:`result_line` builds the run's last line and
refuses to leave out any of them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def root() -> Path:
    """The checkout's root: the directory that holds ``BENCHMARK.json``."""
    return HERE.parent


def load(path: Path | None = None) -> dict:
    return json.loads((path or root() / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(manifest: dict, cell_: dict, top: Path | None = None) -> dict:
    """The cell's deployment, read from the manifest's ``file`` for it
    (relative to ``top``, the checkout's root by default)."""
    for c in manifest["configs"]:
        if c["name"] == cell_["config"]:
            return json.loads(((top or root()) / c["file"]).read_text())
    raise KeyError(f"no config {cell_['config']!r} in BENCHMARK.json")


def mix(cell_: dict, base: Path = HERE) -> dict:
    return json.loads((base / "mixes" / f"{cell_['traffic']}.json")
                      .read_text())


def query_text(name: str, base: Path = HERE) -> str:
    return (base / "queries" / f"{name}.rq").read_text()


def reader(metric: str, base: Path = HERE):
    """The ``read(record)`` function of ``metrics/<metric>.py`` under
    ``base`` (this folder by default)."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell_metrics(manifest: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` prints: the end-to-end ones with
    ``trace`` false, the per-layer ones with it true; in manifest order.
    A per-layer metric without ``workloads`` is printed wherever the
    end-to-end metric it moves is."""
    cell(manifest, cell_name)
    if not trace:
        return [m for m in manifest["end_to_end"]
                if _applies(m, cell_name)]
    e2e = {m["name"] for m in manifest["end_to_end"]
           if _applies(m, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


class MissingMetric(RuntimeError):
    """A declared metric had no value: the run prints no result."""


def result_line(manifest: dict, cell_name: str, trace: bool,
                values: dict[str, float | None], *, correct: bool,
                attempted: int, failed: int, device: dict, checks: dict,
                breakdown: dict | None = None) -> dict:
    """The run's last line.  ``values`` maps metric names to numbers;
    every metric :func:`cell_metrics` lists must have one, or this raises
    :class:`MissingMetric` (a metric left out is a malformed line)."""
    metrics = {}
    for m in cell_metrics(manifest, cell_name, trace):
        v = values.get(m["name"])
        if v is None:
            raise MissingMetric(f"{m['name']} has no value in a "
                                f"{'traced' if trace else 'timed'} run of "
                                f"{cell_name}")
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if trace and breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def check_line(manifest: dict, cell_name: str, trace: bool,
               line: dict) -> list[str]:
    """What is wrong with a printed last line, as messages (empty when it
    keeps to the manifest)."""
    bad = []
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        if key not in line:
            bad.append(f"no {key!r}")
    want = {m["name"]: m["unit"]
            for m in cell_metrics(manifest, cell_name, trace)}
    got = line.get("metrics", {})
    for name, unit in want.items():
        if name not in got:
            bad.append(f"metrics lacks {name}")
        elif got[name].get("unit") != unit:
            bad.append(f"{name}: unit {got[name].get('unit')!r}, not {unit!r}")
        elif not isinstance(got[name].get("value"), (int, float)):
            bad.append(f"{name}: no number")
    for name in got:
        if name not in want:
            bad.append(f"metrics has {name}, which the manifest does not "
                       f"declare for this run")
    dev = line.get("device", {})
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        if key not in dev:
            bad.append(f"device lacks {key}")
    if trace:
        busy, window = dev.get("busy_s"), dev.get("window_s")
        if not (isinstance(busy, (int, float)) and isinstance(
                window, (int, float)) and 0 < busy <= window):
            bad.append(f"device busy_s {busy} / window_s {window}")
    for name, m in got.items():
        if name.endswith("_roofline") and not 0 < m.get("value", 0) <= 100:
            bad.append(f"{name} reads {m.get('value')}")
    return bad


def names_ok(manifest: dict) -> list[str]:
    """Names and units outside the allowed characters, as messages."""
    bad = []
    names = [c["name"] for c in manifest["configs"]]
    names += [w["name"] for w in manifest["workloads"]]
    names += [w[k] for w in manifest["workloads"] for k in ("config",
                                                            "traffic")]
    names += [m["name"] for m in manifest["end_to_end"]
              + manifest["per_layer"]]
    names += [k for c in manifest["configs"] for k in c["reduced"]]
    bad += [f"name {n!r}" for n in names if not NAME.match(n)]
    bad += [f"unit {m['unit']!r}" for m in manifest["end_to_end"]
            + manifest["per_layer"] if not UNIT.match(m["unit"])]
    return bad
