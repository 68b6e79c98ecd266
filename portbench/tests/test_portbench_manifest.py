"""The manifest and the last line: every declared metric in every run.

Runs on the CPU:  python -m pytest portbench/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import manifest, trace  # noqa: E402

MAN = manifest.load(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve_by_name(cell):
    c = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, c)
    assert cfg["name"] == c["config"]
    mix = manifest.mix(c)
    for r in mix["requests"]:
        assert "SELECT" in manifest.query_text(r["query"])
    for tr in (False, True):
        for m in manifest.cell_metrics(MAN, cell, tr):
            if tr:
                assert callable(manifest.reader(m["name"]))


def _expected(cell, trace_):
    """The manifest's own lists, worked out here without the harness."""
    if not trace_:
        return [m["name"] for m in MAN["end_to_end"]
                if cell in m.get("workloads", [cell])]
    e2e = set(_expected(cell, False))
    return [m["name"] for m in MAN["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e
                             else [])]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace_", [False, True])
def test_cell_metrics_are_the_manifests(cell, trace_):
    got = [m["name"] for m in manifest.cell_metrics(MAN, cell, trace_)]
    assert got == _expected(cell, trace_)
    assert got, "every run prints some metric"
    if not trace_:
        assert "setup_s" in got and len(got) >= 2


def _record(with_delta: bool, queries: int = 40) -> dict:
    """A synthetic traced window: kernels of the port's names and of
    torch's, with or without ``delta_merge``; no query names at all."""
    names = ["void (anonymous namespace)::expand_filter_kernel<8>(Args)",
             "void edge_exists_kernel(int const*, int const*)",
             "void superset_probe_kernel<unsigned int>(unsigned int const*)",
             "void at::native::vectorized_elementwise_kernel<4>(int)",
             "Memcpy DtoH (Device -> Pinned)"]
    if with_delta:
        names.append("void (anonymous namespace)::delta_merge_kernel(Args)")
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(names), 2000)
    start = np.cumsum(rng.integers(2_000, 20_000, idx.shape[0]))
    end = start + rng.integers(1_000, 5_000, idx.shape[0])
    return {"window_s": float(end[-1] - start[0]) / 1e9 + 0.01,
            "names": names, "name_idx": idx, "start_ns": start,
            "end_ns": end, "queries": queries,
            "latencies_ms": list(rng.random(50) * 10), "batch_sum": 120.0,
            "batch_count": 20}


def _line(cell, rec, trace_):
    values = {"qps": 10.0, "setup_s": 30.0}
    if trace_:
        for m in manifest.cell_metrics(MAN, cell, True):
            got = manifest.reader(m["name"])(rec)
            values[m["name"]] = None if got is None else got[0]
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 1, "busy_s": trace.busy_s(rec),
           "window_s": rec["window_s"]}
    return manifest.result_line(
        MAN, cell, trace_, values, correct=True, attempted=1, failed=0,
        device=dev, checks={"wrong_answers": {"value": 0, "limit": 0}},
        breakdown=trace.breakdown(rec) if trace_ else None)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("with_delta", [False, True])
@pytest.mark.parametrize("trace_", [False, True])
def test_last_line_holds_every_declared_metric(cell, with_delta, trace_):
    rec = _record(with_delta)
    line = _line(cell, rec, trace_)
    assert manifest.check_line(MAN, cell, trace_, line) == []
    assert list(line)[-1] == "checks"
    text = json.dumps(line)
    assert json.loads(text)["metrics"].keys() == set(
        _expected(cell, trace_))
    if trace_:
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10


def test_assembler_raises_rather_than_drop_a_metric():
    cell = "lubm-50.triangles"
    with pytest.raises(manifest.MissingMetric):
        manifest.result_line(MAN, cell, False, {"qps": 1.0, "setup_s": None},
                             correct=True, attempted=1, failed=0, device={},
                             checks={})
    with pytest.raises(manifest.MissingMetric):
        manifest.result_line(MAN, cell, True, {"device.idle_share": 5.0},
                             correct=True, attempted=1, failed=0, device={},
                             checks={})


def test_names_and_units_keep_to_the_allowed_characters():
    assert manifest.names_ok(MAN) == []
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert 1 <= len(m["unit"]) <= 16
        assert m["better"] in ("lower", "higher")
        if "layer" in m:
            assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_a_new_config_mix_and_metric_need_only_new_files(tmp_path):
    """A later cell adds files and manifest entries; nothing that exists
    changes, and the harness finds the new ones by name."""
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads(json.dumps(MAN))
    cfg = json.loads((base / "configs" / "lubm-50.json").read_text())
    cfg["name"], cfg["universities"] = "lubm-10", 10
    (base / "configs" / "lubm-10.json").write_text(json.dumps(cfg))
    (base / "mixes" / "q9only.json").write_text(json.dumps(
        {"entry": "engine", "clients": 2, "collect": "bindings",
         "requests": [{"query": "Q9", "share": 1}], "warmup_s": 1}))
    (base / "metrics" / "exec.window_s.py").write_text(
        "def read(rec):\n    return rec['window_s'], 's'\n")
    man["configs"].append({"name": "lubm-10", "source": "x",
                           "file": "portbench/configs/lubm-10.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "lubm-10.q9only", "config": "lubm-10",
                             "traffic": "q9only", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "exec.window_s", "unit": "s",
                             "better": "lower", "source": "device_trace",
                             "layer": "executor host loop", "moves": "qps",
                             "workloads": ["lubm-10.q9only"]})
    c = manifest.cell(man, "lubm-10.q9only")
    assert manifest.config(man, c, top=tmp_path)["universities"] == 10
    assert manifest.mix(c, base=base)["requests"][0]["query"] == "Q9"
    names = [m["name"] for m in manifest.cell_metrics(man, c["name"], True)]
    assert names == ["exec.window_s"]
    assert manifest.reader("exec.window_s", base=base)(
        {"window_s": 2.0}) == (2.0, "s")
    # a constant of another class is data too: the generator keeps every
    # class's instances by university
    from portbench import traffic
    from portbench.gen import lubm

    cfg["universities"], cfg["uba"]["departments"] = 2, [2, 2]
    ds = lubm.generate(cfg, 2**31 + 1)
    mix = {"requests": [{"query": "Q7", "share": 1,
                         "const": "ub:FullProfessor"}],
           "universities": {"zipf_s": 1.0}}
    req = next(traffic.Traffic(mix, ds, 2**31 + 1).stream(0))
    assert "ub:FullProfessor" in req.text and "{{const}}" not in req.text
    for old in CELLS:  # the cells that were there print what they did
        for tr in (False, True):
            assert manifest.cell_metrics(man, old, tr) == \
                manifest.cell_metrics(MAN, old, tr)
