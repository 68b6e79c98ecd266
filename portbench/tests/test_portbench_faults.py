"""The correctness check against broken programs and its control.

Each case drives a whole run on the CPU at a small size (the look for a
card skipped), with the port's timed path broken underneath, and expects
``correct`` to come out false; a sound run at the same size comes out
true.  The control (the reference with one of the deployment's
guarantees broken) has to read above the limit of 0 on every seed.

Runs on the CPU:  python -m pytest portbench/tests -q
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import bench, manifest  # noqa: E402
from portbench.control import control_reading  # noqa: E402

MAN = manifest.load(ROOT / "BENCHMARK.json")
# the anchored mix, which goes through the Scheduler's family batches, has
# no cell in the manifest yet; its path is held to the same check here
MAN["workloads"].append({"name": "lubm-50.anchored", "config": "lubm-50",
                         "traffic": "anchored", "chips": 1})


def _small(cell):
    c = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, c)
    cfg["universities"] = 1
    cfg["uba"]["departments"] = [2, 2]
    mix = manifest.mix(c)
    mix["warmup_s"] = 0.5
    mix["clients"] = min(mix["clients"], 8)
    return cfg, mix


def _run(cell, seed=2**31 + 21):
    cfg, mix = _small(cell)
    return bench.run(MAN, cell, seed, 1.5, False, device="cpu", cfg=cfg,
                     mix=mix)


def _alter_answers(monkeypatch):
    """An answer altered where it is produced: the engine's last row of
    every non-empty answer binds another vertex."""
    from repro_torch.core import sparql_exec

    orig = sparql_exec.SparqlEngine._finish_param
    orig_exec = sparql_exec.SparqlEngine.execute_compiled

    def bend(res):
        if res.rows.shape[0]:
            res.rows = res.rows.copy()
            res.rows[-1, 0] = (res.rows[-1, 0] + 1) % 1000
        return res

    monkeypatch.setattr(sparql_exec.SparqlEngine, "execute_compiled",
                        lambda self, *a, **k: bend(orig_exec(self, *a, **k)))
    monkeypatch.setattr(sparql_exec.SparqlEngine, "_finish_param",
                        lambda self, *a, **k: bend(orig(self, *a, **k)))


def _half_batch(monkeypatch):
    """Half of a family batch left out: its second half answered with the
    first half's results."""
    from repro_torch.core import sparql_exec

    orig = sparql_exec.SparqlEngine.execute_param_batch

    def half(self, family, const_rows, *a, **k):
        rows = list(const_rows)
        keep = rows[:max(1, (len(rows) + 1) // 2)]
        out = orig(self, family, keep, *a, **k)
        return [out[i % len(out)] for i in range(len(rows))]

    monkeypatch.setattr(sparql_exec.SparqlEngine, "execute_param_batch",
                        half)


FAULTS = {"altered_answer": _alter_answers, "half_batch": _half_batch}
CASES = [("lubm-50.triangles", "altered_answer"),
         ("lubm-50.anchored", "altered_answer"),
         ("lubm-50.anchored", "half_batch")]


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_program_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    line = _run(cell)
    assert not line["correct"], (fault, line["checks"])
    assert line["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_control_reads_above_the_limit(cell):
    c = manifest.cell(MAN, cell)
    cfg, mix = manifest.config(MAN, c), manifest.mix(c)
    cfg["universities"] = 2
    for seed in (3, 2**31 + 7, 2**32 + 1):
        got = control_reading(MAN, cell, seed, 300, cfg=cfg, mix=mix)
        assert got["wrong_answers"] > 0, got


def test_exact_check_has_limit_zero():
    line = _run("lubm-50.triangles")
    assert {c["limit"] for c in line["checks"].values()} == {0}
    assert json.loads(json.dumps(line))["checks"]["wrong_answers"][
        "value"] == 0
    assert np.isfinite(line["metrics"]["qps"]["value"])
