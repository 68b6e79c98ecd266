"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points never carry on on the CPU unless asked to."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def test_import_and_cpu_query_load_no_jax_or_reference():
    code = """
import sys
from repro_torch.core import SparqlEngine
from repro_torch.rdf.generator import generate_lubm
from repro_torch.rdf.transform import type_aware_transform
from repro_torch.rdf.workloads import LUBM_QUERIES
g, maps = type_aware_transform(generate_lubm(scale=1, seed=0, density=0.3).finalize())
eng = SparqlEngine(g, maps, device="cpu")
assert eng.count(LUBM_QUERIES["Q2"]) > 0
assert eng.query(LUBM_QUERIES["Q9"]).count > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] == "repro" or m.startswith("jax")
             or m.startswith("jaxlib"))
print("LOADED", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_no_source_imports_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.MULTILINE)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []


def test_entry_points_raise_without_cuda(lubm_graph, monkeypatch):
    from repro_torch.convert import graph_fields, graph_from_arrays
    from repro_torch.core import DeviceGraph, Executor, SparqlEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rg, _ = lubm_graph
    g = graph_from_arrays(graph_fields(rg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor(g)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceGraph.from_graph(g)
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.rdf.transform import type_aware_transform

    tg, maps = type_aware_transform(
        generate_lubm(scale=1, seed=0, density=0.3).finalize())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SparqlEngine(tg, maps)
    assert SparqlEngine(tg, maps, device="cpu").device.type == "cpu"
