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
from repro_torch.store import VersionedStore
from repro_torch.rdf.transform import type_aware_transform
from repro_torch.rdf.workloads import LUBM_QUERIES
g, maps = type_aware_transform(generate_lubm(scale=1, seed=0, density=0.3).finalize())
eng = SparqlEngine(g, maps, device="cpu")
assert eng.count(LUBM_QUERIES["Q2"]) > 0
assert eng.query(LUBM_QUERIES["Q9"]).count > 0
store = VersionedStore(g, maps, auto_compact=False)
store.apply_update("INSERT DATA { ub:IsoS ub:advisor ub:IsoO . }")
eng.set_graph(store.snapshot())
assert eng.count(LUBM_QUERIES["Q9"]) > 0
import torch
from repro_torch.kernels import ops
from repro_torch.serve.fingerprint import parameterize_query
tmpl = "SELECT ?x WHERE {{ ?x ub:takesCourse {c} . }}"
pqs = [parameterize_query(tmpl.format(c=f"ub:Course{i}.Dept0.Univ0"))
       for i in range(3)]
fam = eng.compile_param(pqs[0])
assert sum(r.count for r in eng.execute_param_batch(
    fam, [pq.consts for pq in pqs])) > 0
t = torch.ones((4, 2))
i = torch.tensor([0, 5, -1], dtype=torch.int32)
assert ops.segment_gather_sum(t, i, i.abs(), 2).shape == (2, 2)
assert ops.segment_gather_fixed(t, i[None]).shape == (1, 2)
import repro_torch.launch.serve
import repro_torch.launch.sharded
import repro_torch.core.distributed
import repro_torch.core.plan
import repro_torch.core.reference
import repro_torch.rdf.parser
import repro_torch.utils.timing
import repro_torch.obs
import repro_torch.obs.report
from repro_torch.serve.server import DatasetRegistry
from repro_torch.serve.scheduler import Scheduler
reg = DatasetRegistry(device="cpu")
reg.register("lubm", g, maps)
with Scheduler(reg, workers=2, metrics=reg.metrics) as sched:
    res = sched.submit("lubm", LUBM_QUERIES["Q2"], trace=True)
assert res.count > 0 and res.stats["trace"]["root"]["children"]
import tempfile
import repro_torch.configs.common
import repro_torch.configs.dlrm_rm2
import repro_torch.configs.gcn_cora
import repro_torch.configs.gnn_common
import repro_torch.kernels.autograd
import repro_torch.models.gnn.common
import repro_torch.models.gnn.gcn
import repro_torch.models.gnn.sampler
import repro_torch.models.layers
import repro_torch.models.recsys.dlrm
import repro_torch.train.checkpoint
import repro_torch.train.data
import repro_torch.train.loop
import repro_torch.train.optimizer
import repro_torch.train.straggler
import repro_torch.train.trainstep
from repro_torch.launch import train as launch_train
with tempfile.TemporaryDirectory() as d:
    for arch in ("dlrm-rm2", "gcn-cora"):
        tr = launch_train.main(["--arch", arch, "--device", "cpu", "--steps",
                                "2", "--ckpt-dir", d])
        assert tr.ckpt.latest_step() == 2
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
    # chip_smoke.py runs on the card without JAX, with the shared cases
    files = sorted(PKG.rglob("*.py")) + sorted(
        (ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py",
                                           ROOT / "tests" / "torch_cases.py"]
    assert len(files) > 20
    assert PKG / "store" / "versioned.py" in files
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
    from repro_torch.store import VersionedStore

    store = VersionedStore(tg, maps, auto_compact=False)
    store.insert_triples([("ub:IsoS", "ub:advisor", "ub:IsoO")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SparqlEngine(store.snapshot(), maps)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor(store.snapshot())
    eng = SparqlEngine(store.snapshot(), maps, device="cpu")
    assert eng.count("SELECT ?x WHERE { ?x ub:advisor ub:IsoO . }") == 1
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.server import DatasetRegistry

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DatasetRegistry().register("lubm", tg, maps)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DatasetRegistry().register("live", tg, maps, updatable=True)
    reg = DatasetRegistry(device="cpu")
    assert reg.register("lubm", tg, maps).engine.device.type == "cpu"
    # the launcher fails before it builds a dataset
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--dataset", "lubm", "--scale", "1",
                           "--queries", "Q1", "--repeat", "1"])
    from repro_torch.launch import train as launch_train

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.build(launch_train.parse_args(["--arch", "dlrm-rm2"]))
