"""Sharded execution on the port against the reference.

``GreedyChunker`` must deal exactly as the reference's; ``run_sharded`` over
an 8-rank ``(2, 2, 2)`` gloo mesh of subprocesses must count what the
reference's host executor counts on the same plans; its exits (snapshot,
no candidates or unsat, overflow, a mesh on another device type) are
checked in one process at world size 1; ``engine_chunk_step`` must give the
reference step's count and overflow flag, and summed over chunks, the
port executor's count.  Integer outputs compare exactly.
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.multiprocessing import ProcessRaisedException  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro.core import ExecOpts as RefOpts  # noqa: E402
from repro.core import Executor as RefExecutor  # noqa: E402
from repro.core import build_plan as ref_build_plan  # noqa: E402
from repro.core import build_query_graph as ref_bqg  # noqa: E402
from repro.core.distributed import GreedyChunker as RefChunker  # noqa: E402
from repro.core.distributed import engine_chunk_step as ref_step  # noqa: E402
from repro.core.query import QEdge as RefQEdge  # noqa: E402
from repro.core.query import QueryGraph as RefQueryGraph  # noqa: E402
from repro.core.query import QVertex as RefQVertex  # noqa: E402
from repro.rdf.generator import generate_lubm as ref_generate_lubm  # noqa: E402
from repro.rdf.graph import LabeledGraph as RefGraph  # noqa: E402
from repro.rdf.sparql import parse_sparql as ref_parse  # noqa: E402
from repro.rdf.transform import \
    type_aware_transform as ref_transform  # noqa: E402
from repro.rdf.workloads import LUBM_QUERIES  # noqa: E402
from repro.store import VersionedStore as RefStore  # noqa: E402
from repro_torch.convert import (graph_fields, graph_from_arrays,  # noqa: E402
                                 plan_fields, plan_from_fields)
from repro_torch.core import (ExecOpts, Executor, GreedyChunker,  # noqa: E402
                              build_plan, build_query_graph,
                              engine_chunk_step, run_sharded)
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core.query import QEdge, QueryGraph, QVertex  # noqa: E402
from repro_torch.launch.sharded import free_port, spawn_ranks  # noqa: E402
from repro_torch.rdf.generator import generate_lubm  # noqa: E402
from repro_torch.rdf.graph import LabeledGraph  # noqa: E402
from repro_torch.rdf.sparql import parse_sparql  # noqa: E402
from repro_torch.rdf.transform import type_aware_transform  # noqa: E402
from repro_torch.store import VersionedStore  # noqa: E402

AXES = ("pod", "data", "model")


def _degrees(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    if kind == "zipf":
        return rng.zipf(1.5, n).astype(np.int64)
    return np.full(n, 3, np.int64)  # every load ties


# ----------------------------------------------------------------- chunker
@pytest.mark.parametrize("kind", ["zipf", "ties"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 8, 16])
def test_greedy_chunker_matches_reference(n_shards, kind):
    degree = _degrees(kind, 5000)
    rng = np.random.default_rng(n_shards)
    cands = np.sort(rng.choice(5000, 1200, replace=False)).astype(np.int32)
    got = GreedyChunker(n_shards).partition(cands, degree)
    want = RefChunker(n_shards).partition(cands, degree)
    for g, w, name in zip(got, want, ("chunks", "counts", "loads")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_greedy_chunker_no_candidates(n_shards):
    cands = np.zeros(0, np.int32)
    degree = np.ones(10, np.int64)
    for g, w in zip(GreedyChunker(n_shards).partition(cands, degree),
                    RefChunker(n_shards).partition(cands, degree)):
        np.testing.assert_array_equal(g, w)


def test_greedy_chunker_balance():
    rng = np.random.default_rng(0)
    degree = rng.zipf(1.5, 1000).astype(np.int64)
    cands = np.arange(1000, dtype=np.int32)
    chunks, counts, loads = GreedyChunker(8).partition(cands, degree)
    assert chunks.shape[0] == 8
    assert counts.sum() == 1000
    # LPT guarantee: makespan ≤ max(heaviest single item, 4/3 × ideal)
    est = degree[cands].astype(np.float64) + 1.0
    ideal = est.sum() / 8
    assert loads.max() <= max(est.max(), ideal * 4 / 3) + 1e-9
    # every candidate appears exactly once
    got = np.sort(chunks[chunks >= 0])
    np.testing.assert_array_equal(got, cands)


# ------------------------------------------------------------ reference world
@pytest.fixture(scope="module")
def ref_world():
    """The reference's LUBM graph (scale 1, density 0.3, seed 0), built
    here: a store can grow the maps of the shared session fixture."""
    return ref_transform(
        ref_generate_lubm(scale=1, seed=0, density=0.3).finalize())


def _ref_plans(rg, rmaps, names):
    plans = {}
    for name in names:
        q = ref_bqg(ref_parse(LUBM_QUERIES[name]).where.triples, rmaps)
        plans[name] = ref_build_plan(rg, q)
    return plans


def test_run_sharded_eight_gloo_ranks_match_reference(ref_world):
    """Eight ranks, mesh (pod, data, model) = (2, 2, 2): four data-parallel
    rows, each run by the two ranks that differ on ``model``."""
    rg, rmaps = ref_world
    plans = _ref_plans(rg, rmaps, ("Q2", "Q9", "Q6"))
    ex = RefExecutor(rg, RefOpts())
    want = {k: ex.run(p, collect="count").count for k, p in plans.items()}
    assert not plans["Q6"].steps and all(want.values())
    outs = spawn_ranks(rg, plans, 8, (2, 2, 2), "cpu", timeout=420)
    assert [o["rank"] for o in outs] == list(range(8))
    for o in outs:
        assert o["counts"] == want, o
        assert o["backend"] == "gloo" and o["mesh"] == [2, 2, 2]


def test_spawn_ranks_fails_the_world_on_a_failing_rank(ref_world):
    """A parameterized plan makes every rank's ``run_sharded`` raise: the
    first failure is raised with its traceback, and no rank is left
    running."""
    rg, rmaps = ref_world
    plan = _ref_plans(rg, rmaps, ("Q9",))["Q9"]
    bad = dataclasses.replace(plan_from_fields(plan_fields(plan)), n_params=1)
    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException, match="not a parameterized"):
        spawn_ranks(rg, {"Q9": bad}, 3, (1, 3, 1), "cpu", timeout=120)
    assert time.monotonic() - t0 < 120


# --------------------------------------------------------- world size 1
@pytest.fixture(scope="module")
def mesh1():
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=AXES)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_world(ref_world):
    rg, rmaps = ref_world
    return graph_from_arrays(graph_fields(rg)), rg, rmaps


def test_run_sharded_world_one_every_lubm_query(mesh1, port_world):
    g, rg, rmaps = port_world
    plans = _ref_plans(rg, rmaps, list(LUBM_QUERIES))
    ref_ex = RefExecutor(rg, RefOpts())
    ex = Executor(g, ExecOpts(), device="cpu")
    for name, rp in plans.items():
        want = ref_ex.run(rp, collect="count").count
        assert run_sharded(ex, plan_from_fields(plan_fields(rp)),
                           mesh1) == want, name


def test_run_sharded_no_candidates_or_unsat_is_zero(mesh1, port_world,
                                                    monkeypatch):
    g, rg, rmaps = port_world
    ex = Executor(g, ExecOpts(), device="cpu")
    plan = plan_from_fields(plan_fields(_ref_plans(rg, rmaps, ["Q2"])["Q2"]))
    monkeypatch.setattr(tdist, "build_chunk_fn", _no_chunk_program)
    empty = dataclasses.replace(plan, start_candidates=np.zeros(0, np.int32))
    assert run_sharded(ex, empty, mesh1) == 0
    assert run_sharded(ex, dataclasses.replace(plan, unsat=True), mesh1) == 0


def _no_chunk_program(*args, **kw):
    raise AssertionError("no chunk program may be built on this exit")


def _path_graphs(seed: int, n: int, m: int, n_vlabels: int = 1,
                 drop: float = 0.0):
    """One random graph in both packages: edge label 0 throughout; every
    vertex labeled 0 (and 32 where ``n_vlabels > 32``, except a
    ``drop`` share), so the representative mask (every word's bit 0)
    keeps what carries all of them."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    full = (0, 32) if n_vlabels > 32 else (0,)
    keep = rng.random(n) >= drop
    labels = [full if k else (0,) for k in keep]
    args = (n, src, np.zeros(m, np.int64), dst, 1, labels, n_vlabels)
    return LabeledGraph.build(*args), RefGraph.build(*args)


def _path_plans(g, rg):
    """x0 -e0-> x1 -e0-> x2 -e0-> x3 in the forced forward order, the shape
    ``engine_chunk_step`` runs, in both packages."""
    qs = []
    for vert, edge, graph in ((QVertex, QEdge, QueryGraph),
                              (RefQVertex, RefQEdge, RefQueryGraph)):
        q = graph()
        for i in range(4):
            q.vertices.append(vert(f"v{i}", labels=(0,)))
            q.var_to_vertex[f"v{i}"] = i
        q.edges = [edge(0, 1, 0), edge(1, 2, 0), edge(2, 3, 0)]
        qs.append(q)
    return (build_plan(g, qs[0], estimate="static", force_order=[0, 1, 2, 3],
                       device="cpu"),
            ref_build_plan(rg, qs[1], estimate="static",
                           force_order=[0, 1, 2, 3]))


def test_run_sharded_overflow_falls_back_to_host_loop(mesh1, caplog,
                                                      monkeypatch):
    """A capacity of the smallest power of two over the chunk width
    (``max_cap``) cannot hold the path's later steps: the sharded run
    overflows, warns, and returns the host loop's count (small host
    chunks fit that capacity)."""
    g, rg = _path_graphs(3, 600, 1800)
    plan, rplan = _path_plans(g, rg)
    width = plan.start_candidates.shape[0]
    max_cap = 1 << max(6, (width - 1).bit_length())
    ex = Executor(g, ExecOpts(init_cap=1, max_cap=max_cap, chunk=4),
                  device="cpu")
    runs = []
    host_run = ex.run
    monkeypatch.setattr(ex, "run", lambda *a, **k: runs.append(k)
                        or host_run(*a, **k))
    want = RefExecutor(rg, RefOpts()).run(rplan, collect="count").count
    # the package's loggers do not propagate: listen on the module's own
    tdist.log.addHandler(caplog.handler)
    try:
        assert run_sharded(ex, plan, mesh1) == want
    finally:
        tdist.log.removeHandler(caplog.handler)
    assert len(runs) == 1 and runs[0]["collect"] == "count"
    assert any("overflowed capacity" in r.getMessage()
               for r in caplog.records)


def test_run_sharded_snapshot_runs_host_loop(mesh1, monkeypatch):
    """A live-store snapshot executor answers through ``executor.run``, as
    the reference routes it; the count equals the reference store's."""
    update = ("INSERT DATA { ub:ShardS rdf:type ub:GraduateStudent . "
              "ub:ShardS ub:takesCourse ub:GraduateCourse0.Dept0.Univ0 . "
              "ub:ShardS ub:memberOf ub:Dept0.Univ0 . }")
    rg, rmaps = ref_transform(
        ref_generate_lubm(scale=1, seed=0, density=0.3).finalize())
    g, maps = type_aware_transform(
        generate_lubm(scale=1, seed=0, density=0.3).finalize())
    rstore = RefStore(rg, rmaps, auto_compact=False)
    store = VersionedStore(g, maps, auto_compact=False)
    rstore.apply_update(update)
    store.apply_update(update)
    ex = Executor(store.snapshot(), ExecOpts(), device="cpu")
    rex = RefExecutor(rstore.snapshot(), RefOpts())
    monkeypatch.setattr(tdist, "build_chunk_fn", _no_chunk_program)
    for name in ("Q1", "Q2", "Q9"):
        text = LUBM_QUERIES[name]
        plan = build_plan(store.snapshot(), build_query_graph(
            parse_sparql(text).where.triples, maps), device="cpu")
        rplan = ref_build_plan(rstore.snapshot(), ref_bqg(
            ref_parse(text).where.triples, rmaps))
        want = rex.run(rplan, collect="count").count
        assert run_sharded(ex, plan, mesh1) == want == \
            ex.run(plan, collect="count").count, name


def test_run_sharded_mesh_device_mismatch_raises(mesh1, port_world):
    g, rg, rmaps = port_world
    ex = Executor(g, ExecOpts(), device="cpu")
    plan = plan_from_fields(plan_fields(_ref_plans(rg, rmaps, ["Q9"])["Q9"]))
    cuda_mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=AXES)
    with pytest.raises(ValueError, match="cuda mesh cannot drive"):
        run_sharded(ex, plan, cuda_mesh)
    with pytest.raises(ValueError, match="collects counts"):
        run_sharded(ex, plan, mesh1, collect="bindings")


# -------------------------------------------------------- engine_chunk_step
def _step_inputs(g, n_steps: int = 3):
    nbr = g.out.nbr_el.astype(np.int32)
    iptr = np.stack([g.out.indptr_el[0]] * n_steps).astype(np.int32)
    return nbr, iptr, g.label_bitmap


def _both_steps(g, cands, width, cap, n_steps=3):
    """The port's and the reference's step on one chunk: ((count, ovf),
    (count, ovf)) as Python values."""
    nbr, iptr, bm = _step_inputs(g, n_steps)
    chunk = np.full(width, -1, np.int32)
    chunk[: len(cands)] = cands
    c, o = engine_chunk_step(
        torch.from_numpy(nbr), torch.from_numpy(iptr),
        torch.from_numpy(bm.view(np.int32)), torch.from_numpy(chunk),
        torch.tensor(len(cands), dtype=torch.int32), cap=cap,
        n_steps=n_steps)
    assert c.dtype == torch.int32 and o.dtype == torch.bool
    rc, ro = ref_step(jnp.asarray(nbr), jnp.asarray(iptr), jnp.asarray(bm),
                      jnp.asarray(chunk), jnp.int32(len(cands)), cap=cap,
                      n_steps=n_steps)
    return (int(c), bool(o)), (int(rc), bool(ro))


def test_engine_chunk_step_matches_reference_and_executor():
    """The reference test's graph (seed 5, 30 vertices, 200 edges): the
    step equals the reference step and both executors' path count."""
    g, rg = _path_graphs(5, 30, 200)
    plan, rplan = _path_plans(g, rg)
    host = Executor(g, ExecOpts(), device="cpu").run(
        plan, collect="count").count
    rhost = RefExecutor(rg, RefOpts()).run(rplan, collect="count").count
    got, want = _both_steps(g, plan.start_candidates, 64, 1 << 15)
    assert got == want == (host, False) and host == rhost


@pytest.mark.parametrize("cap,overflow", [(1 << 15, False), (2048, True)])
def test_engine_chunk_step_larger_graph_matches_reference(cap, overflow):
    """5000 vertices, 15000 edges, two label words and a tenth of the
    vertices missing label 32: chunk by chunk equal to the reference step
    (in its overflow too, where both truncate each step at ``cap``)."""
    g, _ = _path_graphs(11, 5000, 15000, n_vlabels=40, drop=0.1)
    cands = np.arange(5000, dtype=np.int32)
    flags = []
    for lo in range(0, 5000, 1024)[:3]:
        got, want = _both_steps(g, cands[lo:lo + 1024], 1024, cap)
        assert got == want, lo
        flags.append(got[1])
    assert any(flags) == overflow


def test_engine_chunk_step_chunks_sum_to_executor_count():
    """Summed over chunks of the start-candidate set, the step's count is
    the port executor's path count (and the reference's)."""
    g, rg = _path_graphs(7, 3000, 7000)
    plan, rplan = _path_plans(g, rg)
    host = Executor(g, ExecOpts(), device="cpu").run(
        plan, collect="count").count
    rhost = RefExecutor(rg, RefOpts()).run(rplan, collect="count").count
    nbr, iptr, bm = (torch.from_numpy(a.view(np.int32))
                     for a in _step_inputs(g))
    cands = torch.from_numpy(plan.start_candidates)
    total = 0
    for lo in range(0, cands.shape[0], 512):
        part = cands[lo:lo + 512]
        chunk = torch.full((512,), -1, dtype=torch.int32)
        chunk[: part.shape[0]] = part
        c, o = engine_chunk_step(nbr, iptr, bm, chunk, part.shape[0],
                                 cap=1 << 14, n_steps=3)
        assert not bool(o)
        total += int(c)
    assert total == host == rhost


def test_engine_chunk_step_rejects_a_chunk_over_capacity():
    g, _ = _path_graphs(5, 30, 200)
    nbr, iptr, bm = (torch.from_numpy(a.view(np.int32))
                     for a in _step_inputs(g))
    with pytest.raises(ValueError, match="exceeds the capacity"):
        engine_chunk_step(nbr, iptr, bm,
                          torch.zeros(65, dtype=torch.int32), 65, cap=64,
                          n_steps=3)
