"""Executor parity: the same plan on the same graph through both executors.

The reference engine plans each workload query; ``repro_torch.convert``
carries its graph and plans across, so this file compares executors only.
Counts, binding rows in order, pvar rows, origins and every per-step
counter must be equal.  The small-plan probe (timing-dependent) is
bypassed on both sides with ``_opts_override``.

Every LUBM/BSBM/hetero query runs under the default ``ExecOpts``.  The
other option sets run the fixed subset ``SUBSET``: Q2, Q8, Q9, Q13 (fused
tree steps, +INT and binary-search non-tree joins, restarts), B1 and B5
(numeric filters, signature probes) and H3/H5 (a triangle's non-tree join
and a predicate-variable step).  Random small graphs with predicate
variables add non-tree checks on a pvar.
"""

from dataclasses import replace

import numpy as np
import pytest

pytest.importorskip("torch")

from conftest import random_labeled_graph, random_query_graph  # noqa: E402

from repro.core import ExecOpts as RefOpts  # noqa: E402
from repro.core import Executor as RefExecutor  # noqa: E402
from repro.core import SparqlEngine as RefEngine  # noqa: E402
from repro.core import build_plan as ref_build_plan  # noqa: E402
from repro.rdf.workloads import (BSBM_QUERIES, HETERO_QUERIES,  # noqa: E402
                                 LUBM_QUERIES)
from repro_torch.convert import (graph_fields, graph_from_arrays,  # noqa: E402
                                 plan_fields, plan_from_fields)
from repro_torch.core import ExecOpts, Executor  # noqa: E402

WORKLOADS = {"lubm": ("lubm_graph", LUBM_QUERIES),
             "bsbm": ("bsbm_graph", BSBM_QUERIES),
             "hetero": ("hetero_graph", HETERO_QUERIES)}
ALL = [(ds, qn) for ds, (_, qs) in WORKLOADS.items() for qn in qs]
SUBSET = [("lubm", "Q2"), ("lubm", "Q8"), ("lubm", "Q9"), ("lubm", "Q13"),
          ("bsbm", "B1"), ("bsbm", "B5"), ("hetero", "H3"), ("hetero", "H5")]

LEGACY = dict(cap_schedule=False, suffix_resume=False, use_fused=False,
              async_chunks=1)
OPT_SETS = {
    "legacy": dict(LEGACY),
    "no_int": dict(use_int=False),
    "no_fused": dict(use_fused=False),
    "no_prune": dict(use_prune=False),
    "iso": dict(semantics="iso"),
    "overflow": dict(init_cap=8, chunk=4),
    "overflow_legacy": dict(init_cap=8, chunk=4, **LEGACY),
}
STAT_KEYS = ("step_rows", "step_kept", "step_retries", "step_prune_in",
             "step_prune_out", "caps", "chunks", "resumes", "compiles",
             "step_kernels")


@pytest.fixture(scope="module")
def worlds(request):
    """Per dataset: the reference graph + engine and the port's graph."""
    cache = {}

    def get(ds):
        if ds not in cache:
            rg, rmaps = request.getfixturevalue(WORKLOADS[ds][0])
            cache[ds] = (rg, RefEngine(rg, rmaps),
                         graph_from_arrays(graph_fields(rg)))
        return cache[ds]

    return get


def _branch_plans(ref_eng, text):
    compiled, _ = ref_eng.compile(text)
    return [(br.plan, [co for co in br.optionals])
            for br in compiled.branches]


def _tiny(plan):
    """A copy with the presizing estimates stripped: tiny capacities force
    overflows."""
    return replace(plan, est_fanout=[], est_expand=[])


def _run_pair(rg, g, rplan, kw, collect="bindings", initial=None,
              executors=None):
    ropts, opts = RefOpts(**kw), ExecOpts(**kw)
    rex, ex = executors if executors is not None else (
        RefExecutor(rg, ropts), Executor(g, opts, device="cpu"))
    plan = plan_from_fields(plan_fields(rplan))
    want = rex.run(rplan, collect=collect, initial=initial,
                   _opts_override=ropts)
    got = ex.run(plan, collect=collect, initial=initial, _opts_override=opts)
    return got, want


def assert_same_result(got, want):
    assert got.count == want.count
    for f in ("bindings", "pvar_bindings", "origins"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.shape == b.shape, f
    assert got.chunks_retried == want.chunks_retried
    for k in STAT_KEYS:
        assert got.stats.get(k) == want.stats.get(k), k


def _check_query(worlds, ds, qn, kw, collect="bindings", tiny=False):
    rg, ref_eng, g = worlds(ds)
    text = WORKLOADS[ds][1][qn]
    execs = (RefExecutor(rg, RefOpts(**kw)),
             Executor(g, ExecOpts(**kw), device="cpu"))
    for plan, optionals in _branch_plans(ref_eng, text):
        if tiny:
            plan = _tiny(plan)
        got, want = _run_pair(rg, g, plan, kw, collect, executors=execs)
        assert_same_result(got, want)
        if collect != "bindings" or want.bindings is None:
            continue
        for co in optionals:
            # the left-join extension run: table input, origins
            nq = co.q_ext.n_vertices
            b0 = np.full((want.count, nq), -1, np.int32)
            b0[:, : want.bindings.shape[1]] = want.bindings
            p0 = np.full((want.count, max(1, len(co.q_ext.pvars))), -1,
                         np.int32)
            p0[:, : want.pvar_bindings.shape[1]] = want.pvar_bindings
            org0 = np.arange(want.count, dtype=np.int32)
            if want.count == 0 or co.plan.unsat:
                continue
            got_o, want_o = _run_pair(rg, g, co.plan, kw,
                                      initial=(b0, p0, org0),
                                      executors=execs)
            assert_same_result(got_o, want_o)


@pytest.mark.parametrize("ds,qn", ALL)
def test_default_opts(worlds, ds, qn):
    _check_query(worlds, ds, qn, {})


@pytest.mark.parametrize("ds,qn", SUBSET)
@pytest.mark.parametrize("opt_set", sorted(OPT_SETS))
def test_opt_sets(worlds, ds, qn, opt_set):
    _check_query(worlds, ds, qn, OPT_SETS[opt_set],
                 tiny=opt_set.startswith("overflow"))


@pytest.mark.parametrize("ds,qn", SUBSET)
def test_count_collect(worlds, ds, qn):
    _check_query(worlds, ds, qn, {}, collect="count")


def test_overflow_resumes_happen(worlds):
    rg, ref_eng, g = worlds("lubm")
    (plan, _), = _branch_plans(ref_eng, LUBM_QUERIES["Q2"])
    got, want = _run_pair(rg, g, _tiny(plan), OPT_SETS["overflow"])
    assert_same_result(got, want)
    assert got.stats["resumes"] > 0 and sum(got.stats["step_retries"]) > 0


@pytest.mark.parametrize("seed", [3, 11, 29, 41])
@pytest.mark.parametrize("opt_set", ["default", "no_int", "iso"])
def test_random_graphs_with_pvars(seed, opt_set):
    rng = np.random.default_rng(seed)
    rg = random_labeled_graph(rng, n_vertices=12, p_edge=0.5)
    q = random_query_graph(rng, rg, n_qv=4, with_pvar=True, p_extra_edge=0.8)
    rplan = ref_build_plan(rg, q)
    g = graph_from_arrays(graph_fields(rg))
    kw = OPT_SETS.get(opt_set, {})
    got, want = _run_pair(rg, g, rplan, kw)
    assert_same_result(got, want)


def test_profiled_run_fills_step_times(worlds):
    rg, ref_eng, g = worlds("lubm")
    (plan, _), = _branch_plans(ref_eng, LUBM_QUERIES["Q2"])
    ex = Executor(g, ExecOpts(), device="cpu")
    tplan = plan_from_fields(plan_fields(plan))
    got = ex.run(tplan, profile=True)
    want = RefExecutor(rg, RefOpts()).run(plan, profile=True)
    assert got.count == want.count
    np.testing.assert_array_equal(got.bindings, want.bindings)
    assert len(got.stats["step_wall_ms"]) == len(plan.steps)
    for k in ("step_rows", "step_kept", "step_prune_in", "step_prune_out"):
        assert got.stats[k] == want.stats[k], k


def test_small_plan_probe_runs_both_configs(worlds):
    rg, ref_eng, g = worlds("bsbm")
    (plan, _), = _branch_plans(ref_eng, BSBM_QUERIES["B1"])
    ex = Executor(g, ExecOpts(), device="cpu")
    tplan = plan_from_fields(plan_fields(plan))
    first = ex.run(tplan)
    want = RefExecutor(rg, RefOpts()).run(plan, _opts_override=RefOpts())
    assert first.count == want.count
    np.testing.assert_array_equal(first.bindings, want.bindings)
    if "small_probe" in first.stats:
        again = ex.run(tplan)
        np.testing.assert_array_equal(again.bindings, want.bindings)


def test_transient_fault_ladder(worlds):
    """An injected OOM-shaped fault is retried and still answers exactly."""
    from repro_torch.resilience import faults

    rg, ref_eng, g = worlds("lubm")
    (plan, _), = _branch_plans(ref_eng, LUBM_QUERIES["Q2"])
    tplan = plan_from_fields(plan_fields(plan))
    want = RefExecutor(rg, RefOpts()).run(plan, _opts_override=RefOpts())
    ex = Executor(g, replace(ExecOpts(), chunk=64), device="cpu")
    with faults.inject("dispatch:oom", times=3, seed=0):
        got = ex.run(tplan)
    assert got.count == want.count
    np.testing.assert_array_equal(np.sort(got.bindings, axis=0),
                                  np.sort(want.bindings, axis=0))
    snap = ex.resilience_snapshot()
    assert snap["fault_retries"] == 3 and snap["escalations"] == 1


def test_cuda_out_of_memory_is_transient(worlds):
    """``torch.cuda.OutOfMemoryError`` takes the retry ladder like the
    reference's RESOURCE_EXHAUSTED."""
    import torch

    from repro_torch.resilience.policy import is_transient_fault

    err = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")
    assert is_transient_fault(err)
    assert not is_transient_fault(ValueError("bad plan"))

    rg, ref_eng, g = worlds("lubm")
    (plan, _), = _branch_plans(ref_eng, LUBM_QUERIES["Q8"])
    tplan = plan_from_fields(plan_fields(plan))
    ex = Executor(g, ExecOpts(), device="cpu")
    real = ex._run_impl
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise err
        return real(*a, **k)

    ex._run_impl = flaky
    got = ex.run(tplan)
    assert got.count == RefExecutor(rg, RefOpts()).run(plan).count
    assert len(calls) >= 2 and ex.resilience_snapshot()["fault_retries"] == 1
