"""Host-layer parity: the port's numpy copies against the reference.

The copied generator and transform must yield the same arrays and id maps,
the copied statistics, signature index and summary graph the same tables,
and the copied planner the same plan for every workload query: order,
steps, masks, start candidates, capacity schedule and ``signature()``.
The port's planner runs its signature prune probe on the CPU here.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.index import get_index as ref_get_index  # noqa: E402
from repro.index import get_summary as ref_get_summary  # noqa: E402
from repro.stats import get_stats as ref_get_stats  # noqa: E402
from repro_torch.convert import graph_fields, plan_fields  # noqa: E402
from repro_torch.index import get_index, get_summary  # noqa: E402
from repro_torch.rdf import generator as tgen  # noqa: E402
from repro_torch.rdf.transform import type_aware_transform  # noqa: E402
from repro_torch.rdf.workloads import (BSBM_QUERIES, HETERO_QUERIES,  # noqa: E402
                                       LUBM_QUERIES)
from repro_torch.stats import get_stats  # noqa: E402

# the conftest.py fixture sizes
DATASETS = {
    "lubm": (lambda m: m.generate_lubm(scale=1, seed=0, density=0.3),
             LUBM_QUERIES, "lubm_graph"),
    "bsbm": (lambda m: m.generate_bsbm(n_products=150, seed=1),
             BSBM_QUERIES, "bsbm_graph"),
    "hetero": (lambda m: m.generate_hetero(n_entities=400, n_types=12,
                                           n_predicates=8, avg_degree=4.0,
                                           seed=2),
               HETERO_QUERIES, "hetero_graph"),
}


def assert_same(a, b, path="") -> None:
    """Recursive equality over dataclasses, containers and numpy arrays;
    private (``_``) and back-reference (``graph``) fields are skipped."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            if f.name.startswith("_") or f.name == "graph":
                continue
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert type(a).__name__ == type(b).__name__ and a == b, \
            f"{path}: {a!r} != {b!r}"


@pytest.fixture(scope="module")
def port_graphs():
    cache = {}

    def get(name):
        if name not in cache:
            st = DATASETS[name][0](tgen).finalize()
            cache[name] = (st, *type_aware_transform(st))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(DATASETS))
def test_generator_and_transform(name, port_graphs, request):
    import repro.rdf.generator as rgen

    st, g, maps = port_graphs(name)
    ref_st = DATASETS[name][0](rgen).finalize()
    for f in ("s", "p", "o"):
        np.testing.assert_array_equal(getattr(st, f), getattr(ref_st, f))
    assert_same(st.dict, ref_st.dict)
    rg, rmaps = request.getfixturevalue(DATASETS[name][2])
    assert_same(graph_fields(g), graph_fields(rg))
    for f in ("vertex_to_term", "elabel_to_pred"):
        np.testing.assert_array_equal(getattr(maps, f), getattr(rmaps, f))
    for f in ("term_to_vertex", "pred_to_elabel", "class_term_to_vlabel"):
        assert getattr(maps, f) == getattr(rmaps, f)
    assert maps.kind == rmaps.kind


@pytest.mark.parametrize("name", list(DATASETS))
def test_stats_and_indexes(name, port_graphs, request):
    _, g, _ = port_graphs(name)
    rg, _ = request.getfixturevalue(DATASETS[name][2])
    assert_same(get_stats(g), ref_get_stats(rg))
    idx, ridx = get_index(g), ref_get_index(rg)
    assert idx.n_bits == ridx.n_bits
    np.testing.assert_array_equal(idx.sig, ridx.sig)
    summ, rsumm = get_summary(g), ref_get_summary(rg)
    assert (summ is None) == (rsumm is None)
    if summ is not None:
        assert_same(summ, rsumm)


@pytest.fixture(scope="module")
def engines(port_graphs):
    """(port engine on the CPU, reference engine) per dataset; planning
    goes through each engine's own compile path (UNION branches and
    OPTIONAL extension plans included)."""
    from repro.core import SparqlEngine as RefEngine
    from repro_torch.core import SparqlEngine

    cache = {}

    def get(name, request):
        if name not in cache:
            _, g, maps = port_graphs(name)
            rg, rmaps = request.getfixturevalue(DATASETS[name][2])
            cache[name] = (SparqlEngine(g, maps, device="cpu"),
                           RefEngine(rg, rmaps))
        return cache[name]

    return get


def _plans(compiled) -> list:
    out = []
    for br in compiled.branches:
        out.append(br.plan)
        out.extend(co.plan for co in br.optionals)
    return out


QUERIES = [(name, qn) for name, (_, qs, _) in DATASETS.items() for qn in qs]


@pytest.mark.parametrize("name,qname", QUERIES)
def test_planner_same_plan(name, qname, engines, request):
    eng, ref_eng = engines(name, request)
    text = DATASETS[name][1][qname]
    plans = _plans(eng.compile(text)[0])
    ref_plans = _plans(ref_eng.compile(text)[0])
    assert len(plans) == len(ref_plans) > 0
    for plan, rplan in zip(plans, ref_plans):
        got, want = plan_fields(plan), plan_fields(rplan)
        got.pop("build_ms")
        want.pop("build_ms")
        assert_same(got, want)
        assert plan.signature() == rplan.signature()
        for chunk in (1, 64, 8192):
            assert plan.capacity_schedule(chunk, 4096, 1 << 22) == \
                rplan.capacity_schedule(chunk, 4096, 1 << 22)
