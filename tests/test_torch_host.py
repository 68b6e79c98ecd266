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


# ------------------------------------------------------------------ parser
NT_LINES = [
    "<http://a> <http://p> <http://b> .",
    'ub:x ub:name "hello world" .',
    'a:s a:p "v"^^<http://int> .',
    'a:s a:p "v"@en .',
    r'a:s a:p "say \"hi\" now" .',
    "# comment",
    "   ",
    "_:b0 a:p a:o.",
    "\ta:s\t a:p a:o  .",
    "a:s a:p a:o",
    "a:s a:p a:o .",  # a duplicate: set semantics
]
NT_BAD = [
    "<unterminated iri-less",
    'a:s a:p "no end',
    "a:s a:p",
    "a:s a:p a:o . trailing",
    'a:s a:p "v"^^<http://int .',
    "a:s a:p .",
]


def _decoded(store):
    store.finalize()
    return (sorted(store.iter_decoded()), store.n_triples,
            len(store.dict.terms), len(store.dict.predicates))


def test_parser_lines_match_reference():
    from repro.rdf import parser as ref_parser
    from repro_torch.rdf import parser

    for i, line in enumerate(NT_LINES + NT_BAD, start=1):
        try:
            want = ref_parser.parse_line(line, i)
        except ref_parser.ParseError as e:
            with pytest.raises(parser.ParseError) as got:
                parser.parse_line(line, i)
            assert str(got.value) == str(e), line
        else:
            assert parser.parse_line(line, i) == want, line


@pytest.mark.parametrize("at", [0, 3, len(NT_LINES)])
@pytest.mark.parametrize("bad", NT_BAD)
def test_parser_strict_and_lenient_match_reference(bad, at):
    """Strict mode raises the reference's ``ParseError`` (with its line
    number); lenient mode skips the line with the reference's
    ``ParseStats`` and store."""
    from repro.rdf import parser as ref_parser
    from repro_torch.rdf import parser

    lines = NT_LINES[:at] + [bad] + NT_LINES[at:]
    with pytest.raises(ref_parser.ParseError) as want:
        ref_parser.parse_ntriples(lines)
    with pytest.raises(parser.ParseError) as got:
        parser.parse_ntriples(lines)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(f"line {at + 1}:")
    store, stats = parser.parse_ntriples(lines, strict=False)
    rstore, rstats = ref_parser.parse_ntriples(lines, strict=False)
    assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
    assert stats.skipped == 1 and stats.lines == len(lines)
    assert _decoded(store) == _decoded(rstore)


def test_parser_serialize_round_trip_matches_reference():
    from repro.rdf import parser as ref_parser
    from repro_torch.rdf import parser

    triples = [("ub:s", "ub:p", "ub:o"), ("http://a", "http://p", '"lit 1"'),
               ("_:b1", "http://p", '"v"@en'), ("x", "ub:q", "y")]
    lines = list(parser.serialize_ntriples(triples))
    assert lines == list(ref_parser.serialize_ntriples(triples))
    store, stats = parser.parse_ntriples(lines)
    rstore, rstats = ref_parser.parse_ntriples(lines)
    assert stats == parser.ParseStats(lines=4, triples=4, skipped=0)
    assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
    assert _decoded(store) == _decoded(rstore)
    assert _decoded(store)[0] == sorted(triples)


# ------------------------------------------------------------------ oracle
@pytest.mark.parametrize("semantics", ["hom", "iso"])
@pytest.mark.parametrize("seed", range(4))
def test_enumerate_matches_matches_reference(seed, semantics):
    """The brute-force oracle on seeded random graphs and query graphs
    (labels, bound ids, predicate variables, cycle edges), both packages
    on the same graph."""
    from conftest import random_labeled_graph, random_query_graph
    from repro.core.reference import enumerate_matches as ref_enumerate
    from repro_torch.convert import _query_from_fields, graph_from_arrays
    from repro_torch.core.reference import enumerate_matches

    rng = np.random.default_rng(100 + seed)
    rg = random_labeled_graph(rng, n_vertices=9, p_edge=0.35)
    g = graph_from_arrays(graph_fields(rg))
    for k in range(3):
        rq = random_query_graph(np.random.default_rng(1000 * seed + k), rg,
                                n_qv=3, with_pvar=k == 2)
        q = _query_from_fields(plan_fields(rq))
        got = enumerate_matches(g, q, semantics)
        assert got == ref_enumerate(rg, rq, semantics), (seed, k)


# ------------------------------------------------------------------ timing
def test_timed_and_timer_match_reference(monkeypatch):
    """``timed`` drops the best and worst of its repeats as the
    reference's does (on the same clock readings), calls the function
    warmup + repeats times, and returns its last result; ``Timer``
    accumulates per span."""
    import repro.utils.timing as ref_timing
    from repro_torch.utils import Timer, timed
    from repro_torch.utils import timing

    ticks = [0.0, 0.5, 1.0, 1.2, 2.0, 2.9, 3.0, 3.1, 4.0, 4.7]
    for mod in (timing, ref_timing):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        calls = []
        res, sec = mod.timed(lambda x: calls.append(x) or len(calls), 7,
                             repeats=5, warmup=2)
        assert (res, len(calls)) == (7, 7)
        # repeats took 0.5, 0.2, 0.9, 0.1, 0.7: the middle three average
        assert sec == pytest.approx((0.5 + 0.7 + 0.2) / 3, abs=1e-12)
        monkeypatch.undo()
    assert timed is timing.timed
    t = Timer()
    for name in ("a", "b", "a"):
        with t.span(name):
            pass
    assert t.counts == {"a": 2, "b": 1}
    assert t.mean("a") >= 0.0 and t.mean("missing") == 0.0
    assert sorted(line.split()[0] for line in t.report().splitlines()) == \
        ["a", "b"]


def test_timed_blocks_on_nested_cuda_results_only():
    """``_block`` finds tensors inside tuples, lists, dicts and dataclass
    fields (an executor ``Result``); CPU tensors need no wait."""
    import torch

    from repro_torch.core.exec import Result
    from repro_torch.utils.timing import _block, _cuda_devices

    cpu = torch.zeros(3)
    res = Result(1, None, None, stats={"t": [cpu, (cpu,)]})
    assert _cuda_devices(({"a": [res]}, cpu, 3, "x"), set()) == set()
    _block(({"a": [res]}, cpu))


# ------------------------------------------------------------------ plan shim
def test_plan_shim_names_resolve_to_the_port_planner():
    import repro.core.plan as ref_shim
    from repro_torch.core import plan as shim
    from repro_torch.core import planner
    from repro_torch.core.planner import builder

    assert shim.__all__ == ref_shim.__all__
    for name in shim.__all__:
        assert getattr(shim, name) is getattr(planner, name), name
    assert shim._np_cmp is planner.np_cmp
    assert shim._nlf_masks is builder._nlf_masks
