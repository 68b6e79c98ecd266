"""Live-store parity: ``repro_torch.store`` against ``repro.store``.

Both packages build their own ``VersionedStore`` from the same triples (or
the same graph), apply the same seeded stream of inserts and deletes, and
answer on their own engines, the port's on the CPU.  Integer outputs must be
equal: parsed updates, materialized delta arrays, the snapshot's host
interface, counts, binding rows in order, count mode, compile counts,
patched statistics after ``compact()``.  The executors' timing-dependent
small-plan probe is switched off on both sides so their compile counts are
deterministic; it never changes results.
"""

import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from conftest import random_labeled_graph  # noqa: E402

import repro.core.exec as rexec  # noqa: E402
import repro_torch.core.exec as texec  # noqa: E402
from repro.core import SparqlEngine as RefEngine  # noqa: E402
from repro.index import signature_rows as r_signature_rows  # noqa: E402
from repro.rdf import generator as rgen  # noqa: E402
from repro.rdf.transform import type_aware_transform as r_transform  # noqa: E402
from repro.rdf.triples import TripleStore as RTripleStore  # noqa: E402
from repro.rdf.workloads import BSBM_QUERIES, LUBM_QUERIES  # noqa: E402
from repro.resilience import faults as rfaults  # noqa: E402
from repro.stats import get_stats as r_get_stats  # noqa: E402
from repro.store import UpdateError as RUpdateError  # noqa: E402
from repro.store import VersionedStore as RStore  # noqa: E402
from repro.store import parse_update as r_parse_update  # noqa: E402
from repro_torch.convert import graph_fields, graph_from_arrays  # noqa: E402
from repro_torch.core import SparqlEngine  # noqa: E402
from repro_torch.index import signature_rows  # noqa: E402
from repro_torch.rdf.transform import type_aware_transform  # noqa: E402
from repro_torch.rdf.triples import TripleStore  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402
from repro_torch.stats import get_stats  # noqa: E402
from repro_torch.store import UpdateError, VersionedStore, parse_update  # noqa: E402

Q_ADVISOR = "SELECT ?x ?y WHERE { ?x <ub:advisor> ?y . }"
MIX = ("Q1", "Q2", "Q6", "Q9", "Q14")


@pytest.fixture(autouse=True)
def no_small_probe(monkeypatch):
    monkeypatch.setattr(rexec, "_small_plan", lambda plan, opts: False)
    monkeypatch.setattr(texec, "_small_plan", lambda plan, opts: False)


# ---------------------------------------------------------- update parser
UPDATES = [
    """PREFIX ub: <http://example.org/univ#>
       INSERT DATA { ub:s1 ub:knows ub:s2 . ub:s1 a ub:Student }
       DELETE DATA { ub:s1 ub:age "25" . }""",
    """INSERT DATA {
       <http://a> <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> <http://C> .
       <http://a> <http://p> 42 . <http://a> <http://q> "x y"@en }""",
    "INSERT DATA { ub:a ub:p ub:b } . DELETE DATA { ub:a ub:p ub:c . } .",
]
BAD_UPDATES = ["SELECT ?x WHERE { ?x ?p ?o }", "INSERT DATA { ?x ub:p ub:o }",
               "INSERT { ub:a ub:p ub:o }", "", "INSERT DATA { ub:a ub:p",
               "DELETE DATA { ub:a ub:p 'x }",
               "INSERT DATA { ub:a ub:p ub:b } ; DELETE DATA { ub:a ub:p ub:c }"]


@pytest.mark.parametrize("text", UPDATES)
def test_parse_update_matches_reference(text):
    got = [(op.action, op.triples) for op in parse_update(text)]
    want = [(op.action, op.triples) for op in r_parse_update(text)]
    assert got == want


@pytest.mark.parametrize("text", BAD_UPDATES)
def test_parse_update_rejects_what_the_reference_rejects(text):
    with pytest.raises(RUpdateError) as want:
        r_parse_update(text)
    with pytest.raises(UpdateError) as got:
        parse_update(text)
    assert str(got.value) == str(want.value)


# ------------------------------------------ delta arrays + snapshot host API
def _graph_ops(seed):
    """A random graph (reference and port copies) and a seeded list of
    graph-level store operations over it."""
    rng = np.random.default_rng(seed)
    rg = random_labeled_graph(rng, n_vertices=20, n_elabels=3, n_vlabels=4,
                              p_edge=0.3)
    ops = [("add_vertex", (1,)), ("add_vertex", ())]
    for _ in range(40):
        s, o = (int(x) for x in rng.integers(0, 22, 2))
        el = int(rng.integers(0, 5))  # labels 3, 4 are born in the delta
        ops.append(("insert" if rng.random() < 0.6 else "delete",
                    (s, el, o)))
    ops.append(("labels", (3, (0, 2))))
    # delete some base edges for certain
    src = np.repeat(np.arange(rg.n_vertices), np.diff(rg.out.indptr_all))
    for i in rng.choice(src.shape[0], size=6, replace=False):
        ops.append(("delete", (int(src[i]), int(rg.out.lab_all[i]),
                               int(rg.out.nbr_all[i]))))
    return rg, graph_from_arrays(graph_fields(rg)), ops


def _apply(store, ops):
    for kind, arg in ops:
        if kind == "add_vertex":
            store.add_vertex(labels=arg)
        elif kind == "insert":
            store.insert_edges([arg])
        elif kind == "delete":
            store.delete_edges([arg])
        else:
            store.set_vertex_labels(*arg)
    return store.snapshot()


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_materialize_and_snapshot_host_interface(seed):
    rg, g, ops = _graph_ops(seed)
    rsnap = _apply(RStore(rg, auto_compact=False), ops)
    snap = _apply(VersionedStore(g, auto_compact=False), ops)
    assert (snap.n_vertices, snap.n_elabels, snap.n_edges, snap.version) == \
        (rsnap.n_vertices, rsnap.n_elabels, rsnap.n_edges, rsnap.version)
    for name, coo in rsnap.coo.items():
        for f in ("el", "key", "nbr"):
            np.testing.assert_array_equal(getattr(snap.coo[name], f),
                                          getattr(coo, f), err_msg=name)
        np.testing.assert_array_equal(snap.coo[name].plain_rows(24)[1],
                                      coo.plain_rows(24)[1])
    np.testing.assert_array_equal(snap.out.degree, rsnap.out.degree)
    np.testing.assert_array_equal(snap.inc.degree, rsnap.inc.degree)
    np.testing.assert_array_equal(snap.label_bitmap, rsnap.label_bitmap)
    for el in range(snap.n_elabels):
        for got, want in zip(snap.predicate_index(el),
                             rsnap.predicate_index(el)):
            np.testing.assert_array_equal(got, want)
    for labels in ([], [0], [1], [0, 2], [3], [1, 3]):
        np.testing.assert_array_equal(snap.candidates_with_labels(labels),
                                      rsnap.candidates_with_labels(labels))
    # the signature index's snapshot branch: the conservative overlay rows
    np.testing.assert_array_equal(signature_rows(snap),
                                  r_signature_rows(rsnap))


# ----------------------------------------------------- stream equivalence
def _split_stream(triples, rng, frac_base=0.75, n_dels=40):
    onto = [t for t in triples if t[1] in ("rdf:type", "rdf:subClassOf")]
    plain = [t for t in triples if t[1] not in ("rdf:type", "rdf:subClassOf")]
    idx = rng.permutation(len(plain))
    n_base = int(len(plain) * frac_base)
    base = onto + [plain[i] for i in idx[:n_base]]
    ins = [plain[i] for i in idx[n_base:]]
    dels = [plain[idx[i]] for i in
            rng.choice(n_base, size=min(n_dels, n_base), replace=False)]
    return base, ins, dels


def _stores(base):
    """(reference store, maps), (port store, maps) over the same triples,
    with base statistics built so compaction patches them."""
    out = []
    for ts, transform, store_cls, stats in (
            (RTripleStore, r_transform, RStore, r_get_stats),
            (TripleStore, type_aware_transform, VersionedStore, get_stats)):
        st_ = ts()
        st_.add_many(base)
        g, maps = transform(st_.finalize())
        stats(g)
        out.append((store_cls(g, maps, auto_compact=False), maps))
    return out


def _same_answers(eng, ref, queries):
    """Rows in order and counts equal the reference's, and the port's count
    mode equals them too (the reference's own tests hold its count mode to
    its rows)."""
    for name, q in queries.items():
        got, want = eng.query(q), ref.query(q)
        assert got.variables == want.variables, name
        assert got.count == want.count, name
        np.testing.assert_array_equal(got.rows, want.rows, err_msg=name)
        assert eng.count(q) == want.count, name


@pytest.mark.parametrize("ds,seed,compact", [("lubm", 1, False),
                                             ("lubm", 1, True),
                                             ("lubm", 7, False),
                                             ("bsbm", 11, False),
                                             ("bsbm", 11, True)])
def test_stream_equivalence(ds, seed, compact):
    if ds == "lubm":
        full = rgen.generate_lubm(scale=1, seed=0, density=0.35).finalize()
        split = dict()
        queries = LUBM_QUERIES
    else:
        full = rgen.generate_bsbm(n_products=120, seed=3).finalize()
        split = dict(frac_base=0.8, n_dels=30)
        queries = BSBM_QUERIES
    base, ins, dels = _split_stream(list(full.iter_decoded()),
                                    np.random.default_rng(seed), **split)
    (rstore, rmaps), (store, maps) = _stores(base)
    for s in (rstore, store):
        s.insert_triples(ins)
        s.delete_triples(dels)
    rsnap = rstore.compact() if compact else rstore.snapshot()
    snap = store.compact() if compact else store.snapshot()
    eng = SparqlEngine(snap, maps, device="cpu")
    _same_answers(eng, RefEngine(rsnap, rmaps), queries)
    if compact:
        # patch_stats / patch_index after compaction, against the reference
        got, want = snap.base._graph_stats, rsnap.base._graph_stats
        for f in ("pred_edges", "pred_subjects", "pred_objects",
                  "fanout_max_out", "fanout_max_in", "label_freq",
                  "label_cooc"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        for f in ("fanout_avg_out", "fanout_avg_in"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       err_msg=f)
        assert (got.n_edges, got.n_vertices) == (want.n_edges,
                                                 want.n_vertices)
        np.testing.assert_array_equal(snap.base._sig_index.sig,
                                      rsnap.base._sig_index.sig)


def test_batched_stream_keeps_chunk_programs():
    """The ``bench_update.py`` shape at small scale: batches of inserts and
    deletes with ``set_graph`` after each (the last through
    ``apply_update``), the query mix after every batch.  Counts, rows and
    each query's compile count equal the reference's."""
    full = rgen.generate_lubm(scale=1, seed=0, density=0.35).finalize()
    base, ins, dels = _split_stream(list(full.iter_decoded()),
                                    np.random.default_rng(5), 0.8, 20)
    (rstore, rmaps), (store, maps) = _stores(base)
    ref = RefEngine(rstore.snapshot(), rmaps)
    eng = SparqlEngine(store.snapshot(), maps, device="cpu")
    queries = {k: LUBM_QUERIES[k] for k in MIX}
    n = 4
    for b in range(n):
        bi = ins[b * len(ins) // n:(b + 1) * len(ins) // n]
        bd = dels[b * len(dels) // n:(b + 1) * len(dels) // n]
        if b < n - 1:
            for s, e in ((rstore, ref), (store, eng)):
                s.insert_triples(bi)
                s.delete_triples(bd)
                e.set_graph(s.snapshot())
        else:
            text = ("INSERT DATA { " + " ".join(
                f"{s} {p} {o} ." for s, p, o in bi) + " } DELETE DATA { "
                + " ".join(f"{s} {p} {o} ." for s, p, o in bd) + " }")
            assert store.apply_update(text) == rstore.apply_update(text)
            ref.set_graph(rstore.snapshot())
            eng.set_graph(store.snapshot())
        for name, q in queries.items():
            got, want = eng.query(q), ref.query(q)
            assert got.count == want.count, (b, name)
            np.testing.assert_array_equal(got.rows, want.rows)
            compiles = [br["base"].get("compiles", 0)
                        for r in (got, want)
                        for br in r.stats["exec"]["branches"]]
            assert compiles[:len(compiles) // 2] == \
                compiles[len(compiles) // 2:], (b, name)
    assert eng.executor.graph is store.base  # swapped in, never rebuilt


# ------------------------------------------------------ store/update layers
def _lubm_store():
    from repro_torch.rdf.generator import generate_lubm

    g, maps = type_aware_transform(
        generate_lubm(scale=1, seed=0, density=0.3).finalize())
    return VersionedStore(g, maps, auto_compact=False), maps


def _ref_lubm_store():
    """The reference's store over the same LUBM graph, with maps of its own
    (the session fixture's maps grow with every store built on them)."""
    rg, rmaps = r_transform(
        rgen.generate_lubm(scale=1, seed=0, density=0.3).finalize())
    return RStore(rg, rmaps, auto_compact=False), rmaps


def test_pvar_query_sees_delta():
    """Mirror of ``test_store.py::test_pvar_query_sees_delta``: the
    predicate-variable step runs ``delta_merge_labeled`` and the plain
    delta CSRs; tombstones of base edges are masked on that path too."""
    rstore, rmaps = _ref_lubm_store()
    store, maps = _lubm_store()
    g = store.base
    ref = RefEngine(rstore.snapshot(), rmaps)
    eng = SparqlEngine(store.snapshot(), maps, device="cpu")
    q = "SELECT ?p WHERE { ub:PVarSubj ?p ub:PVarObj . }"
    q_all = "SELECT ?x ?p ?y WHERE { ?x ?p ?y . }"
    s_id = int(np.flatnonzero(np.diff(g.out.indptr_all))[0])
    o_id = int(g.out.nbr_all[g.out.indptr_all[s_id]])
    el = int(g.out.lab_all[g.out.indptr_all[s_id]])
    d = maps.dict
    base_triple = (d.term(int(maps.vertex_to_term[s_id])),
                   d.predicate(int(maps.elabel_to_pred[el])),
                   d.term(int(maps.vertex_to_term[o_id])))
    steps = [
        ("insert", [("ub:PVarSubj", "ub:brandNewPred", "ub:PVarObj")]),
        ("insert", [("ub:PVarSubj", "ub:advisor", "ub:PVarObj")]),
        ("delete", [("ub:PVarSubj", "ub:brandNewPred", "ub:PVarObj")]),
        ("delete", [base_triple]),
    ]
    kernels = set()
    for action, triples in steps:
        for s, e in ((rstore, ref), (store, eng)):
            getattr(s, f"{action}_triples")(triples)
            e.set_graph(s.snapshot())
        for text in (q, q_all):
            got, want = eng.query(text), ref.query(text)
            assert got.count == want.count
            np.testing.assert_array_equal(got.rows, want.rows)
            assert got.decode(maps) == want.decode(rmaps)
            kernels.update(got.stats["exec"]["branches"][0]["base"]
                           .get("step_kernels") or [])
    assert "delta_merge_labeled" in kernels
    assert [r["p"] for r in eng.query(q).decode(maps)] == ["ub:advisor"]


def test_pinned_query_answers_at_its_version():
    store, maps = _lubm_store()
    eng = SparqlEngine(store.snapshot(), maps, device="cpu")
    compiled, _ = eng.compile(Q_ADVISOR)
    c0 = eng.execute_compiled(compiled).count
    executor, state = eng.executor, eng.executor.pin()
    # the update lands while a query holds the old pin: a writer thread
    # swaps the snapshot in between the pinned query's two runs
    writer = threading.Thread(target=lambda: (
        store.insert_triples([("ub:PinS", "ub:advisor", "ub:PinO")]),
        eng.set_graph(store.snapshot())))
    first = executor.run(compiled.branches[0].plan, state=state)
    writer.start()
    writer.join()
    second = executor.run(compiled.branches[0].plan, state=state)
    assert first.count == second.count == c0
    np.testing.assert_array_equal(first.bindings, second.bindings)
    assert eng.executor is executor and eng.executor.pin() is not state
    assert eng.execute_compiled(compiled).count == c0 + 1
    with pytest.raises(ValueError, match="different base"):
        executor.set_snapshot(VersionedStore(
            graph_from_arrays(graph_fields(store.base)), maps).snapshot())


def test_compaction_rebuilds_executor_keeping_breaker():
    store, maps = _lubm_store()
    eng = SparqlEngine(store.snapshot(), maps, device="cpu")
    store.insert_triples([("ub:CmpS", "ub:advisor", "ub:CmpO")])
    eng.set_graph(store.snapshot())
    before = eng.query(Q_ADVISOR)
    old = eng.executor
    eng.set_graph(store.compact())
    assert eng.executor is not old and eng.executor.breaker is old.breaker
    assert eng.executor.device == old.device
    after = eng.query(Q_ADVISOR)
    assert after.count == before.count
    np.testing.assert_array_equal(np.sort(after.rows, axis=0),
                                  np.sort(before.rows, axis=0))


def test_unsat_on_a_snapshot_is_not_cached():
    store, maps = _lubm_store()
    eng = SparqlEngine(store.snapshot(), maps, device="cpu")
    q = "SELECT ?x WHERE { ?x ub:justBorn ?y . }"
    assert eng.count(q) == 0
    store.insert_triples([("ub:NewS", "ub:justBorn", "ub:NewO")])
    eng.set_graph(store.snapshot())
    assert eng.count(q) == 1


def test_delta_merge_fault_retries_to_identical_result():
    """Mirror of ``test_resilience.py``: an injected out-of-memory at the
    snapshot arrays' ``delta_merge`` site is retried to the same rows."""
    rstore, rmaps = _ref_lubm_store()
    store, maps = _lubm_store()
    upd = "INSERT DATA { ub:RZed ub:advisor ub:ROther . }"
    store.apply_update(upd)
    rstore.apply_update(upd)
    exp = SparqlEngine(store.snapshot(), maps, device="cpu").query(Q_ADVISOR)
    eng = SparqlEngine(store.snapshot(), maps, device="cpu")
    with faults.inject("delta_merge:oom", times=1, seed=0) as inj:
        res = eng.query(Q_ADVISOR)
    assert inj.counters[("delta_merge", "oom")] == 1
    assert res.count == exp.count
    np.testing.assert_array_equal(res.rows, exp.rows)
    assert eng.executor.resilience_snapshot()["fault_retries"] >= 1
    ref = RefEngine(rstore.snapshot(), rmaps)
    with rfaults.inject("delta_merge:oom", times=1, seed=0):
        want = ref.query(Q_ADVISOR)
    np.testing.assert_array_equal(res.rows, want.rows)


def test_profiled_stats_name_delta_merge():
    store, maps = _lubm_store()
    eng = SparqlEngine(store.snapshot(), maps, device="cpu")
    q = ("SELECT ?x ?c WHERE { ?x rdf:type ub:GraduateStudent . "
         "?x ub:takesCourse ?c . }")
    assert eng.query(q).stats["exec"]["branches"][0]["base"][
        "step_kernels"] == ["expand_filter"]
    store.insert_triples([("ub:GradZ", "rdf:type", "ub:GraduateStudent"),
                          ("ub:GradZ", "ub:takesCourse", "ub:CourseZ")])
    eng.set_graph(store.snapshot())
    plain = eng.query(q)
    prof = eng.explain(q, analyze=True)
    steps = prof["branches"][0]["steps"]
    assert any(s.get("wall_ms") is not None for s in steps)
    stats = eng.execute_compiled(eng.compile(q)[0], profile=True).stats
    base = stats["exec"]["branches"][0]["base"]
    assert base["step_kernels"] == ["delta_merge"]
    assert base["step_wall_ms"] is not None
    assert prof["actual_rows"] == plain.count
