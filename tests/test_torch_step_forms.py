"""The executor's filters, merged steps and +INT joins through the kernels'
fused forms.

On a live-store snapshot every step whose direction carries a delta calls
``ops.delta_merge`` with the row-level fields and the slots' rows
(``row=``), and every label filter calls ``ops.bitmap_superset`` with the
table and the candidates' ids (``ids=``), so no per-slot copy is gathered
first.  Both packages build a store from the same triples and apply the
same inserts and deletes; the reference plans each query on its snapshot,
``repro_torch.convert`` carries the plan across, and the port's chunk
program (``Executor.run``) and batch program (``Executor.run_batch``) must
return the reference executor's counts, rows and stats.  On a static graph
every +INT non-tree check calls ``ops.tile_membership`` in its range form
(``iptr=``, ``probe=``, ``tb=``), which builds the adjacency tile itself,
and is held to the reference executor the same way.
"""

import re

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.exec as rexec  # noqa: E402
import repro_torch.core.exec as texec  # noqa: E402
from repro.core import ExecOpts as RefOpts  # noqa: E402
from repro.core import Executor as RefExecutor  # noqa: E402
from repro.core import SparqlEngine as RefEngine  # noqa: E402
from repro.rdf import generator as rgen  # noqa: E402
from repro.rdf.transform import type_aware_transform as r_transform  # noqa: E402
from repro.rdf.triples import TripleStore as RTripleStore  # noqa: E402
from repro.rdf.workloads import LUBM_QUERIES  # noqa: E402
from repro.serve.fingerprint import parameterize_query as ref_pq  # noqa: E402
from repro.store import VersionedStore as RStore  # noqa: E402
from repro_torch.convert import (graph_fields, graph_from_arrays,  # noqa: E402
                                 plan_fields, plan_from_fields)
from repro_torch.core import ExecOpts, Executor  # noqa: E402
from repro_torch.rdf.transform import type_aware_transform  # noqa: E402
from repro_torch.rdf.triples import TripleStore  # noqa: E402
from repro_torch.store import VersionedStore  # noqa: E402

# a family whose batch runs a merged step with a label filter
TMPL_COURSE = """SELECT ?x ?y WHERE {{
  ?x rdf:type ub:GraduateStudent .
  ?x ub:takesCourse {c} .
  ?x ub:advisor ?y .
}}"""
# LUBM Q9 with a hoisted constant: the batch joins a non-tree edge (+INT)
TMPL_CYCLE_Q9 = """SELECT ?x ?y ?z WHERE {{
  ?x rdf:type ub:Student .
  ?y rdf:type ub:Faculty .
  ?z rdf:type ub:Course .
  ?x ub:advisor ?y .
  ?y ub:teacherOf ?z .
  ?x ub:takesCourse ?z .
  ?y ub:worksFor {d} .
}}"""
STATS = ("step_rows", "step_kept", "step_kernels", "chunks", "resumes")


@pytest.fixture(autouse=True)
def no_small_probe(monkeypatch):
    monkeypatch.setattr(rexec, "_small_plan", lambda plan, opts: False)
    monkeypatch.setattr(texec, "_small_plan", lambda plan, opts: False)


@pytest.fixture(scope="module")
def snapshots():
    """(reference snapshot, its engine), port snapshot: the same base
    (three quarters of LUBM's plain triples), then the rest inserted and 40
    base triples deleted in both stores."""
    full = rgen.generate_lubm(scale=1, seed=0, density=0.35).finalize()
    triples = list(full.iter_decoded())
    onto = [t for t in triples if t[1] in ("rdf:type", "rdf:subClassOf")]
    plain = [t for t in triples if t[1] not in ("rdf:type", "rdf:subClassOf")]
    rng = np.random.default_rng(4)
    idx = rng.permutation(len(plain))
    n_base = len(plain) * 3 // 4
    base = onto + [plain[i] for i in idx[:n_base]]
    ins = [plain[i] for i in idx[n_base:]]
    dels = [plain[idx[i]] for i in rng.choice(n_base, size=40, replace=False)]
    snaps = []
    for ts, transform, store_cls in ((RTripleStore, r_transform, RStore),
                                     (TripleStore, type_aware_transform,
                                      VersionedStore)):
        st = ts()
        st.add_many(base)
        g, maps = transform(st.finalize())
        store = store_cls(g, maps, auto_compact=False)
        store.insert_triples(ins)
        store.delete_triples(dels)
        snaps.append((store.snapshot(), maps))
    (rsnap, rmaps), (snap, _) = snaps
    return rsnap, RefEngine(rsnap, rmaps), snap


@pytest.fixture
def forms(monkeypatch):
    """Records, per call, whether ``delta_merge`` got ``row`` and
    ``bitmap_superset`` got ``ids``."""
    seen = {"delta_merge": [], "bitmap_superset": []}
    for name, kw in (("delta_merge", "row"), ("bitmap_superset", "ids")):
        orig = getattr(texec.kops, name)

        def spy(*args, _orig=orig, _name=name, _kw=kw, **kwargs):
            seen[_name].append(kwargs.get(_kw) is not None)
            return _orig(*args, **kwargs)
        monkeypatch.setattr(texec.kops, name, spy)
    return seen


def _same(got, want):
    assert got.count == want.count
    for f in ("bindings", "pvar_bindings", "origins"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.shape == b.shape, f
    for k in STATS:
        assert got.stats.get(k) == want.stats.get(k), k


def _fused_forms_only(seen):
    assert seen["delta_merge"] and all(seen["delta_merge"])
    assert seen["bitmap_superset"] and all(seen["bitmap_superset"])


@pytest.mark.parametrize("qn", ["Q2", "Q4", "Q9"])
def test_chunk_program_fused_forms(snapshots, forms, qn):
    rsnap, ref, snap = snapshots
    compiled, _ = ref.compile(LUBM_QUERIES[qn])
    for br in compiled.branches:
        rplan = br.plan
        plan = plan_from_fields(plan_fields(rplan))
        got = Executor(snap, ExecOpts(), device="cpu").run(plan)
        want = RefExecutor(rsnap, RefOpts()).run(rplan)
        _same(got, want)
        assert "delta_merge" in got.stats["step_kernels"]
    _fused_forms_only(forms)


@pytest.mark.parametrize("collect", ["bindings", "count"])
def test_batch_program_fused_forms(snapshots, forms, collect):
    rsnap, ref, snap = snapshots
    terms = ref.maps.dict.terms.to_str
    courses = [t for t in terms if re.match(r"ub:GraduateCourse\d", t)][:5]
    rpqs = [ref_pq(TMPL_COURSE.format(c=c)) for c in courses]
    rplan = ref.compile_param(rpqs[0]).plan
    mat = np.stack([ref.resolve_params(pq.consts) for pq in rpqs])
    plan = plan_from_fields(plan_fields(rplan))
    got = Executor(snap, ExecOpts(), device="cpu").run_batch(
        plan, mat, collect=collect)
    want = RefExecutor(rsnap, RefOpts()).run_batch(rplan, mat,
                                                   collect=collect)
    assert len(got) == len(want) == len(courses)
    for g_, w_ in zip(got, want):
        _same(g_, w_)
    assert any(r.stats.get("batched") for r in got)
    assert any(r.count for r in got)
    _fused_forms_only(forms)


@pytest.fixture(scope="module")
def static_world():
    """The reference's static LUBM graph and engine, and the port's copy of
    the graph."""
    rg, rmaps = r_transform(
        rgen.generate_lubm(scale=1, seed=0, density=0.35).finalize())
    return rg, RefEngine(rg, rmaps), graph_from_arrays(graph_fields(rg))


@pytest.fixture
def tile_forms(monkeypatch):
    """Records, per ``tile_membership`` call, whether it took the range
    form."""
    seen = []
    orig = texec.kops.tile_membership

    def spy(*args, **kwargs):
        seen.append(kwargs.get("iptr") is not None)
        return orig(*args, **kwargs)
    monkeypatch.setattr(texec.kops, "tile_membership", spy)
    return seen


@pytest.mark.parametrize("qn", ["Q2", "Q9"])
def test_chunk_program_int_range_form(static_world, tile_forms, qn):
    rg, ref, g = static_world
    compiled, _ = ref.compile(LUBM_QUERIES[qn])
    for br in compiled.branches:
        plan = plan_from_fields(plan_fields(br.plan))
        got = Executor(g, ExecOpts(), device="cpu").run(plan)
        want = RefExecutor(rg, RefOpts()).run(br.plan)
        _same(got, want)
        assert got.count
    assert tile_forms and all(tile_forms)


@pytest.mark.parametrize("collect", ["bindings", "count"])
def test_batch_program_int_range_form(static_world, tile_forms, collect):
    rg, ref, g = static_world
    terms = ref.maps.dict.terms.to_str
    depts = [t for t in terms if re.match(r"ub:Dept\d", t)][:5]
    rpqs = [ref_pq(TMPL_CYCLE_Q9.format(d=d)) for d in depts]
    rplan = ref.compile_param(rpqs[0]).plan
    mat = np.stack([ref.resolve_params(pq.consts) for pq in rpqs])
    plan = plan_from_fields(plan_fields(rplan))
    got = Executor(g, ExecOpts(), device="cpu").run_batch(plan, mat,
                                                          collect=collect)
    want = RefExecutor(rg, RefOpts()).run_batch(rplan, mat, collect=collect)
    assert len(got) == len(want) == len(depts)
    for g_, w_ in zip(got, want):
        _same(g_, w_)
    assert any(r.stats.get("batched") for r in got)
    assert any(r.count for r in got)
    assert tile_forms and all(tile_forms)
