"""Parameterized query families and batches: the port against the reference.

The same LUBM graph (scale 1, density 0.3, seed 0) is built by both
packages; every query family runs through ``compile_param`` →
``execute_param`` / ``execute_param_batch`` in both, and the port must give
the reference's counts, rows in order and ``QueryResult.stats`` exactly
(wall times aside), the batch's per-lane step counters, ``batched``,
``batch_lanes`` and ``batch_fill`` included.  Constants are drawn with
numpy seeds.  The small-plan probe, which picks a configuration by timing,
is pinned to the pipelined one in both executors so the stats compare.

The cases are those of ``tests/test_param_batch.py`` (its scheduler tests
aside) plus a forced-overflow lane, count mode, ``explain_param``, the
plan fields' conversion and ``Executor.run_batch`` on the same converted
plan in both executors (a shared start set and tiny capacities included).
"""

import re
from dataclasses import replace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import ExecOpts as RefOpts  # noqa: E402
from repro.core import Executor as RefExecutor  # noqa: E402
from repro.core import SparqlEngine as RefEngine  # noqa: E402
from repro.rdf.generator import generate_lubm as ref_generate_lubm  # noqa: E402
from repro.rdf.transform import (  # noqa: E402
    type_aware_transform as ref_type_aware_transform)
from repro.serve.fingerprint import parameterize_query as ref_pq  # noqa: E402
from repro.store import VersionedStore as RefStore  # noqa: E402
from repro_torch.convert import (graph_fields, graph_from_arrays,  # noqa: E402
                                 plan_fields, plan_from_fields)
from repro_torch.core import ExecOpts, Executor, SparqlEngine  # noqa: E402
from repro_torch.rdf.generator import generate_lubm  # noqa: E402
from repro_torch.rdf.transform import type_aware_transform  # noqa: E402
from repro_torch.serve.fingerprint import parameterize_query  # noqa: E402
from repro_torch.store import VersionedStore  # noqa: E402

TMPL_COURSE = """SELECT ?x WHERE {{
  ?x rdf:type ub:GraduateStudent .
  ?x ub:takesCourse {c} .
}}"""

TMPL_TWO_CONST = """SELECT ?x ?y WHERE {{
  ?x rdf:type ub:Student .
  ?x ub:memberOf {d} .
  ?x ub:takesCourse ?y .
  ?y rdf:type ub:Course .
  ?z ub:teacherOf ?y .
  ?z ub:worksFor {d2} .
}}"""

# benchmarks/bench_serve.py SAME_SHAPE_TMPL: the start is the parameter
TMPL_STUDENT = """SELECT ?c ?t WHERE {{
  {c} ub:takesCourse ?c .
  ?t ub:teacherOf ?c .
  ?t ub:worksFor ?d .
}}"""

# LUBM Q9 and Q2 with a hoisted constant: each keeps its triangle, so a
# step checks a non-tree edge (+INT tile or binary search) inside the batch
TMPL_CYCLE_Q9 = """SELECT ?x ?y ?z WHERE {{
  ?x rdf:type ub:Student .
  ?y rdf:type ub:Faculty .
  ?z rdf:type ub:Course .
  ?x ub:advisor ?y .
  ?y ub:teacherOf ?z .
  ?x ub:takesCourse ?z .
  ?y ub:worksFor {d} .
}}"""

TMPL_CYCLE_Q2 = """SELECT ?x ?y ?z WHERE {{
  ?x rdf:type ub:GraduateStudent .
  ?y rdf:type ub:University .
  ?z rdf:type ub:Department .
  ?x ub:memberOf ?z .
  ?z ub:subOrganizationOf ?y .
  ?x ub:undergraduateDegreeFrom ?y .
  {p} ub:headOf ?z .
}}"""

TMPL_DISTINCT = """SELECT DISTINCT ?y WHERE {{
  ?x rdf:type ub:Student .
  ?x ub:memberOf {d} .
  ?x ub:takesCourse ?y .
}} LIMIT 3"""

UPDATE = """INSERT DATA {
    ub:NewGrad1 a ub:GraduateStudent .
    ub:NewGrad1 ub:takesCourse ub:GraduateCourse0.Dept0.Univ0 .
    ub:NewGrad2 a ub:GraduateStudent .
    ub:NewGrad2 ub:takesCourse ub:GraduateCourse1.Dept0.Univ0 .
}"""

TIMES = ("plan_ms", "wall_ms", "build_ms", "small_probe")


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in TIMES}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def world():
    """Both engines on the same graph, and the term pools.  Each package's
    graph and maps are built here: the session's ``lubm_graph`` maps can be
    grown by an earlier test (a store interns its new terms into them),
    and the batches resolve their constants through the maps."""
    rg, rmaps = ref_type_aware_transform(
        ref_generate_lubm(scale=1, seed=0, density=0.3).finalize())
    g, maps = type_aware_transform(
        generate_lubm(scale=1, seed=0, density=0.3).finalize())
    terms = maps.dict.terms.to_str
    pools = {
        "course": [t for t in terms if re.match(r"ub:GraduateCourse\d", t)],
        "dept": [t for t in terms if re.match(r"ub:Dept\d", t)],
        "student": [t for t in terms if re.match(
            r"ub:(Undergraduate|Graduate)Student\d", t)],
        # each department's first full professor heads it
        "chair": [t for t in terms if re.match(r"ub:FullProfessor0\.", t)],
    }
    assert len(pools["course"]) >= 3 and len(pools["dept"]) >= 2
    return (g, maps), (rg, rmaps), pools


def _engines(world, opts=None):
    (g, maps), (rg, rmaps), _ = world
    kw = {} if opts is None else opts
    return (SparqlEngine(g, maps, opts=ExecOpts(**kw), device="cpu"),
            RefEngine(rg, rmaps, opts=RefOpts(**kw)))


@pytest.fixture(scope="module")
def engines(world):
    return _engines(world)


def _families(eng, ref, queries):
    pqs = [parameterize_query(q) for q in queries]
    rpqs = [ref_pq(q) for q in queries]
    assert len({pq.shape for pq in pqs}) == 1
    assert [pq.shape for pq in pqs] == [pq.shape for pq in rpqs]
    assert [pq.consts for pq in pqs] == [pq.consts for pq in rpqs]
    fam, rfam = eng.compile_param(pqs[0]), ref.compile_param(rpqs[0])
    assert (fam is None) == (rfam is None)
    if fam is not None:
        # the timed small-plan probe would pick per run; pin it alike
        eng.executor._small_mode[fam.plan.signature()] = False
        ref.executor._small_mode[rfam.plan.signature()] = False
    return pqs, fam, rfam


def assert_same(got, want):
    assert got.count == want.count
    assert got.variables == want.variables and got.kinds == want.kinds
    np.testing.assert_array_equal(got.rows, want.rows)
    assert got.rows.shape == want.rows.shape
    assert _strip_times(got.stats) == _strip_times(want.stats)


def _check_family(eng, ref, queries, collect="bindings"):
    """Port == reference for every member, solo and batched; batch ==
    solo == the baked query in the port."""
    pqs, fam, rfam = _families(eng, ref, queries)
    assert fam is not None
    consts = [pq.consts for pq in pqs]
    seq = [eng.execute_param(fam, c, collect) for c in consts]
    bat = eng.execute_param_batch(fam, consts, collect)
    for s, r in zip(seq, [ref.execute_param(rfam, c, collect)
                          for c in consts]):
        assert_same(s, r)
    for b, r in zip(bat, ref.execute_param_batch(rfam, consts, collect)):
        assert_same(b, r)
    for s, b, pq in zip(seq, bat, pqs):
        assert s.count == b.count
        np.testing.assert_array_equal(s.rows, b.rows)
        base = eng.query_ast(pq.canon.query, collect=collect)
        assert base.count == s.count
        if collect == "bindings":
            assert sorted(map(tuple, base.rows.tolist())) == \
                sorted(map(tuple, s.rows.tolist()))
    return seq, bat


def _base(res):
    return res.stats["exec"]["branches"][0]["base"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batch_matches_reference_random_constants(world, engines, seed):
    eng, ref = engines
    pool = world[2]["course"]
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(pool), size=int(rng.integers(2, 7)))
    _, bat = _check_family(eng, ref, [TMPL_COURSE.format(c=pool[i])
                                      for i in picks])
    lanes = 1 << (len(picks) - 1).bit_length()
    for b in bat:
        st = _base(b)
        assert st["batched"] is True and st["batch_lanes"] == lanes
        assert st["batch_fill"] == len(picks) / lanes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_matches_reference_two_constants(world, engines, seed):
    eng, ref = engines
    depts = world[2]["dept"]
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 5))
    shift = int(rng.integers(0, 2))
    qs = [TMPL_TWO_CONST.format(d=depts[i % len(depts)],
                                d2=depts[(i + shift) % len(depts)])
          for i in rng.integers(0, len(depts), size=n)]
    _check_family(eng, ref, qs)


def test_batch_matches_reference_student_start(world, engines):
    eng, ref = engines
    pool = world[2]["student"][:64]
    rng = np.random.default_rng(11)
    qs = [TMPL_STUDENT.format(c=pool[i])
          for i in rng.integers(0, len(pool), size=7)]
    _check_family(eng, ref, qs)
    _check_family(eng, ref, qs, collect="count")


def _cycle_queries(pools, which, n):
    if which == "q9":
        return [TMPL_CYCLE_Q9.format(d=pools["dept"][i % len(pools["dept"])])
                for i in range(n)]
    return [TMPL_CYCLE_Q2.format(p=pools["chair"][i % len(pools["chair"])])
            for i in range(n)]


@pytest.mark.parametrize("collect", ["bindings", "count"])
@pytest.mark.parametrize("which", ["q9", "q2"])
def test_batch_matches_reference_cycles(world, engines, which, collect):
    """Families whose plan joins a non-tree edge inside the batch."""
    eng, ref = engines
    qs = _cycle_queries(world[2], which, 5)
    _, fam, _ = _families(eng, ref, qs)
    assert any(s.nontree for s in fam.plan.steps)
    _, bat = _check_family(eng, ref, qs, collect)
    assert all(_base(b)["batched"] for b in bat)
    assert sum(b.count for b in bat) > 0


def test_missing_constant_lane_is_empty(world, engines):
    eng, ref = engines
    courses = world[2]["course"]
    qs = [TMPL_COURSE.format(c=courses[0]),
          TMPL_COURSE.format(c="ub:NoSuchCourse999"),
          TMPL_COURSE.format(c=courses[1])]
    seq, bat = _check_family(eng, ref, qs)
    assert seq[1].count == 0 and bat[1].count == 0


def test_forced_overflow_lane_reruns_alone(world):
    """Capacities of 8 rows (the schedule's floor): a department lane
    whose members (11-14 here) outnumber them overflows, freezes, and is
    rerun alone through ``run``."""
    eng, ref = _engines(world, dict(init_cap=1, cap_slack=0.01))
    depts = world[2]["dept"]
    qs = [TMPL_TWO_CONST.format(d=d, d2=d) for d in depts[:3]] + \
        [TMPL_TWO_CONST.format(d=depts[0], d2=depts[1])]
    _, bat = _check_family(eng, ref, qs)
    rerun = [b for b in bat if "batched" not in _base(b)]
    assert rerun and all(max(_base(b)["step_rows"]) > 8 for b in rerun)


def test_param_batch_on_versioned_snapshot(world):
    """A family batch on a live snapshot (every step ``delta_merge``).  A
    store interns new terms into the maps it is given, so both packages
    get fresh graphs and maps here (the module's ``world`` maps serve the
    other tests of this file)."""
    pools = world[2]
    rg, rmaps = ref_type_aware_transform(
        ref_generate_lubm(scale=1, seed=0, density=0.3).finalize())
    g, maps = type_aware_transform(
        generate_lubm(scale=1, seed=0, density=0.3).finalize())
    store = VersionedStore(g, maps, auto_compact=False)
    rstore = RefStore(rg, rmaps, auto_compact=False)
    eng = SparqlEngine(store.snapshot(), maps, device="cpu")
    ref = RefEngine(rstore.snapshot(), rmaps)
    store.apply_update(UPDATE)
    rstore.apply_update(UPDATE)
    eng.set_graph(store.snapshot())
    ref.set_graph(rstore.snapshot())
    courses = pools["course"][:4]
    seq, bat = _check_family(eng, ref, [TMPL_COURSE.format(c=c)
                                        for c in courses])
    base = SparqlEngine(g, maps, device="cpu").query(
        TMPL_COURSE.format(c=courses[0]))
    assert seq[0].count == base.count + 1
    assert "delta_merge" in _base(bat[0])["step_kernels"]


def test_distinct_and_limit_shapes_parameterize(world, engines):
    eng, ref = engines
    qs = [TMPL_DISTINCT.format(d=d) for d in world[2]["dept"][:3]]
    pqs, fam, _ = _families(eng, ref, qs)
    assert fam is not None and fam.distinct and fam.limit == 3
    seq, _ = _check_family(eng, ref, qs)
    for s, pq in zip(seq, pqs):
        np.testing.assert_array_equal(
            eng.query_ast(pq.canon.query).rows, s.rows)


def test_optional_shape_falls_back(world, engines):
    eng, ref = engines
    q = """SELECT ?x ?e WHERE {{
      ?x rdf:type ub:GraduateStudent .
      ?x ub:takesCourse {c} .
      OPTIONAL {{ ?x ub:emailAddress ?e . }}
    }}""".format(c=world[2]["course"][0])
    pq = parameterize_query(q)
    hits = eng.param_stats.hits
    assert eng.compile_param(pq) is None
    assert eng.compile_param(pq) is None  # the cached verdict
    assert eng.param_stats.hits == hits + 1
    assert ref.compile_param(ref_pq(q)) is None


def test_no_constant_shape_has_no_params(engines):
    eng, _ = engines
    pq = parameterize_query("SELECT ?x ?y WHERE { ?x ub:advisor ?y . }")
    assert pq.consts == ()
    assert eng.compile_param(pq) is None


def test_alpha_equivalent_members_share_one_shape(world):
    courses = world[2]["course"]
    other = """SELECT ?s WHERE {{
      ?s ub:takesCourse {c} .
      ?s rdf:type ub:GraduateStudent .
    }}""".format(c=courses[1])
    a = parameterize_query(TMPL_COURSE.format(c=courses[0]))
    b = parameterize_query(other)
    assert a.shape == b.shape and a.consts != b.consts
    assert b.shape == ref_pq(other).shape


def test_structural_predicates_never_hoist(world):
    pq = parameterize_query(TMPL_COURSE.format(c=world[2]["course"][0]))
    assert list(pq.consts) == [world[2]["course"][0]]


@pytest.mark.parametrize("tmpl", ["course", "two", "optional"])
def test_explain_param(world, engines, tmpl):
    eng, ref = engines
    pools = world[2]
    q = {"course": TMPL_COURSE.format(c=pools["course"][2]),
         "two": TMPL_TWO_CONST.format(d=pools["dept"][0],
                                      d2=pools["dept"][1]),
         "optional": """SELECT ?x ?e WHERE {{ ?x ub:takesCourse {c} .
           OPTIONAL {{ ?x ub:emailAddress ?e . }} }}""".format(
             c=pools["course"][0])}[tmpl]
    got, want = eng.explain_param(q), ref.explain_param(q)
    assert _strip_times(got) == _strip_times(want)
    assert got["parameterized"] == (tmpl != "optional")


def test_plan_fields_carry_parameters(world, engines):
    _, ref = engines
    rfam = ref.compile_param(ref_pq(TMPL_TWO_CONST.format(
        d=world[2]["dept"][0], d2=world[2]["dept"][1])))
    plan = plan_from_fields(plan_fields(rfam.plan))
    assert plan.n_params == rfam.plan.n_params == 2
    assert plan.start_param_slot == rfam.plan.start_param_slot
    assert [s.param_slot for s in plan.steps] == \
        [s.param_slot for s in rfam.plan.steps]
    assert any(s.param_slot >= 0 for s in plan.steps)


def test_run_params_are_checked(world, engines):
    _, ref = engines
    rfam = ref.compile_param(ref_pq(TMPL_COURSE.format(
        c=world[2]["course"][0])))
    plan = plan_from_fields(plan_fields(rfam.plan))
    ex = Executor(graph_from_arrays(graph_fields(world[1][0])),
                  device="cpu")
    with pytest.raises(ValueError, match="parameters"):
        ex.run(plan)
    with pytest.raises(ValueError, match="parameters"):
        ex.run(plan, params=np.zeros(2, np.int32))
    res = ex.run(plan, params=np.array([-1], np.int32))
    assert res.count == 0 and res.bindings.shape == (0, plan.query.n_vertices)
    with pytest.raises(ValueError, match="params"):
        ex.run_batch(plan, np.zeros((3, 2), np.int32))


RUN_BATCH_CASES = {
    # name: (template, plan edit, options)
    "per_lane": ("course", None, {}),
    # capacities of 32: some department lanes fit, others overflow
    "tiny_caps": ("two", "tiny", dict(init_cap=32)),
    "shared_start": ("two", "shared", {}),
    "shared_tiny": ("two", "shared_tiny", dict(init_cap=1)),
    "count": ("student", None, {}),
    # non-tree joins inside the batch: +INT tiles, and binary search
    "cycle_q9": ("q9", None, {}),
    "cycle_q2": ("q2", None, {}),
    "cycle_q9_search": ("q9", None, dict(use_int=False)),
}


@pytest.mark.parametrize("case", sorted(RUN_BATCH_CASES))
def test_run_batch_executor_parity(world, engines, case):
    """``run_batch`` on the same converted plan in both executors: every
    lane's count, rows, pvar rows, origins and stats.  ``shared`` drops
    the parameterized start, so every lane starts from the plan's start set
    and checks its own constants in later steps; ``tiny`` strips the
    estimates, so lanes overflow their capacities."""
    tmpl, edit, kw = RUN_BATCH_CASES[case]
    _, ref = engines
    pools = world[2]
    rg = world[1][0]
    if tmpl == "course":
        qs = [TMPL_COURSE.format(c=c) for c in pools["course"][:5]]
    elif tmpl == "two":
        d = pools["dept"]
        qs = [TMPL_TWO_CONST.format(d=d[i % len(d)], d2=d[(i + 1) % len(d)])
              for i in range(5)] + [TMPL_TWO_CONST.format(d=d[0], d2=d[0])]
    elif tmpl in ("q9", "q2"):
        qs = _cycle_queries(pools, tmpl, 6)
    else:
        qs = [TMPL_STUDENT.format(c=c) for c in pools["student"][:9]]
    rpqs = [ref_pq(q) for q in qs]
    rplan = ref.compile_param(rpqs[0]).plan
    if edit in ("shared", "shared_tiny"):
        rplan = replace(rplan, start_param_slot=-1)
    if edit in ("tiny", "shared_tiny"):
        rplan = replace(rplan, est_fanout=[], est_expand=[])
    mat = np.stack([ref.resolve_params(pq.consts) for pq in rpqs])
    mat[1, 0] = -1  # a missing constant
    collect = "count" if case == "count" else "bindings"
    plan = plan_from_fields(plan_fields(rplan))
    assert tmpl not in ("q9", "q2") or any(s.nontree for s in plan.steps)
    ex = Executor(graph_from_arrays(graph_fields(rg)), ExecOpts(**kw),
                  device="cpu")
    rex = RefExecutor(rg, RefOpts(**kw))
    ex._small_mode[plan.signature()] = False
    rex._small_mode[rplan.signature()] = False
    got = ex.run_batch(plan, mat, collect=collect)
    want = rex.run_batch(rplan, mat, collect=collect)
    assert len(got) == len(want) == len(qs)
    for g_, w_ in zip(got, want):
        assert g_.count == w_.count
        for f in ("bindings", "pvar_bindings", "origins"):
            a, b = getattr(g_, f), getattr(w_, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
                assert a.shape == b.shape, f
        assert _strip_times(g_.stats) == _strip_times(w_.stats)
    if edit in ("tiny", "shared_tiny"):
        # a lane rerun alone (a missing constant's lane has no stats)
        assert any(r.stats.get("chunks") and not r.stats.get("batched")
                   for r in got)
    if edit != "shared_tiny":
        assert any(r.stats.get("batched") for r in got)
    keys = [k for k in ex.program_keys() if k.lanes]
    assert len(keys) == 1
    assert keys[0].lanes in (4, 8) and all(
        r.stats.get("batch_lanes", keys[0].lanes) == keys[0].lanes
        for r in got)
    assert keys[0].per_lane_start == (plan.start_param_slot >= 0)


def test_transient_fault_falls_back_to_solo_runs(world, engines):
    """A transient fault in the batch program (an injected out-of-memory at
    its dispatch) answers every member through its own ``run``, with the
    same rows as the batch; the reference does the same."""
    from repro.resilience import faults as ref_faults
    from repro_torch.resilience import faults

    eng, ref = engines
    qs = [TMPL_COURSE.format(c=c) for c in world[2]["course"][:4]]
    pqs, fam, rfam = _families(eng, ref, qs)
    consts = [pq.consts for pq in pqs]
    want = eng.execute_param_batch(fam, consts)
    with faults.inject("dispatch:oom", times=1, seed=0):
        got = eng.execute_param_batch(fam, consts)
    with ref_faults.inject("dispatch:oom", times=1, seed=0):
        ref_got = ref.execute_param_batch(rfam, consts)
    for g_, w_, r_ in zip(got, want, ref_got):
        np.testing.assert_array_equal(g_.rows, w_.rows)
        assert "batched" in _base(w_) and "batched" not in _base(g_)
        assert_same(g_, r_)
