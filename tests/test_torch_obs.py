"""Tracing, the roofline cost model and workload intelligence: the port
against the reference.

The same LUBM graph (scale 1, density 0.3, seed 0) is built by both
packages and the same queries go through both engines.  Every integer,
name and structure is compared exactly: span trees of ``query(trace=True)``
(names, nesting and step meta: kernel, rows, kept, retries, capacity,
prune counts, plan order), the batch trace's lanes against the reference's
per-lane stats, ``kernel_cost`` over a grid of inputs, workload profiles
(``fold`` / ``observed_fanouts`` / ``snapshot``), ``describe_compiled``'s
q-error columns, and planner feedback (plan order, ``+fb1`` suffix,
answers).  ``model_ms`` on the ``cpu`` row is compared with ``rel=1e-9``.
Wall times are left out of every comparison.  The small-plan probe, which
picks a configuration by timing, is pinned to the pipelined one in both
executors wherever an untraced run is compared.
"""

import itertools
import re

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.analysis import roofline as ref_roofline  # noqa: E402
from repro.core import SparqlEngine as RefEngine  # noqa: E402
from repro.obs import DecisionJournal as RefJournal  # noqa: E402
from repro.obs import SlowQueryLog as RefSlowLog  # noqa: E402
from repro.obs import Trace as RefTrace  # noqa: E402
from repro.obs import WorkloadProfile as RefProfile  # noqa: E402
from repro.obs import WorkloadProfiler as RefProfiler  # noqa: E402
from repro.obs import chrome_trace as ref_chrome_trace  # noqa: E402
from repro.obs.report import build_report as ref_build_report  # noqa: E402
from repro.obs.report import render_markdown as ref_render  # noqa: E402
from repro.rdf.sparql import parse_sparql as ref_parse  # noqa: E402
from repro.rdf.workloads import LUBM_QUERIES  # noqa: E402
from repro.serve.fingerprint import canonicalize_query as ref_canon  # noqa: E402
from repro.serve.fingerprint import parameterize_query as ref_pq  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.core import SparqlEngine  # noqa: E402
from repro_torch.obs import (DecisionJournal, SlowQueryLog, Trace,  # noqa: E402
                             WorkloadProfile, WorkloadProfiler, chrome_trace,
                             qerror, qerror_log10)
from repro_torch.obs.report import build_report, render_markdown  # noqa: E402
from repro_torch.rdf.generator import generate_lubm  # noqa: E402
from repro_torch.rdf.sparql import parse_sparql  # noqa: E402
from repro_torch.rdf.transform import type_aware_transform  # noqa: E402
from repro_torch.serve.fingerprint import (canonicalize_query,  # noqa: E402
                                           parameterize_query)

TMPL_COURSE = """SELECT ?x WHERE {{
  ?x rdf:type ub:GraduateStudent .
  ?x ub:takesCourse {c} .
}}"""

# span / profile fields that hold wall times
TIME_KEYS = {"t0_ms", "dur_ms", "span_sum_ms", "plan_ms", "wall_ms_total",
             "last_wall_ms", "t", "wall_ms", "build_ms"}


@pytest.fixture(scope="module")
def world(lubm_graph):
    rg, rmaps = lubm_graph
    g, maps = type_aware_transform(
        generate_lubm(scale=1, seed=0, density=0.3).finalize())
    return (g, maps), (rg, rmaps)


def _engines(world):
    (g, maps), (rg, rmaps) = world
    return SparqlEngine(g, maps, device="cpu"), RefEngine(rg, rmaps)


def _split(span, models):
    """A span dict without its times; ``model_ms`` values go to
    ``models`` in tree order, so they compare within a tolerance."""
    meta = dict(span.get("meta") or {})
    if "model_ms" in meta:
        models.append(meta.pop("model_ms"))
    meta = {k: v for k, v in meta.items() if k not in TIME_KEYS}
    return (span["name"], meta,
            [_split(c, models) for c in span.get("children") or []])


def assert_same_tree(got: dict, want: dict) -> None:
    gm, wm = [], []
    assert _split(got, gm) == _split(want, wm)
    assert len(gm) == len(wm)
    assert gm == pytest.approx(wm, rel=1e-9)


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in TIME_KEYS and k != "small_probe"}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _pinned(eng, ref, text):
    """Compile ``text`` in both engines with the small-plan probe pinned
    to the pipelined configuration; returns both compiled queries."""
    got = eng.compile_canonical(canonicalize_query(parse_sparql(text)))
    want = ref.compile_canonical(ref_canon(ref_parse(text)))
    for c, e in ((got, eng), (want, ref)):
        for br in c.branches:
            e.executor._small_mode[br.plan.signature()] = False
    return got, want


# ------------------------------------------------------------- trace basics
def _drive_trace(cls):
    t = cls("q", profile_steps=True)
    with t.span("execute", branches=1):
        with t.span("branch", index=0):
            t.add("step", 0.001, step=0, kernel="ragged_expand")
            t.add("step", 0.002, step=1, kernel="expand_filter")
        t.event("plan_cache", hit=True)
    t.query_id, t.dataset, t.thread = "q-1", "lubm", "serve-worker-0"
    return t.finish()


def test_trace_and_chrome_export_match_reference():
    got, want = _drive_trace(Trace), _drive_trace(RefTrace)
    gd, wd = got.to_dict(), want.to_dict()
    for d in (gd, wd):
        d.pop("id")
    assert _strip(gd) == _strip(wd)
    assert [s.meta for s in got.find("step")] == \
        [s.meta for s in want.find("step")]
    gc, wc = chrome_trace([got, got]), ref_chrome_trace([want, want])
    strip_ev = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in gc["traceEvents"]]
    want_ev = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
               for e in wc["traceEvents"]]
    assert strip_ev == [{**e, "args": {
        **e["args"], "name": e["args"]["name"].replace(
            f"#{want.trace_id}", f"#{got.trace_id}")}}
        if e["name"] == "thread_name" else e for e in want_ev]
    step = [e for e in gc["traceEvents"] if e["name"] == "step"]
    assert [e["dur"] for e in step] == [1000.0, 2000.0] * 2


def test_slowlog_matches_reference():
    logs = (SlowQueryLog(capacity=3), RefSlowLog(capacity=3))
    outs = []
    for log, cls in zip(logs, (Trace, RefTrace)):
        rec = []
        for fp, ms in (("a", 5.0), ("b", 9.0), ("a", 7.0), ("c", 1.0),
                       ("d", 20.0), ("e", 0.5), ("b", 2.0)):
            t = cls("q", profile_steps=True)
            with t.span("execute"):
                pass
            rec.append(log.record(fp, ms, t.finish(), dataset="lubm",
                                  count=int(ms)))
        summ = [{k: v for k, v in s.items() if k not in ("id", "recorded_at")}
                for s in log.summaries()]
        outs.append((rec, summ, len(log)))
    assert outs[0] == outs[1]
    assert SlowQueryLog(capacity=0).record("a", 1.0, Trace()) is \
        RefSlowLog(capacity=0).record("a", 1.0, RefTrace())


# ---------------------------------------------------------------- roofline
def test_kernel_cost_matches_reference_over_grid():
    assert roofline.KERNEL_MODELS == ref_roofline.KERNEL_MODELS
    grid = itertools.product((0.0, 1.0, 999.0, 3.5e6), (0.0, 17.0, 5000.0),
                             (0.0, 1024.0, float(1 << 22)), (1, 4, 9),
                             (1, 3), (1, 20, 33))
    n = 0
    for exp, rows, cap, nq, words, it in grid:
        kw = dict(expanded=exp, rows=rows, capacity=cap, nq=nq,
                  bitmap_words=words, n_iters=it)
        for name in roofline.KERNEL_MODELS:
            got = roofline.kernel_cost(name, **kw)
            want = ref_roofline.kernel_cost(name, **kw)
            assert (got["flops"], got["bytes"]) == \
                (want["flops"], want["bytes"]), (name, kw)
            g = roofline.estimate_step_ms(name, backend="cpu", **kw)
            w = ref_roofline.estimate_step_ms(name, backend="cpu", **kw)
            assert g["model_ms"] == pytest.approx(w["model_ms"], rel=1e-9)
            assert g["dominant"] == w["dominant"]
            n += 1
    assert n == 5 * 4 * 3 * 3 * 3 * 2 * 3
    with pytest.raises(ValueError):
        roofline.kernel_cost("nope", expanded=1.0)


def test_cuda_row_is_the_h100_peak():
    assert roofline.BACKEND_PEAKS["cuda"] == (67e12, 3.35e12)
    est = roofline.estimate_step_ms("edge_exists", backend="cuda",
                                    expanded=1e6, n_iters=20)
    # 80 MB at 3.35 TB/s against 20 M operations at 67 T op/s
    assert est["dominant"] == "memory"
    assert est["model_ms"] == pytest.approx(8e7 / 3.35e12 * 1e3, rel=1e-12)
    with pytest.raises(KeyError):
        roofline.estimate_step_ms("edge_exists", backend="tpu", expanded=1.0)


# ------------------------------------------------------------ query traces
@pytest.mark.parametrize("qname", ["Q2", "Q8", "Q9"])
def test_forced_trace_span_tree_matches_reference(world, qname):
    eng, ref = _engines(world)
    got = eng.query(LUBM_QUERIES[qname], trace=True)
    want = ref.query(LUBM_QUERIES[qname], trace=True)
    assert got.count == want.count > 0
    np.testing.assert_array_equal(got.rows, want.rows)
    gt, wt = got.stats["trace"], want.stats["trace"]
    assert gt["profiled"] and not gt["sampled"]
    assert_same_tree(gt["root"], wt["root"])
    # the step spans name the kernels the run reports, with a model time
    steps = got.stats["trace_obj"].find("step")
    base = got.stats["exec"]["branches"][0]["base"]
    assert [s.meta["kernel"] for s in steps] == base["step_kernels"]
    assert all(s.meta["model_ms"] > 0 for s in steps)
    assert [s.dur * 1e3 for s in steps] == pytest.approx(
        base["step_wall_ms"], rel=1e-9)
    assert {c["name"] for c in gt["root"]["children"]} >= {
        "parse", "fingerprint", "plan_cache", "plan_search", "execute"}


def test_sampled_trace_warm_run_matches_reference(world):
    """A sampled trace keeps the fast path: ``dispatch`` (not ``compile``)
    on a warm run, the ``device_wait`` readback, zero-time step spans."""
    eng, ref = _engines(world)
    _pinned(eng, ref, LUBM_QUERIES["Q9"])
    for e in (eng, ref):
        e.query(LUBM_QUERIES["Q9"])
    got = eng.query(LUBM_QUERIES["Q9"], trace=Trace(sampled=True))
    want = ref.query(LUBM_QUERIES["Q9"], trace=RefTrace(sampled=True))
    assert_same_tree(got.stats["trace"]["root"],
                     want.stats["trace"]["root"])
    t = got.stats["trace_obj"]
    assert t.find("dispatch") and not t.find("compile")
    assert t.find("device_wait")
    assert all(s.dur == 0.0 for s in t.find("step"))


def test_batch_trace_lanes_match_reference_stats(world):
    """The reference traces no batch; each lane span of the port's 3-lane
    batch must carry the reference lane's own step counters and kernels,
    and the reference roofline's ``cpu`` model time for them."""
    eng, ref = _engines(world)
    (_, maps), _ = world
    courses = [t for t in maps.dict.terms.to_str
               if re.match(r"ub:GraduateCourse\d", t)][:3]
    queries = [TMPL_COURSE.format(c=c) for c in courses]
    pqs, rpqs = ([f(q) for q in queries]
                 for f in (parameterize_query, ref_pq))
    fam, rfam = eng.compile_param(pqs[0]), ref.compile_param(rpqs[0])
    consts = [pq.consts for pq in pqs]
    t = Trace(sampled=True)
    got = eng.execute_param_batch(fam, consts, trace=t)
    want = ref.execute_param_batch(rfam, [pq.consts for pq in rpqs])
    t.finish()
    (execute,) = t.root.children
    assert execute.name == "execute" and execute.meta == {"branches": 1,
                                                          "lanes": 3}
    names = [c.name for c in execute.children]
    assert names == ["compile", "device_wait", "lane", "lane", "lane"]
    assert execute.children[0].meta == {"lanes": 4}
    plan = fam.plan
    dg = eng.executor.dg
    for lane, g, w in zip(execute.children[2:], got, want):
        assert g.count == w.count
        np.testing.assert_array_equal(g.rows, w.rows)
        wb = w.stats["exec"]["branches"][0]["base"]
        assert lane.meta["index"] == execute.children.index(lane) - 2
        steps = lane.children
        assert [s.meta["kernel"] for s in steps] == wb["step_kernels"]
        assert [s.meta["rows"] for s in steps] == wb["step_rows"]
        assert [s.meta["kept"] for s in steps] == wb["step_kept"]
        assert [s.meta["retries"] for s in steps] == wb["step_retries"]
        rows_in = 1.0 * plan.start_candidates.shape[0]
        for si, s in enumerate(steps):
            assert s.meta["capacity"] > 0 and s.dur == 0.0
            if "prune_in" in s.meta:
                assert s.meta["prune_in"] == wb["step_prune_in"][si]
                assert s.meta["prune_out"] == wb["step_prune_out"][si]
            model = ref_roofline.estimate_step_ms(
                wb["step_kernels"][si], backend="cpu",
                expanded=wb["step_rows"][si], rows=rows_in,
                capacity=s.meta["capacity"], nq=plan.query.n_vertices,
                bitmap_words=int(dg.arrays["label_bitmap"].shape[1]),
                n_iters=dg.max_log_deg)["model_ms"]
            assert s.meta["model_ms"] == pytest.approx(round(model, 6),
                                                       rel=1e-9)
            rows_in = float(wb["step_kept"][si])


# ------------------------------------------------------- workload profiles
PROFILED = ("Q1", "Q2", "Q4", "Q7", "Q9")


def test_workload_profiles_match_reference(world):
    eng, ref = _engines(world)
    profs = {name: (WorkloadProfile("lubm", name),
                    RefProfile("lubm", name)) for name in PROFILED}
    for _ in range(2):
        for name in PROFILED:
            got, want = _pinned(eng, ref, LUBM_QUERIES[name])
            gr, wr = eng.execute_compiled(got), ref.execute_compiled(want)
            gb = gr.stats["exec"]["branches"][0]["base"]
            wb = wr.stats["exec"]["branches"][0]["base"]
            assert _strip(gb) == _strip(wb), name
            p, rp = profs[name]
            p.fold(got.branches[0].plan, gb, count=gr.count, wall_ms=1.0,
                   fingerprint=got.fingerprint)
            rp.fold(want.branches[0].plan, wb, count=wr.count, wall_ms=1.0,
                    fingerprint=want.fingerprint)
            # the port's profile folds the reference's stats the same way
            cross = WorkloadProfile("lubm", name)
            cross.fold(want.branches[0].plan, wb, count=wr.count,
                       wall_ms=1.0)
            assert cross.observed_fanouts() == RefProfile(
                "lubm", name).observed_fanouts() or cross.runs == 1
    for name, (p, rp) in profs.items():
        assert p.snapshot() == rp.snapshot(), name
        assert p.observed_fanouts() == rp.observed_fanouts(), name
        assert p.median_qerror() == rp.median_qerror()


def test_profiler_journal_and_replan_hint_match_reference(world):
    eng, ref = _engines(world)
    pkgs = ((WorkloadProfiler, DecisionJournal, eng),
            (RefProfiler, RefJournal, ref))
    outs = []
    for prof_cls, journal_cls, e in pkgs:
        journal = journal_cls(size=8)
        prof = prof_cls(feedback=True, qerror_threshold=1.5, min_runs=2,
                        max_profiles=4, journal=journal)
        hints = []
        for _ in range(3):
            for name in PROFILED[1:]:
                text = LUBM_QUERIES[name]
                c = e.compile_canonical(
                    canonicalize_query(parse_sparql(text)) if e is eng
                    else ref_canon(ref_parse(text)))
                e.executor._small_mode[c.branches[0].plan.signature()] = False
                r = e.execute_compiled(c)
                base = r.stats["exec"]["branches"][0]["base"]
                hint = prof.observe("lubm", c.fingerprint,
                                    c.branches[0].plan, base, count=r.count,
                                    wall_ms=1.0, fingerprint=c.fingerprint)
                journal.record("execute", query=name, count=r.count)
                if hint is not None:
                    hints.append(hint)
        entries = [{k: v for k, v in en.items() if k != "t"}
                   for en in journal.snapshot(kind="execute", limit=5)]
        outs.append((hints, prof.snapshot(), prof.evictions,
                     dict(journal.counts), entries, len(journal)))
    assert outs[0][0], "no replan hint on misestimated LUBM shapes"
    assert outs[0] == outs[1]
    assert qerror(99, 9) == pytest.approx(10.0)
    assert qerror_log10(99, 9) == pytest.approx(1.0)


def test_describe_compiled_qerror_columns_match_reference(world):
    eng, ref = _engines(world)
    for name in ("Q2", "Q9", "Q13"):
        got, want = _pinned(eng, ref, LUBM_QUERIES[name])
        gr, wr = eng.execute_compiled(got), ref.execute_compiled(want)
        gd = eng.describe_compiled(got, run_stats=gr.stats)
        wd = ref.describe_compiled(want, run_stats=wr.stats)
        assert _strip(gd) == _strip(wd), name
        steps = gd["branches"][0]["steps"]
        assert steps and all(s["q_error"] >= 1.0 for s in steps)


# ---------------------------------------------------------------- feedback
@pytest.mark.parametrize("qname,fans", [("Q2", (1e-4, 50.0, 3.0)),
                                        ("Q7", (1e6,)),
                                        ("Q9", (0.5, 2.0))])
def test_feedback_replans_like_reference(world, qname, fans):
    eng, ref = _engines(world)
    text = LUBM_QUERIES[qname]
    canon, rcanon = canonicalize_query(parse_sparql(text)), \
        ref_canon(ref_parse(text))
    base = eng.execute_compiled(eng.compile_canonical(canon))
    plan = eng.compile_canonical(canon).branches[0].plan
    fanouts = {}
    for i, step in enumerate(plan.steps):
        if step.parent >= 0:
            f = fans[i % len(fans)]
            fanouts[(int(step.u), int(step.parent), int(step.elabel),
                     bool(step.forward))] = (f, f)
    assert eng.apply_feedback(canon.fingerprint, fanouts) == \
        ref.apply_feedback(rcanon.fingerprint, fanouts) == 1
    got, want = eng.compile_canonical(canon), ref.compile_canonical(rcanon)
    gp, wp = got.branches[0].plan, want.branches[0].plan
    assert gp.search == wp.search and gp.search.endswith("+fb1")
    assert gp.order == wp.order
    assert list(gp.est_rows) == pytest.approx(list(wp.est_rows), rel=1e-9)
    gr, wr = eng.execute_compiled(got), ref.execute_compiled(want)
    assert gr.count == wr.count == base.count
    np.testing.assert_array_equal(gr.rows, wr.rows)
    assert sorted(map(tuple, gr.rows.tolist())) == \
        sorted(map(tuple, base.rows.tolist()))
    assert eng.feedback_snapshot() == {canon.fingerprint: 1}
    assert eng.apply_feedback(canon.fingerprint, fanouts) == 2
    eng.clear_feedback()
    assert eng.feedback_snapshot() == {}
    assert not eng.compile_canonical(canon).branches[0].plan.search \
        .endswith("+fb2")


# ------------------------------------------------------------------ report
def test_report_matches_reference():
    prof = [{"dataset": "lubm", "plan_key": "k", "fingerprint": "fp",
             "search": "dp+fb1", "runs": 4, "rows_total": 40,
             "wall_ms_total": 8.0, "last_wall_ms": 2.0,
             "q_error_median": 12.5, "q_error_max": 30.0,
             "e2e_q_error_median": 3.0,
             "kernels": {"expand_filter": 4, "ragged_expand": 2},
             "degraded": {"0": 4}, "resumes": 1, "compiles": 2,
             "retries": 1, "batched_runs": 0, "batch_fill_avg": None,
             "cancels": 0, "replans": 1, "feedback_version": 1,
             "steps": [{"est_rows": 10.0, "obs_rows": 5.0,
                        "q_error_median": 1.8, "retries": 0,
                        "obs_fanout": 0.5, "prune_ratio": 0.25}]}]
    workload = {"profiles": prof, "feedback": {"lubm": {"fp": 1}},
                "decisions": {"replan": 1, "execute": 4},
                "feedback_enabled": True}
    slow = {"slow": {"lubm": [{"fingerprint": "fp", "wall_ms": 9.5,
                                "count": 3, "trace_id": 1}]}}
    got = build_report(workload=workload, slow=slow)
    want = ref_build_report(workload=workload, slow=slow)
    assert got == want
    assert render_markdown(got) == ref_render(want)
