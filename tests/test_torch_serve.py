"""The serving path: the port against the reference.

Metrics text, the scheduler (against a duck-typed registry, as
``tests/test_serve.py`` drives it), the HTTP server and the launcher.  Both
packages host the same LUBM graph (scale 1, density 0.3, seed 0) — the
port's registry on the CPU — and answer the same requests; status codes
and bodies must be equal, apart from correlation ids, wall times and the
one ``/metrics`` help text that names the reference's compiler.  A stress
test drives one port registry from more threads than workers, with a short
switch interval, and every answer must equal the reference engine's.
"""

import json
import re
import sys
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import urlencode

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import SparqlEngine as RefEngine  # noqa: E402
from repro.core import exec as ref_exec  # noqa: E402
from repro.core.sparql_exec import QueryResult as RefResult  # noqa: E402
from repro.obs import Trace as RefTrace  # noqa: E402
from repro.rdf.generator import generate_lubm as ref_generate_lubm  # noqa: E402
from repro.rdf.transform import \
    type_aware_transform as ref_type_aware_transform  # noqa: E402
from repro.rdf.workloads import LUBM_QUERIES  # noqa: E402
from repro.serve import cache as ref_cache  # noqa: E402
from repro.serve import metrics as ref_metrics  # noqa: E402
from repro.serve import scheduler as ref_sched  # noqa: E402
from repro.serve import server as ref_server  # noqa: E402
from repro_torch.core import exec as port_exec  # noqa: E402
from repro_torch.core.sparql_exec import QueryResult  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.obs import Trace  # noqa: E402
from repro_torch.rdf.generator import generate_lubm  # noqa: E402
from repro_torch.rdf.transform import type_aware_transform  # noqa: E402
from repro_torch.serve import cache, metrics, scheduler, server  # noqa: E402

PORT = (metrics, scheduler, server, cache, QueryResult, Trace)
REF = (ref_metrics, ref_sched, ref_server, ref_cache, RefResult, RefTrace)

Q2_RENAMED = """SELECT ?a ?b ?c WHERE {
  ?a ub:undergraduateDegreeFrom ?b .
  ?c rdf:type ub:Department .
  ?a rdf:type ub:GraduateStudent .
  ?a ub:memberOf ?c .
  ?b rdf:type ub:University .
  ?c ub:subOrganizationOf ?b .
}"""

TMPL_COURSE = """SELECT ?x WHERE {{
  ?x rdf:type ub:GraduateStudent .
  ?x ub:takesCourse {c} .
}}"""

# the help text that differs: the port builds chunk programs, the reference
# compiles them with XLA
COMPILE_HELP = "# HELP repro_compile_events_total "


@pytest.fixture(scope="module")
def world():
    """Both packages' LUBM graph and maps, each built here.  The session's
    ``lubm_graph`` maps can be grown by any earlier test (a store interns
    its new terms into them, and the reference's store then resumes from
    the grown id space), and these tests compare vertex counts, ids and
    bodies."""
    rg, rmaps = ref_type_aware_transform(
        ref_generate_lubm(scale=1, seed=0, density=0.3).finalize())
    g, maps = type_aware_transform(
        generate_lubm(scale=1, seed=0, density=0.3).finalize())
    return (g, maps), (rg, rmaps)


# ----------------------------------------------------------------- metrics
def _drive_metrics(mod, cache_mod, trace_cls) -> str:
    m = mod.ServeMetrics()
    for i, (ds, status) in enumerate([("lubm", "ok"), ("lubm", "ok"),
                                      ("live", "timeout"), ("lubm", "error"),
                                      ("live", "ok")]):
        m.record(ds, status, 0.5 + 7.0 * i)
    for ms in (0.2, 3.0, 41.0):
        m.record_plan_search(ms)
    for est, act in ((10.0, 3), (0.0, 0), (5000.0, 12)):
        m.record_cardinality(est, act)
        m.record_step_cardinality(est * 2, act)
    m.coalesced.inc(3)
    m.decisions.inc(kind="plan_cache")
    m.decisions.inc(2, kind="batch")
    m.feedback_replans.inc()
    m.exec_retries.inc(4)
    m.prune_candidates_in.inc(100)
    m.prune_candidates_out.inc(40)
    m.compile_events.inc(2)
    m.batch_size.observe(1)
    m.batch_size.observe(64)
    m.coalesced_queries.inc(64)
    m.cancelled.inc()
    m.degraded.inc()
    m.updates.inc(dataset="live", status="ok")
    m.update_triples.inc(2, dataset="live", op="insert")
    m.update_latency.observe(12.5)
    m.compactions.inc()
    m.slow_queries.inc(dataset="lubm")
    m.dataset_inflight.inc("lubm")
    m.dataset_inflight.inc("lubm")
    m.dataset_inflight.dec("lubm")
    m.inflight.inc()
    for profiled in (True, False):
        t = trace_cls("q", profile_steps=profiled, sampled=not profiled)
        t.add("parse", 0.0004)
        t.add("execute", 0.012)
        t.root.children[-1].children.append(
            type(t.root)("step", 0.0, {"kernel": "expand_filter"}))
        m.record_trace(t)
    pc, rc = cache_mod.PlanCache(4), cache_mod.ResultCache(2)
    pc.put("a", 1)
    pc.get("a")
    pc.get("b")
    m.attach_cache_gauges("lubm", pc, rc)
    return m.registry.render()


def test_metrics_text_matches_reference():
    got = _drive_metrics(metrics, cache, Trace).splitlines()
    want = _drive_metrics(ref_metrics, ref_cache, RefTrace).splitlines()
    assert len(got) == len(want) > 100

    def keep(line):
        # the QPS gauge reads the clock
        return not line.startswith(("repro_qps ", COMPILE_HELP))

    assert [x for x in got if keep(x)] == [x for x in want if keep(x)]
    assert [x for x in got if x.startswith("repro_qps ")]
    (help_line,) = [x for x in got if x.startswith(COMPILE_HELP)]
    assert "XLA" not in help_line and "chunk-program builds" in help_line


# --------------------------------------------------- scheduler (stub registry)
class _StubRegistry:
    """Registry double whose execution blocks until released."""

    def __init__(self, result_cls, unknown):
        self.result_cls, self.unknown = result_cls, unknown
        self.release = threading.Event()
        self.calls = []
        self.lock = threading.Lock()
        self.block = False

    def version(self, name):
        if name == "missing":
            raise self.unknown(name)
        return 0

    def execute_canonical(self, name, canon, version):
        with self.lock:
            self.calls.append(canon.fingerprint)
        if self.block and not self.release.wait(10.0):
            raise RuntimeError("stub never released")
        variables = canon.query.select or ["v0"]
        rows = np.arange(len(variables), dtype=np.int32)[None, :]
        return self.result_cls(list(variables), rows,
                               ["vertex"] * len(variables), count=1)


def _coalesce(pkg) -> dict:
    mod_m, mod_s, mod_srv, _, result_cls, _ = pkg
    reg = _StubRegistry(result_cls, mod_srv.UnknownDataset)
    reg.block = True
    sched = mod_s.Scheduler(reg, workers=2,
                            metrics=mod_m.ServeMetrics()).start()
    try:
        results, errors = [], []

        def client(q):
            try:
                results.append(sched.submit("d", q, timeout_s=10.0))
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        q1 = "SELECT ?x ?y WHERE { ?x ub:advisor ?y . }"
        q2 = "SELECT ?a ?b WHERE { ?a ub:advisor ?b . }"
        threads = [threading.Thread(target=client, args=(q,))
                   for q in (q1, q2, q1, q2)]
        for t in threads:
            t.start()
        deadline = time.time() + 5.0
        while sched.metrics.coalesced.total() < 3 and time.time() < deadline:
            time.sleep(0.01)
        reg.release.set()
        for t in threads:
            t.join(timeout=10.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        reg.release.set()
        sched.stop()
    return {"errors": errors, "results": len(results),
            "calls": len(reg.calls),
            "coalesced": sched.metrics.coalesced.total(),
            "names": sorted(tuple(r.variables) for r in results),
            "ok": sched.metrics.requests.value(dataset="d", status="ok")}


def _overload(pkg) -> dict:
    mod_m, mod_s, mod_srv, _, result_cls, _ = pkg
    reg = _StubRegistry(result_cls, mod_srv.UnknownDataset)
    reg.block = True
    sched = mod_s.Scheduler(reg, workers=1, max_queue=1,
                            metrics=mod_m.ServeMetrics()).start()
    out = {}
    try:
        occupy = threading.Thread(target=lambda: sched.submit(
            "d", "SELECT ?x WHERE { ?x rdf:type ub:A . }", timeout_s=10.0))
        occupy.start()
        deadline = time.time() + 5.0
        while not reg.calls and time.time() < deadline:
            time.sleep(0.01)
        queued = threading.Thread(target=lambda: sched.submit(
            "d", "SELECT ?x WHERE { ?x rdf:type ub:B . }", timeout_s=10.0))
        queued.start()
        deadline = time.time() + 5.0
        while sched._queue.qsize() < 1 and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(mod_s.Overloaded) as ei:
            sched.submit("d", "SELECT ?x WHERE { ?x rdf:type ub:C . }")
        out["overloaded"] = (str(ei.value),
                             0.5 <= ei.value.retry_after_s <= 30.0)
        reg.release.set()
        occupy.join(timeout=10.0)
        queued.join(timeout=10.0)
        assert not occupy.is_alive() and not queued.is_alive()
        out["requests"] = {s: sched.metrics.requests.value(dataset="d",
                                                           status=s)
                           for s in ("ok", "overloaded")}
    finally:
        reg.release.set()
        sched.stop()
    return out


def _errors(pkg) -> dict:
    mod_m, mod_s, mod_srv, _, result_cls, _ = pkg
    reg = _StubRegistry(result_cls, mod_srv.UnknownDataset)
    sched = mod_s.Scheduler(reg, workers=1, metrics=mod_m.ServeMetrics())
    with pytest.raises(mod_s.SchedulerStopped):
        sched.submit("d", "SELECT ?x WHERE { ?x rdf:type ub:A . }")
    with sched:
        with pytest.raises(mod_srv.UnknownDataset):
            sched.submit("missing", "SELECT ?x WHERE { ?x rdf:type ub:A . }")
        sched.submit("d", "SELECT ?x WHERE { ?x rdf:type ub:Student . }")
        sched.submit("d", "SELECT ?x WHERE { ?x rdf:type ub:Course . }")
    reg.block = True
    sched = mod_s.Scheduler(reg, workers=1,
                            metrics=mod_m.ServeMetrics()).start()
    try:
        with pytest.raises(mod_s.DeadlineExceeded):
            sched.submit("d", "SELECT ?x WHERE { ?x rdf:type ub:A . }",
                         timeout_s=0.15)
        timeouts = sched.metrics.requests.value(dataset="d",
                                                status="timeout")
    finally:
        reg.release.set()
        sched.stop()
    return {"distinct_calls": len(set(reg.calls)), "timeouts": timeouts}


@pytest.mark.parametrize("scenario", [_coalesce, _overload, _errors])
def test_scheduler_matches_reference(scenario):
    got, want = scenario(PORT), scenario(REF)
    assert got == want
    if scenario is _coalesce:
        assert got["calls"] == 1 and got["coalesced"] == 3
        assert got["names"] == sorted([("x", "y"), ("a", "b")] * 2)


# ------------------------------------------------------------------- HTTP
@pytest.fixture(scope="module")
def servers(world):
    """The port's and the reference's servers, each hosting a static and
    an updatable copy of the same graph.  The small-plan probe picks a
    configuration by timing, so it is off in both while they serve: the
    journals, profiles and stats then compare exactly."""
    (g, maps), (rg, rmaps) = world
    mp = pytest.MonkeyPatch()
    for mod in (port_exec, ref_exec):
        mp.setattr(mod, "_small_plan", lambda plan, opts: False)
    out = []
    for mod, kw, graph, gmaps in ((server, {"device": "cpu"}, g, maps),
                                  (ref_server, {}, rg, rmaps)):
        reg = mod.DatasetRegistry(**kw)
        reg.register("lubm", graph, gmaps)
        reg.register("live", graph, gmaps, updatable=True)
        srv = mod.make_server(reg, port=0, workers=2,
                              default_timeout_s=60.0)
        mod.serve_in_thread(srv)
        out.append(srv)
    try:
        yield out
    finally:
        for srv in out:
            srv.shutdown()
            srv.scheduler.stop()
            srv.server_close()
        mp.undo()


def _request(srv, method, path, body=None, ctype=None):
    host, port = srv.server_address[:2]
    headers = {"Content-Type": ctype} if ctype else {}
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", method=method, headers=headers,
        data=body.encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, hdrs, raw = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, dict(e.headers), e.read()
    ctype_out = hdrs.get("Content-Type", "")
    data = json.loads(raw) if "json" in ctype_out else raw.decode()
    return status, "X-Repro-Query-Id" in hdrs, data


VOLATILE = {"query_id", "queue_wait_ms", "exec_ms", "plan_ms", "build_ms",
            "recorded_at", "t", "wall_ms", "seq", "id", "trace_id",
            "wall_ms_total", "last_wall_ms"}


def _norm(obj):
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


def _q(query, **kw):
    return "/sparql?" + urlencode({"query": query, **kw})


# (method, path, body, content type, expected status)
HTTP_CASES = [
    ("GET", _q(LUBM_QUERIES["Q1"]), None, None, 200),
    ("GET", _q(LUBM_QUERIES["Q2"], dataset="lubm"), None, None, 200),
    ("GET", _q(Q2_RENAMED), None, None, 200),
    ("GET", _q(LUBM_QUERIES["Q9"], limit=5), None, None, 200),
    ("POST", "/sparql", json.dumps({"query": LUBM_QUERIES["Q6"],
                                    "dataset": "lubm", "limit": 3}),
     "application/json", 200),
    ("POST", "/sparql", "SELECT ?x ?v WHERE { ?x rdf:type ub:Student . "
     "?x ub:age ?v . FILTER (?v >= 0) }", "text/plain", 200),
    ("POST", "/sparql?dataset=live", LUBM_QUERIES["Q8"],
     "application/sparql-query", 200),
    ("POST", "/sparql", urlencode({"query": LUBM_QUERIES["Q4"]}),
     "application/x-www-form-urlencoded", 200),
    ("GET", _q(LUBM_QUERIES["Q2"], explain=1), None, None, 200),
    ("GET", _q(LUBM_QUERIES["Q7"], explain="analyze"), None, None, 200),
    ("POST", "/update?dataset=live", "INSERT DATA { "
     "ub:HttpStudent rdf:type ub:GraduateStudent . "
     "ub:HttpStudent ub:takesCourse ub:HttpCourse . }",
     "application/sparql-update", 200),
    ("GET", _q("SELECT ?x WHERE { ?x rdf:type ub:GraduateStudent . "
               "?x ub:takesCourse ub:HttpCourse . }", dataset="live"),
     None, None, 200),
    ("POST", "/update", json.dumps({
        "dataset": "live", "update": "DELETE DATA { ub:HttpStudent "
        "ub:takesCourse ub:HttpCourse . }"}), "application/json", 200),
    ("GET", _q("SELECT ?x WHERE { ?x rdf:type ub:GraduateStudent . "
               "?x ub:takesCourse ub:HttpCourse . }", dataset="live"),
     None, None, 200),
    ("POST", "/update?dataset=live",
     "INSERT DATA { ub:CurlS ub:advisor ub:CurlO . }",
     "application/x-www-form-urlencoded", 200),
    ("GET", _q("SELECT nonsense {{{"), None, None, 400),
    ("GET", _q("SELECT nonsense {{{", explain=1), None, None, 400),
    ("GET", _q(LUBM_QUERIES["Q1"], dataset="nope"), None, None, 404),
    ("GET", "/bogus", None, None, 404),
    ("POST", "/bogus", "x", "text/plain", 404),
    ("POST", "/update?dataset=lubm",
     "INSERT DATA { ub:a ub:p ub:b . }", "application/sparql-update", 409),
    ("POST", "/update?dataset=live", "DELETE WHERE { ?s ?p ?o }",
     "application/sparql-update", 400),
    ("POST", "/update?dataset=live", "", "application/sparql-update", 400),
    ("POST", "/update?dataset=nope", "INSERT DATA { ub:a ub:p ub:b . }",
     "application/sparql-update", 404),
    ("POST", "/sparql", "[1]", "application/json", 400),
    ("GET", "/sparql", None, None, 400),
    ("GET", "/debug/trace?id=987654", None, None, 404),
    ("GET", "/debug/trace", None, None, 400),
    ("GET", "/debug/workload?limit=x", None, None, 400),
    ("GET", "/debug/decisions?limit=x", None, None, 400),
    ("GET", "/debug/slow?dataset=nope", None, None, 404),
    ("GET", "/debug/slow", None, None, 200),
]


def test_http_bodies_and_codes_match_reference(servers):
    port_srv, ref_srv = servers
    for method, path, body, ctype, code in HTTP_CASES:
        got = _request(port_srv, method, path, body, ctype)
        want = _request(ref_srv, method, path, body, ctype)
        case = (method, path[:60], code)
        assert got[0] == want[0] == code, case
        assert got[1] == want[1], case
        assert _norm(got[2]) == _norm(want[2]), case
    # the decision journal, the workload profiles and the health report
    # saw the same requests
    g, w = (_norm(_request(s, "GET", "/debug/decisions?limit=500")[2])
            for s in servers)
    assert g["counts"] == w["counts"]
    assert len(g["decisions"]) == len(w["decisions"])
    for i, (a, b) in enumerate(zip(g["decisions"], w["decisions"])):
        assert a == b, i
    g, w = (_norm(_request(s, "GET", "/debug/workload?limit=50")[2])
            for s in servers)
    assert g == w
    g, w = (_request(s, "GET", "/healthz")[2] for s in servers)
    assert g["status"] == w["status"] == "ok"
    for name in ("lubm", "live"):
        gd, wd = _norm(g["datasets"][name]), _norm(w["datasets"][name])
        assert set(gd) == set(wd)
        # the reference's retry ladder also counts the transient faults its
        # XLA compiles can meet on a loaded machine: its counters are the
        # host's, so only their names compare; the port's stay at zero
        gr, wr = gd.pop("resilience"), wd.pop("resilience")
        assert set(gr) == set(wr)
        assert gr["fault_retries"] == gr["escalations"] == 0
        for key in gd:
            assert gd[key] == wd[key], (name, key)
    assert set(g["scheduler"]) == set(w["scheduler"])
    assert g["scheduler"]["requests"] == w["scheduler"]["requests"]


def test_http_metrics_counters_match_reference(servers):
    for s in servers:
        for name in ("Q1", "Q2", "Q9"):
            assert _request(s, "GET", _q(LUBM_QUERIES[name]))[0] == 200

    def counters(srv):
        text = _request(srv, "GET", "/metrics")[2]
        out = {}
        for line in text.splitlines():
            if line.startswith("#") or not line:
                continue
            key, val = line.rsplit(" ", 1)
            if key.startswith(("repro_requests_total", "repro_plan_cache",
                               "repro_decisions_total", "repro_updates",
                               "repro_update_triples", "repro_coalesced",
                               "repro_param_family", "repro_result_cache",
                               "repro_exec_step_retries",
                               "repro_prune_candidates")):
                out[key] = float(val)
        return out

    got, want = (counters(s) for s in servers)
    assert got == want
    assert got['repro_requests_total{dataset="lubm",status="ok"}'] > 0


def test_http_forced_trace_matches_reference(servers):
    outs = [_request(s, "GET", _q(LUBM_QUERIES["Q9"], trace=1, dataset="lubm"))
            for s in servers]
    (gs, gh, g), (ws, wh, w) = outs
    assert gs == ws == 200 and gh and wh
    gt, wt = g.pop("trace"), w.pop("trace")
    assert _norm(g) == _norm(w)

    def names(span):
        return (span["name"], [names(c) for c in span.get("children", [])])

    assert names(gt["root"]) == names(wt["root"])
    steps = [c for c in gt["root"]["children"] if c["name"] == "execute"]
    assert steps and gt["profiled"] and gt["dataset"] == "lubm"


# the reference scheduler's two deadline texts: the waiter's own timeout,
# and a worker failing a flight whose deadline passed while it was queued
WAITED_OUT = "no result within 0.001s"
EXPIRED_QUEUED = "expired while queued (admission backlog)"


def test_http_deadline_on_uncompiled_query_is_504(servers):
    """A deadline of 1 ms on a query not compiled yet: 504 from both,
    whether it expired while queued or while it ran (the wall clock
    decides which, and so which of the scheduler's two deadline texts the
    body carries and what the journal and counters saw: this runs after
    every comparison of them)."""
    path = _q(LUBM_QUERIES["Q5"], timeout_ms=1)
    got, want = (_request(s, "GET", path) for s in servers)
    assert got[0] == want[0] == 504
    for body in (got[2], want[2]):
        msg = body["error"]
        assert msg.startswith(WAITED_OUT) or msg == EXPIRED_QUEUED, msg
    assert set(got[2]) == set(want[2])


def _expire_in_queue(srv, path):
    """Send ``path`` while every scheduler worker is held inside an
    execution, and hold the submitting thread just after it queued its
    flight: the deadline passes in the queue, the workers are freed, one
    of them fails the expired flight, and only then does the submitter
    wait for it.  Returns the response."""
    sched = srv.scheduler
    reg = sched.registry
    n = sched._n_workers
    release, armed = threading.Event(), threading.Event()
    entered = threading.Semaphore(0)
    mp = pytest.MonkeyPatch()

    def held(fn):
        def run(*args, **kwargs):
            entered.release()
            assert release.wait(60), "the held workers were never freed"
            return fn(*args, **kwargs)
        return run

    gauge = sched.metrics.inflight
    inc = gauge.inc

    def inc_after_queueing(amount=1.0):
        if amount > 0 and armed.is_set():
            armed.clear()
            time.sleep(0.05)  # the 1 ms deadline passes in the queue
            release.set()
            t_end = time.monotonic() + 60
            while sched._inflight and time.monotonic() < t_end:
                time.sleep(0.005)
        inc(amount)

    mp.setattr(reg, "execute_canonical", held(reg.execute_canonical))
    mp.setattr(reg, "execute_canonical_batch",
               held(reg.execute_canonical_batch))
    mp.setattr(gauge, "inc", inc_after_queueing)
    holders = [threading.Thread(target=sched.submit, args=(
        "lubm", LUBM_QUERIES[name]), kwargs={"timeout_s": 60})
        for name in ("Q1", "Q3", "Q4", "Q7")[:n]]
    try:
        for t in holders:
            t.start()
        for _ in range(n):
            assert entered.acquire(timeout=60), "a worker never took work"
        armed.set()
        return _request(srv, "GET", path)
    finally:
        release.set()
        for t in holders:
            t.join(timeout=60)
        mp.undo()
        assert not any(t.is_alive() for t in holders)


def test_http_deadline_expired_in_queue_is_504(servers):
    """With the workers held, a 1 ms request certainly expires while
    queued: both servers answer 504 with the queue's deadline text."""
    path = _q(LUBM_QUERIES["Q5"], timeout_ms=1)
    got, want = (_expire_in_queue(s, path) for s in servers)
    assert got[0] == want[0] == 504
    assert got[2]["error"] == want[2]["error"] == EXPIRED_QUEUED
    assert set(got[2]) == set(want[2])


# --------------------------------------------------------------- launcher
def test_launcher_workload_mode_on_cpu(world, capsys):
    launch_serve.main(["--dataset", "lubm", "--scale", "1", "--density",
                       "0.3", "--queries", "Q1,Q2,Q9", "--repeat", "2",
                       "--clients", "2", "--workers", "2", "--device", "cpu",
                       "--json"])
    out = capsys.readouterr().out.strip().splitlines()
    doc = json.loads(out[-1])
    (_, _), (rg, rmaps) = world
    ref = RefEngine(rg, rmaps)
    for name in ("Q1", "Q2", "Q9"):
        assert doc["queries"][f"lubm.{name}"]["count"] == \
            ref.count(LUBM_QUERIES[name]), name
    assert doc["service"]["requests"] == 6
    assert doc["datasets"]["lubm"]["plan_cache"]["hits"] == 3


# ------------------------------------------------------ threads on one engine
def test_concurrent_clients_answer_like_reference(world):
    """Eight client threads and four workers on one CPU registry, with
    family members that batch and plain queries that coalesce: every
    answer equals the reference engine's, and the executor's learned
    capacity schedules stay monotone under the races."""
    (g, maps), (rg, rmaps) = world
    ref = RefEngine(rg, rmaps)
    courses = [t for t in maps.dict.terms.to_str
               if re.match(r"ub:GraduateCourse\d", t)][:8]
    texts = ([LUBM_QUERIES[n] for n in ("Q1", "Q2", "Q4", "Q7", "Q9", "Q13")]
             + [TMPL_COURSE.format(c=c) for c in courses])
    want = {}
    for t in texts:
        r = ref.query(t)
        want[t] = (r.count, sorted(map(tuple, np.asarray(r.rows).tolist())))
    reg = server.DatasetRegistry(device="cpu")
    ds = reg.register("lubm", g, maps)
    sched = scheduler.Scheduler(reg, workers=4, batch_max=16,
                                batch_window_ms=50.0,
                                metrics=reg.metrics).start()
    got, errors = [], []
    start = threading.Barrier(8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(k):
            try:
                start.wait(timeout=30)
                for t in texts[k:] + texts[:k]:
                    r = sched.submit("lubm", t, timeout_s=120.0)
                    got.append((t, r.count, sorted(map(tuple,
                                                       r.rows.tolist()))))
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        sched.stop()
    assert not errors
    assert len(got) == 8 * len(texts)
    for t, count, rows in got:
        assert (count, rows) == want[t]
    ex = ds.engine.executor
    for key, caps in ex._caps_cache.items():
        assert all(c >= 1 for c in caps)
    assert reg.metrics.batch_size.count >= 1
    assert reg.journal.counts["execute"] >= 6
