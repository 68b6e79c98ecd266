"""Engine parity: ``SparqlEngine`` in both packages, end to end.

The port builds its graph with its own generator and transform (held equal
to the reference's in ``test_torch_host.py``) and answers on the CPU; every
query must give the same decoded rows, in order, as the reference engine:
the LUBM/BSBM/hetero workloads, the OPTIONAL / UNION / FILTER /
DISTINCT / LIMIT / OFFSET queries of ``tests/test_sparql.py``, point and
cross-product shapes.  ``count()``, ``explain()`` (with and without
``analyze``) and the compile / execute split must agree too.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import SparqlEngine as RefEngine  # noqa: E402
from repro_torch.core import SparqlEngine  # noqa: E402
from repro_torch.rdf import generator as tgen  # noqa: E402
from repro_torch.rdf.transform import type_aware_transform  # noqa: E402
from repro_torch.rdf.workloads import (BSBM_QUERIES, HETERO_QUERIES,  # noqa: E402
                                       LUBM_QUERIES)

MAKERS = {
    "lubm": (lambda: tgen.generate_lubm(scale=1, seed=0, density=0.3),
             "lubm_graph"),
    "bsbm": (lambda: tgen.generate_bsbm(n_products=150, seed=1),
             "bsbm_graph"),
    "hetero": (lambda: tgen.generate_hetero(n_entities=400, n_types=12,
                                            n_predicates=8, avg_degree=4.0,
                                            seed=2), "hetero_graph"),
}

ADVISOR = "SELECT ?x ?y WHERE { ?x ub:advisor ?y . }"
EXTRA = {
    "lubm": {
        "limit": ADVISOR + " LIMIT 3",
        "offset": ADVISOR + " OFFSET 4",
        "limit_offset": ADVISOR + " LIMIT 2 OFFSET 1",
        "offset_past": ADVISOR + " OFFSET 100000",
        "distinct": "SELECT DISTINCT ?x WHERE { ?x ub:advisor ?y . }",
        "point": "SELECT ?x WHERE { ?x rdf:type ub:Student . }",
        "cross": "SELECT ?x ?y WHERE { ?x rdf:type ub:FullProfessor . "
                 "?y rdf:type ub:Department . }",
        "pvar": "SELECT ?x ?p ?y WHERE { ?x ub:advisor ?y . ?x ?p ?y . }",
        "missing": "SELECT ?x WHERE { ?x ub:noSuchPredicate ?y . }",
    },
    "bsbm": {
        "feature5": "SELECT ?p WHERE { ?p rdf:type b:Product . "
                    "?p b:productFeature b:Feature5 . }",
        "feature6": "SELECT ?p WHERE { ?p rdf:type b:Product . "
                    "?p b:productFeature b:Feature6 . }",
        "union_distinct": "SELECT DISTINCT ?p WHERE { { ?p rdf:type b:Product "
                          ". } UNION { ?p b:productFeature b:Feature5 . } }",
    },
    "hetero": {},
}
WORKLOAD = {"lubm": LUBM_QUERIES, "bsbm": BSBM_QUERIES,
            "hetero": HETERO_QUERIES}
CASES = [(ds, name, text) for ds, qs in WORKLOAD.items()
         for name, text in qs.items()] + \
        [(ds, name, text) for ds, qs in EXTRA.items()
         for name, text in qs.items()]


@pytest.fixture(scope="module")
def engines(request):
    cache = {}

    def get(ds):
        if ds not in cache:
            g, maps = type_aware_transform(MAKERS[ds][0]().finalize())
            rg, rmaps = request.getfixturevalue(MAKERS[ds][1])
            cache[ds] = (SparqlEngine(g, maps, device="cpu"), maps,
                         RefEngine(rg, rmaps), rmaps)
        return cache[ds]

    return get


@pytest.mark.parametrize("ds,name,text", CASES,
                         ids=[f"{d}-{n}" for d, n, _ in CASES])
def test_query_rows_and_count(engines, ds, name, text):
    eng, maps, ref, rmaps = engines(ds)
    got, want = eng.query(text), ref.query(text)
    assert got.variables == want.variables and got.kinds == want.kinds
    assert got.count == want.count
    np.testing.assert_array_equal(got.rows, want.rows)
    assert got.decode(maps) == want.decode(rmaps)
    assert eng.count(text) == ref.count(text)


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in ("plan_ms", "wall_ms", "build_ms")}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


@pytest.mark.parametrize("ds,name", [("lubm", "Q2"), ("lubm", "Q9"),
                                     ("bsbm", "B8"), ("bsbm", "B4"),
                                     ("hetero", "H5")])
def test_explain(engines, ds, name):
    eng, _, ref, _ = engines(ds)
    text = WORKLOAD[ds][name]
    assert _strip_times(eng.explain(text)) == _strip_times(ref.explain(text))
    got = _strip_times(eng.explain(text, analyze=True))
    want = _strip_times(ref.explain(text, analyze=True))
    assert got == want
    assert got["actual_rows"] == ref.count(text)


def test_compile_cache_and_execute_compiled(engines):
    eng, _, ref, _ = engines("lubm")
    q1 = "SELECT ?a ?b WHERE { ?a ub:advisor ?b . }"
    q2 = "SELECT ?s ?t WHERE { ?s ub:advisor ?t . }"  # alpha-renamed
    c1, canon1 = eng.compile(q1)
    c2, canon2 = eng.compile(q2)
    assert c1 is c2 and canon1.fingerprint == canon2.fingerprint
    res = eng.execute_compiled(c1)
    rc, _ = ref.compile(q1)
    want = ref.execute_compiled(rc)
    np.testing.assert_array_equal(res.rows, want.rows)
    again, fresh = eng.compile_canonical(canon1, with_fresh=True)
    assert again is c1 and not fresh
    desc = eng.describe_compiled(c1, run_stats=res.stats,
                                 inverse=canon1.inverse)
    rdesc = ref.describe_compiled(rc, run_stats=want.stats,
                                  inverse=canon1.inverse)
    assert _strip_times(desc) == _strip_times(rdesc)


def test_optional_unmatched_rows_are_null(engines):
    eng, maps, ref, rmaps = engines("bsbm")
    got = eng.query(BSBM_QUERIES["B9"])
    assert (got.rows < 0).any()
    assert got.decode(maps) == ref.query(BSBM_QUERIES["B9"]).decode(rmaps)


def test_timeout_cancels(engines):
    from repro_torch.resilience.cancel import QueryCancelled

    eng, _, _, _ = engines("lubm")
    with pytest.raises(QueryCancelled):
        eng.query(LUBM_QUERIES["Q2"], timeout_ms=-1.0)
