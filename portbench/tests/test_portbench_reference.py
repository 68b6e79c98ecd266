"""The plain reference, the generator, and what the harness imports.

Runs on the CPU:  python -m pytest portbench/tests -q
"""

import ast
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import bench, manifest  # noqa: E402
from portbench.gen import lubm  # noqa: E402
from portbench.reference import bgp  # noqa: E402

T, SC = "rdf:type", "rdf:subClassOf"
# a hand-built graph: two departments of one university, a chair, a
# lecturer, students of both kinds, a degree from the university
TRIPLES = [
    ("ub:FullProfessor", SC, "ub:Professor"),
    ("ub:AssociateProfessor", SC, "ub:Professor"),
    ("ub:Chair", SC, "ub:Professor"),
    ("ub:Professor", SC, "ub:Faculty"), ("ub:Lecturer", SC, "ub:Faculty"),
    ("ub:UndergraduateStudent", SC, "ub:Student"),
    ("ub:GraduateStudent", SC, "ub:Student"),
    ("ub:GraduateCourse", SC, "ub:Course"),
    ("ub:U0", T, "ub:University"), ("ub:D0", T, "ub:Department"),
    ("ub:D1", T, "ub:Department"),
    ("ub:D0", "ub:subOrganizationOf", "ub:U0"),
    ("ub:D1", "ub:subOrganizationOf", "ub:U0"),
    ("ub:P0", T, "ub:FullProfessor"), ("ub:P0", T, "ub:Chair"),
    ("ub:P1", T, "ub:AssociateProfessor"), ("ub:L0", T, "ub:Lecturer"),
    ("ub:P0", "ub:worksFor", "ub:D0"), ("ub:P1", "ub:worksFor", "ub:D0"),
    ("ub:L0", "ub:worksFor", "ub:D0"),
    ("ub:P0", "ub:name", '"P0"'), ("ub:P1", "ub:name", '"P1"'),
    ("ub:L0", "ub:name", '"L0"'),
    ("ub:P0", "ub:emailAddress", '"p0@d0"'),
    ("ub:P1", "ub:emailAddress", '"p1@d0"'),
    ("ub:P0", "ub:telephone", '"xxx"'), ("ub:P1", "ub:telephone", '"xxx"'),
    ("ub:C0", T, "ub:Course"), ("ub:C1", T, "ub:Course"),
    ("ub:G0", T, "ub:GraduateCourse"),
    ("ub:P0", "ub:teacherOf", "ub:C0"), ("ub:P1", "ub:teacherOf", "ub:C1"),
    ("ub:P1", "ub:teacherOf", "ub:G0"), ("ub:L0", "ub:teacherOf", "ub:G0"),
    ("ub:S0", T, "ub:UndergraduateStudent"),
    ("ub:S1", T, "ub:GraduateStudent"), ("ub:S2", T, "ub:GraduateStudent"),
    ("ub:S0", "ub:takesCourse", "ub:C0"), ("ub:S0", "ub:takesCourse", "ub:C1"),
    ("ub:S1", "ub:takesCourse", "ub:G0"), ("ub:S2", "ub:takesCourse", "ub:G0"),
    ("ub:S0", "ub:advisor", "ub:P0"), ("ub:S1", "ub:advisor", "ub:P1"),
    ("ub:S2", "ub:advisor", "ub:L0"),
    ("ub:S1", "ub:memberOf", "ub:D0"), ("ub:S2", "ub:memberOf", "ub:D1"),
    ("ub:S0", "ub:memberOf", "ub:D0"),
    ("ub:S1", "ub:undergraduateDegreeFrom", "ub:U0"),
    ("ub:S2", "ub:undergraduateDegreeFrom", "ub:U0"),
]
CONSTS = {"Q1": "ub:G0", "Q4": "ub:D0", "Q7": "ub:P1"}


def _graph(closure=True):
    terms = sorted({t for s, _, o in TRIPLES for t in (s, o)})
    preds = sorted({p for _, p, _ in TRIPLES})
    tid = {t: i for i, t in enumerate(terms)}
    pid = {p: i for i, p in enumerate(preds)}
    arr = np.array([(tid[s], pid[p], tid[o]) for s, p, o in TRIPLES])
    return bgp.Graph(terms, preds, arr[:, 0], arr[:, 1], arr[:, 2],
                     closure=closure), terms


def _brute(query, terms):
    """Every assignment of terms to the variables that makes each pattern
    a stated or entailed triple."""
    facts = set(TRIPLES)
    sup = {}
    for s, p, o in TRIPLES:
        if p == SC:
            sup.setdefault(s, set()).add(o)
    for s, p, o in list(TRIPLES):
        if p == T:
            todo = [o]
            while todo:
                for b in sup.get(todo.pop(), ()):
                    facts.add((s, T, b))
                    todo.append(b)
    vs = sorted({x[1:] for pat in query.patterns for x in (pat.s, pat.o)
                 if x.startswith("?")})
    out = []
    for combo in itertools.product(terms, repeat=len(vs)):
        env = dict(zip(vs, combo))

        def val(x):
            return env[x[1:]] if x.startswith("?") else x
        if all((val(p.s), p.p, val(p.o)) in facts for p in query.patterns):
            out.append(tuple(env[v] for v in query.select))
    return sorted(out)


@pytest.mark.parametrize("name", ["Q1", "Q2", "Q4", "Q7", "Q9"])
def test_reference_answers_like_brute_force(name):
    g, terms = _graph()
    text = manifest.query_text(name).replace("{{const}}",
                                             CONSTS.get(name, ""))
    q = bgp.parse(text)
    got = sorted(tuple(terms[i] for i in row) for row in g.answer(q).tolist())
    want = _brute(q, terms)
    assert got == want
    assert want, f"{name} has answers on the hand-built graph"


def test_closure_is_what_makes_q9_answer():
    g, _ = _graph(closure=False)
    assert g.answer(bgp.parse(manifest.query_text("Q9"))).shape[0] == 0


def test_parse_keeps_dotted_names_and_drops_comments():
    q = bgp.parse("# c\nSELECT ?x WHERE { ?x ub:p ub:A.B.C . ?x ub:q ?y }")
    assert q.select == ("x",)
    assert [p.o for p in q.patterns] == ["ub:A.B.C", "?y"]


def _small_cfg(name="lubm-50"):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg["universities"] = 2
    cfg["uba"]["departments"] = [2, 3]
    return cfg


def test_generation_is_a_function_of_the_seed():
    cfg = _small_cfg("lubm-50")
    a, b = lubm.generate(cfg, 2**31 + 5), lubm.generate(cfg, 2**31 + 5)
    assert a.terms == b.terms and np.array_equal(a.s, b.s) \
        and np.array_equal(a.o, b.o)
    c = lubm.generate(cfg, 2**31 + 6)
    assert not np.array_equal(a.o[:c.o.shape[0]], c.o[:a.o.shape[0]])


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert files
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, f"{f} imports {bad}"
    for f in sorted((ROOT / "portbench" / "reference").rglob("*.py")):
        assert "repro_torch" not in _imports(f), f
    assert "repro_torch" in _imports(ROOT / "portbench" / "system.py")


def test_nothing_reads_the_jax_benchmarks_folder():
    for f in sorted((ROOT / "portbench").rglob("*.py")):
        if f.parent.name == "tests":
            continue
        text = f.read_text()
        assert "benchmarks/" not in text, f


@pytest.mark.cuda
def test_cuda_cell_run_is_correct_at_a_small_size():
    """A whole run on the card at a small size (the card's runs at full
    size are the benchmark's own)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    man = manifest.load(ROOT / "BENCHMARK.json")
    cell = manifest.cell(man, "lubm-50.triangles")
    line = bench.run(man, cell["name"], 2**31 + 11, 2.0, True,
                     device="cuda", cfg=_small_cfg())
    assert line["correct"], line["checks"]
    assert manifest.check_line(man, cell["name"], True, line) == []
