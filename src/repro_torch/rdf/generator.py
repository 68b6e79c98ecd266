"""Synthetic RDF dataset generators shaped like the paper's benchmarks.

- ``generate_lubm(scale)``  — LUBM-like university data (paper Tables 2/3/7):
  regular schema, deep-ish class hierarchy, constant- and increasing-solution
  query behavior reproduced by construction (per-university subtree sizes are
  scale-invariant; the number of universities grows with scale).
- ``generate_hetero(...)``  — YAGO/BTC-like: many types, power-law degrees,
  irregular predicates (paper Tables 4/5).
- ``generate_bsbm(...)``    — BSBM-like e-commerce data with numeric literals
  and optional attributes, exercising FILTER / OPTIONAL / UNION (Table 6).

All generators are deterministic given ``seed``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.rdf.dictionary import RDF_TYPE, RDFS_SUBCLASSOF
from repro_torch.rdf.triples import TripleStore

# ---------------------------------------------------------------------------
# LUBM-like
# ---------------------------------------------------------------------------

LUBM_HIERARCHY: list[tuple[str, str]] = [
    ("ub:FullProfessor", "ub:Professor"),
    ("ub:AssociateProfessor", "ub:Professor"),
    ("ub:AssistantProfessor", "ub:Professor"),
    ("ub:Professor", "ub:Faculty"),
    ("ub:Lecturer", "ub:Faculty"),
    ("ub:Faculty", "ub:Employee"),
    ("ub:Employee", "ub:Person"),
    ("ub:UndergraduateStudent", "ub:Student"),
    ("ub:GraduateStudent", "ub:Student"),
    ("ub:Student", "ub:Person"),
    ("ub:Chair", "ub:Professor"),
    ("ub:TeachingAssistant", "ub:Person"),
    ("ub:GraduateCourse", "ub:Course"),
    ("ub:ResearchGroup", "ub:Organization"),
    ("ub:Department", "ub:Organization"),
    ("ub:University", "ub:Organization"),
]


def generate_lubm(
    scale: int = 1,
    seed: int = 0,
    density: float = 1.0,
) -> TripleStore:
    """LUBM-like generator.  ``scale`` = number of universities.

    ``density`` scales per-department entity counts (1.0 ≈ a few thousand
    triples per department, like LUBM's shape at reduced magnitude so CPU
    benchmarks stay tractable).
    """
    st = TripleStore()
    add = st.add

    for sub, sup in LUBM_HIERARCHY:
        add(sub, RDFS_SUBCLASSOF, sup)

    # degrees point into a FIXED-size university pool (like LUBM, where
    # anchored per-university content is scale-invariant and unanchored
    # query answers grow linearly with scale — paper Table 2)
    DEGREE_POOL = 5

    for u in range(scale):
        # per-university RNG stream: Univ{u}'s subtree is byte-identical at
        # every scale factor (constant-solution queries stay constant)
        rng = np.random.default_rng((seed, u))

        def d(lo: int, hi: int) -> int:
            return max(1, int(round(rng.integers(lo, hi + 1) * density)))

        def rand_univ() -> str:
            # fixed-bound draws keep the stream aligned across scale factors
            # (np's integers() uses rejection sampling, so a scale-dependent
            # bound would desynchronize Univ{u}'s content between scales);
            # 30% of degrees are from one's own university so unanchored
            # triangle/alumni queries (Q2/Q13) grow with scale while
            # anchored per-university content stays byte-identical.
            own = rng.random() < 0.3
            r = int(rng.integers(DEGREE_POOL))
            if own:
                return f"ub:Univ{u}"
            return f"ub:Univ{r % max(1, min(scale, DEGREE_POOL))}"

        univ = f"ub:Univ{u}"
        add(univ, RDF_TYPE, "ub:University")
        n_depts = d(12, 18)
        for dep in range(n_depts):
            dept = f"ub:Dept{dep}.Univ{u}"
            add(dept, RDF_TYPE, "ub:Department")
            add(dept, "ub:subOrganizationOf", univ)

            n_full = d(3, 5)
            n_assoc = d(4, 6)
            n_asst = d(3, 5)
            n_lect = d(2, 4)
            faculty: list[str] = []
            for kind, count in (
                ("FullProfessor", n_full),
                ("AssociateProfessor", n_assoc),
                ("AssistantProfessor", n_asst),
                ("Lecturer", n_lect),
            ):
                for i in range(count):
                    f = f"ub:{kind}{i}.{dept[3:]}"
                    add(f, RDF_TYPE, f"ub:{kind}")
                    add(f, "ub:worksFor", dept)
                    add(f, "ub:name", f'"{kind}{i} of {dept[3:]}"')
                    add(f, "ub:emailAddress", f'"{kind}{i}@{dept[3:]}.edu"')
                    add(f, "ub:telephone", f'"555-{u:03d}-{dep:03d}-{i:03d}"')
                    if kind != "Lecturer":
                        # degrees from random universities (within generated range)
                        add(f, "ub:undergraduateDegreeFrom", rand_univ())
                        add(f, "ub:mastersDegreeFrom", rand_univ())
                        add(f, "ub:doctoralDegreeFrom", rand_univ())
                        add(f, "ub:researchInterest", f'"Research{int(rng.integers(30))}"')
                    faculty.append(f)
            # chair: the first full professor also heads the department
            chair = faculty[0]
            add(chair, RDF_TYPE, "ub:Chair")
            add(chair, "ub:headOf", dept)

            n_courses = d(8, 12)
            n_gcourses = d(5, 8)
            courses = []
            gcourses = []
            for c in range(n_courses):
                crs = f"ub:Course{c}.{dept[3:]}"
                add(crs, RDF_TYPE, "ub:Course")
                courses.append(crs)
            for c in range(n_gcourses):
                crs = f"ub:GraduateCourse{c}.{dept[3:]}"
                add(crs, RDF_TYPE, "ub:GraduateCourse")
                gcourses.append(crs)
            for crs in courses + gcourses:
                add(rng.choice(faculty), "ub:teacherOf", crs)

            n_ugrad = d(25, 40)
            n_grad = d(8, 14)
            for i in range(n_ugrad):
                s = f"ub:UndergraduateStudent{i}.{dept[3:]}"
                add(s, RDF_TYPE, "ub:UndergraduateStudent")
                add(s, "ub:memberOf", dept)
                add(s, "ub:name", f'"UGStudent{i} of {dept[3:]}"')
                for crs in rng.choice(courses, size=min(len(courses), 3), replace=False):
                    add(s, "ub:takesCourse", str(crs))
                if rng.random() < 0.2:
                    add(s, "ub:advisor", str(rng.choice(faculty)))
            for i in range(n_grad):
                s = f"ub:GraduateStudent{i}.{dept[3:]}"
                add(s, RDF_TYPE, "ub:GraduateStudent")
                add(s, "ub:memberOf", dept)
                add(s, "ub:emailAddress", f'"gs{i}@{dept[3:]}.edu"')
                add(s, "ub:undergraduateDegreeFrom", rand_univ())
                for crs in rng.choice(gcourses, size=min(len(gcourses), 2), replace=False):
                    add(s, "ub:takesCourse", str(crs))
                adv = str(rng.choice(faculty))
                add(s, "ub:advisor", adv)
                if rng.random() < 0.25:
                    ta_course = str(rng.choice(courses))
                    add(s, RDF_TYPE, "ub:TeachingAssistant")
                    add(s, "ub:teachingAssistantOf", ta_course)

            n_groups = d(3, 6)
            for gidx in range(n_groups):
                grp = f"ub:ResearchGroup{gidx}.{dept[3:]}"
                add(grp, RDF_TYPE, "ub:ResearchGroup")
                add(grp, "ub:subOrganizationOf", dept)

            n_pubs = d(10, 20)
            for pidx in range(n_pubs):
                pub = f"ub:Publication{pidx}.{dept[3:]}"
                add(pub, RDF_TYPE, "ub:Publication")
                add(pub, "ub:publicationAuthor", str(rng.choice(faculty)))
                if rng.random() < 0.4:
                    gs = f"ub:GraduateStudent{int(rng.integers(n_grad))}.{dept[3:]}"
                    add(pub, "ub:publicationAuthor", gs)
    return st


# ---------------------------------------------------------------------------
# Heterogeneous (YAGO / BTC2012-like)
# ---------------------------------------------------------------------------


def generate_hetero(
    n_entities: int = 20000,
    n_types: int = 40,
    n_predicates: int = 25,
    avg_degree: float = 6.0,
    seed: int = 0,
    subclass_pairs: int = 15,
) -> TripleStore:
    """Irregular, power-law graph with many types — YAGO/BTC-style."""
    rng = np.random.default_rng(seed)
    st = TripleStore()
    types = [f"y:Type{t}" for t in range(n_types)]
    preds = [f"y:pred{p}" for p in range(n_predicates)]
    # shallow random class DAG
    for _ in range(subclass_pairs):
        a, b = rng.integers(n_types, size=2)
        if a != b:
            st.add(types[int(a)], RDFS_SUBCLASSOF, types[int(min(a, b))])
    # type assignment: 1–3 types, zipf-ish popularity
    type_pop = rng.zipf(1.6, size=n_entities) % n_types
    for e in range(n_entities):
        ent = f"y:e{e}"
        st.add(ent, RDF_TYPE, types[int(type_pop[e])])
        if rng.random() < 0.35:
            st.add(ent, RDF_TYPE, types[int(rng.integers(n_types))])
    # power-law out-degrees, preferential-attachment-ish targets
    n_edges = int(n_entities * avg_degree)
    src = rng.zipf(1.3, size=n_edges) % n_entities
    dst = rng.zipf(1.2, size=n_edges) % n_entities
    pe = rng.integers(n_predicates, size=n_edges)
    for i in range(n_edges):
        st.add(f"y:e{int(src[i])}", preds[int(pe[i])], f"y:e{int(dst[i])}")
    # sprinkle literals
    for e in range(0, n_entities, 7):
        st.add(f"y:e{e}", "y:label", f'"entity {e}"')
    return st


# ---------------------------------------------------------------------------
# BSBM-like (FILTER / OPTIONAL / UNION workloads)
# ---------------------------------------------------------------------------


def generate_bsbm(
    n_products: int = 2000,
    n_producers: int = 40,
    n_features: int = 60,
    n_vendors: int = 20,
    reviews_per_product: float = 3.0,
    seed: int = 0,
) -> TripleStore:
    rng = np.random.default_rng(seed)
    st = TripleStore()
    st.add("b:Product", RDFS_SUBCLASSOF, "b:Thing")
    st.add("b:Review", RDFS_SUBCLASSOF, "b:Thing")
    for pr in range(n_producers):
        st.add(f"b:Producer{pr}", RDF_TYPE, "b:Producer")
    for f in range(n_features):
        st.add(f"b:Feature{f}", RDF_TYPE, "b:ProductFeature")
    for v in range(n_vendors):
        st.add(f"b:Vendor{v}", RDF_TYPE, "b:Vendor")
        st.add(f"b:Vendor{v}", "b:country", f'"{ "US" if v % 2 else "DE" }"')
    for p in range(n_products):
        prod = f"b:Product{p}"
        st.add(prod, RDF_TYPE, "b:Product")
        st.add(prod, "b:producer", f"b:Producer{int(rng.integers(n_producers))}")
        st.add(prod, "b:label", f'"product {p}"')
        st.add(prod, "b:propertyNumeric1", f'"{int(rng.integers(1, 2000))}"')
        st.add(prod, "b:propertyNumeric2", f'"{int(rng.integers(1, 2000))}"')
        for f in rng.choice(n_features, size=int(rng.integers(2, 6)), replace=False):
            st.add(prod, "b:productFeature", f"b:Feature{int(f)}")
        # offers
        for _ in range(int(rng.integers(1, 4))):
            off = f"b:Offer{p}.{int(rng.integers(10**6))}"
            st.add(off, RDF_TYPE, "b:Offer")
            st.add(off, "b:product", prod)
            st.add(off, "b:vendor", f"b:Vendor{int(rng.integers(n_vendors))}")
            st.add(off, "b:price", f'"{float(rng.uniform(5, 500)):.2f}"')
        # reviews; rating2/homepage optional (for OPTIONAL queries)
        for r in range(int(rng.poisson(reviews_per_product))):
            rev = f"b:Review{p}.{r}"
            st.add(rev, RDF_TYPE, "b:Review")
            st.add(rev, "b:reviewFor", prod)
            st.add(rev, "b:rating1", f'"{int(rng.integers(1, 11))}"')
            if rng.random() < 0.6:
                st.add(rev, "b:rating2", f'"{int(rng.integers(1, 11))}"')
            if rng.random() < 0.3:
                st.add(rev, "b:reviewerHomepage", f'"http://rev/{p}/{r}"')
    return st
