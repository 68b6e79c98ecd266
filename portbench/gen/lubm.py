"""LUBM data after the Lehigh University Benchmark's generator (UBA 1.7).

The deployment's file (``portbench/configs/<config>.json``) gives every
range under ``uba``; :func:`generate` draws one data set from a seed,
department by department with numpy, and returns it at the id level: a
term table (strings in the port's prefixed form, ``ub:...`` and quoted
literals) and three parallel int32 columns of term ids, with predicate ids
into a table of their own.  Nothing here imports the port: the harness
hands the strings to the port's loader, and the reference reads the ids.

Names follow the port's adapted LUBM queries: ``ub:Univ{u}``,
``ub:Dept{d}.Univ{u}``, ``ub:<Kind>{i}.Dept{d}.Univ{u}`` for people,
courses and research groups, ``ub:Publication{j}.<author>`` for
publications.  As in UBA, names of people, courses and publications repeat
in every department (``"FullProfessor0"``), e-mail addresses do not, every
telephone reads ``"xxx-xxx-xxxx"``, and degrees come from any of
``degree_universities`` universities, of which only the first
``universities`` are generated (typed ``ub:University``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

RDF_TYPE = "rdf:type"
RDFS_SUBCLASSOF = "rdf:subClassOf"

PREDICATES = (
    RDF_TYPE, RDFS_SUBCLASSOF, "ub:name", "ub:emailAddress", "ub:telephone",
    "ub:worksFor", "ub:headOf", "ub:memberOf", "ub:subOrganizationOf",
    "ub:undergraduateDegreeFrom", "ub:mastersDegreeFrom",
    "ub:doctoralDegreeFrom", "ub:researchInterest", "ub:teacherOf",
    "ub:takesCourse", "ub:advisor", "ub:teachingAssistantOf",
    "ub:publicationAuthor",
)
P = {name: i for i, name in enumerate(PREDICATES)}

FACULTY_KINDS = ("FullProfessor", "AssociateProfessor", "AssistantProfessor",
                 "Lecturer")


@dataclass
class Dataset:
    """One generated LUBM data set at the id level."""

    terms: list[str]  # term id -> string
    predicates: tuple[str, ...]  # predicate id -> string
    s: np.ndarray  # int32 [n] subject term ids
    p: np.ndarray  # int32 [n] predicate ids
    o: np.ndarray  # int32 [n] object term ids
    owner: np.ndarray  # int32 [terms] the university a term belongs to, or -1
    universities: int = 0
    _instances: dict = field(default_factory=dict, repr=False)

    @property
    def n_triples(self) -> int:
        return int(self.s.shape[0])

    def instances(self, cls: str) -> list[np.ndarray]:
        """For each university, the sorted term ids of the entities stated
        to be of class ``cls`` (the pools mixes draw constants from)."""
        got = self._instances.get(cls)
        if got is None:
            cid = self.terms.index(cls)
            subj = self.s[(self.p == P[RDF_TYPE]) & (self.o == cid)]
            own = self.owner[subj]
            got = self._instances[cls] = [np.sort(subj[own == u])
                                          for u in range(self.universities)]
        return got

    def term_ids(self) -> dict[str, int]:
        return {t: i for i, t in enumerate(self.terms)}


class _Terms:
    """Append-only term table; ``block`` adds many at once, owned by the
    university being generated (``owner_now``; shared terms own none)."""

    def __init__(self) -> None:
        self.table: list[str] = []
        self.owner: list[int] = []
        self.owner_now = -1
        self.ids: dict[str, int] = {}

    def one(self, term: str) -> int:
        tid = self.ids.get(term)
        if tid is None:
            tid = self.ids[term] = len(self.table)
            self.table.append(term)
            self.owner.append(-1)
        return tid

    def block(self, names: list[str]) -> np.ndarray:
        """Add terms that are new by construction (unique entity names)."""
        start = len(self.table)
        self.table.extend(names)
        self.owner.extend([self.owner_now] * len(names))
        return np.arange(start, start + len(names), dtype=np.int64)

    def shared(self, names: list[str]) -> np.ndarray:
        return np.fromiter((self.one(n) for n in names), dtype=np.int64,
                           count=len(names))


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 64))


def _between(rng, lo_hi, size=None):
    lo, hi = lo_hi
    return rng.integers(lo, hi + 1, size=size)


def _pick_distinct(rng, n_rows: int, pool: int, k: np.ndarray) -> tuple:
    """For each row r, ``k[r]`` distinct draws from ``range(pool)``:
    returns (row, choice) pairs, rows ascending."""
    k = np.minimum(k, pool)
    order = np.argsort(rng.random((n_rows, pool)), axis=1)
    take = np.arange(pool)[None, :] < k[:, None]
    rows = np.broadcast_to(np.arange(n_rows)[:, None], (n_rows, pool))
    return rows[take], order[take]


def _layout(cfg: dict, rng) -> tuple[np.ndarray, list[dict]]:
    """The sizes of the deployment: departments per university and each
    department's faculty by rank, students and research groups, drawn
    from UBA's ranges with the config's ``layout_seed``, then dealt to
    universities and departments in an order drawn from ``rng`` (the
    run's seed).  So every seed holds the same sizes, in another place."""
    uba = cfg["uba"]
    lay = _rng(cfg["layout_seed"])
    n_univ = int(cfg["universities"])
    depts = _between(lay, uba["departments"], n_univ)
    shapes = []
    for _ in range(int(depts.sum())):
        fac = {k: int(_between(lay, uba["faculty"][k])) for k in FACULTY_KINDS}
        n_fac = sum(fac.values())
        lo, hi = uba["undergraduates_per_faculty"]
        n_ug = int(lay.integers(lo * n_fac, hi * n_fac + 1))
        lo, hi = uba["graduates_per_faculty"]
        n_gr = int(lay.integers(lo * n_fac, hi * n_fac + 1))
        shapes.append({"faculty": fac, "undergraduates": n_ug,
                       "graduates": n_gr,
                       "groups": int(_between(lay, uba["research_groups"]))})
    order = rng.permutation(len(shapes))
    return depts[rng.permutation(n_univ)], [shapes[i] for i in order]


def generate(cfg: dict, seed: int) -> Dataset:
    """Draw the data set of deployment ``cfg`` (its ``universities`` and
    ``uba`` ranges) from ``seed``: the sizes of :func:`_layout`, and every
    link (courses taken, advisors, degrees, authors, assistants) and
    per-person count from the seed itself."""
    uba = cfg["uba"]
    n_univ = int(cfg["universities"])
    rng = _rng(seed)
    n_depts, shapes = _layout(cfg, rng)
    shape_of = iter(shapes)
    terms = _Terms()
    s_parts: list[np.ndarray] = []
    p_parts: list[np.ndarray] = []
    o_parts: list[np.ndarray] = []

    def emit(subj, pred: str, obj) -> None:
        subj = np.asarray(subj, dtype=np.int64)
        obj = np.asarray(obj, dtype=np.int64)
        n = max(subj.size, obj.size)
        s_parts.append(np.broadcast_to(subj, (n,)).astype(np.int32))
        o_parts.append(np.broadcast_to(obj, (n,)).astype(np.int32))
        p_parts.append(np.full(n, P[pred], dtype=np.int32))

    cls = {c: terms.one(c) for pair in cfg["hierarchy"] for c in pair}
    for c in ("ub:University", "ub:Department", "ub:ResearchGroup",
              "ub:Publication", "ub:Course", "ub:GraduateCourse",
              "ub:UndergraduateStudent", "ub:GraduateStudent",
              "ub:TeachingAssistant", "ub:ResearchAssistant", "ub:Chair",
              *(f"ub:{k}" for k in FACULTY_KINDS)):
        cls[c] = terms.one(c)
    for sub, sup in cfg["hierarchy"]:
        emit(cls[sub], RDFS_SUBCLASSOF, cls[sup])

    n_deg = int(uba["degree_universities"])
    univ = terms.block([f"ub:Univ{u}" for u in range(n_deg)])
    for u in range(n_univ):  # a generated university owns itself
        terms.owner[int(univ[u])] = u
    phone = terms.one('"xxx-xxx-xxxx"')
    interests = terms.shared([f'"Research{k}"'
                              for k in range(uba["research_interests"])])

    for u in range(n_univ):
        terms.owner_now = u
        emit(univ[u], RDF_TYPE, cls["ub:University"])
        emit(univ[u], "ub:name", terms.one(f'"University{u}"'))
        n_dept = int(n_depts[u])
        depts = terms.block([f"ub:Dept{d}.Univ{u}" for d in range(n_dept)])
        emit(depts, RDF_TYPE, cls["ub:Department"])
        emit(depts, "ub:subOrganizationOf", univ[u])
        emit(depts, "ub:name",
             terms.shared([f'"Department{d}"' for d in range(n_dept)]))
        for d in range(n_dept):
            _department(rng, uba, next(shape_of), terms, emit, cls, univ,
                        phone, interests, depts[d], f"Dept{d}.Univ{u}", n_deg)
    terms.owner_now = -1

    return Dataset(terms=terms.table, predicates=PREDICATES,
                   s=np.concatenate(s_parts), p=np.concatenate(p_parts),
                   o=np.concatenate(o_parts),
                   owner=np.asarray(terms.owner, dtype=np.int32),
                   universities=n_univ)


def _department(rng, uba, shape, terms, emit, cls, univ, phone, interests,
                dept, tag: str, n_deg: int):
    """One department's people, courses, groups and publications."""
    # faculty by rank, each with name, e-mail, telephone, research
    # interest, three degrees and worksFor
    fac_ids, fac_kind = [], []
    for k, kind in enumerate(FACULTY_KINDS):
        n = shape["faculty"][kind]
        fac_ids.append(terms.block([f"ub:{kind}{i}.{tag}" for i in range(n)]))
        fac_kind.append(np.full(n, k))
        emit(fac_ids[-1], RDF_TYPE, cls[f"ub:{kind}"])
        emit(fac_ids[-1], "ub:name",
             terms.shared([f'"{kind}{i}"' for i in range(n)]))
        emit(fac_ids[-1], "ub:emailAddress",
             terms.block([f'"{kind}{i}@{tag}.edu"' for i in range(n)]))
    fac = np.concatenate(fac_ids)
    kind = np.concatenate(fac_kind)
    n_fac = fac.shape[0]
    prof = fac[kind < 3]  # full, associate and assistant professors
    emit(fac, "ub:telephone", phone)
    emit(fac, "ub:worksFor", dept)
    emit(fac, "ub:researchInterest",
         interests[rng.integers(0, interests.shape[0], n_fac)])
    for pred in ("ub:undergraduateDegreeFrom", "ub:mastersDegreeFrom",
                 "ub:doctoralDegreeFrom"):
        emit(fac, pred, univ[rng.integers(0, n_deg, n_fac)])
    # the head: a full professor, also typed ub:Chair
    head = fac_ids[0][int(rng.integers(0, fac_ids[0].shape[0]))]
    emit(head, "ub:headOf", dept)
    emit(head, RDF_TYPE, cls["ub:Chair"])

    # courses: each faculty member teaches its own undergraduate and
    # graduate courses
    courses = {}
    for name, key in (("Course", "courses_per_faculty"),
                      ("GraduateCourse", "graduate_courses_per_faculty")):
        per = _between(rng, uba[key], n_fac)
        n = int(per.sum())
        ids = terms.block([f"ub:{name}{i}.{tag}" for i in range(n)])
        emit(ids, RDF_TYPE, cls[f"ub:{name}"])
        emit(ids, "ub:name", terms.shared([f'"{name}{i}"' for i in range(n)]))
        emit(np.repeat(fac, per), "ub:teacherOf", ids)
        courses[name] = ids
    ug_c, gr_c = courses["Course"], courses["GraduateCourse"]

    # students: counts per faculty member, courses taken, advisors
    n_ug, n_gr = shape["undergraduates"], shape["graduates"]
    for name, n, pool, key in (
            ("UndergraduateStudent", n_ug, ug_c, "undergraduate_courses"),
            ("GraduateStudent", n_gr, gr_c, "graduate_courses")):
        ids = terms.block([f"ub:{name}{i}.{tag}" for i in range(n)])
        emit(ids, RDF_TYPE, cls[f"ub:{name}"])
        emit(ids, "ub:name", terms.shared([f'"{name}{i}"' for i in range(n)]))
        emit(ids, "ub:emailAddress",
             terms.block([f'"{name}{i}@{tag}.edu"' for i in range(n)]))
        emit(ids, "ub:telephone", phone)
        emit(ids, "ub:memberOf", dept)
        row, pick = _pick_distinct(rng, n, pool.shape[0],
                                   _between(rng, uba[key], n))
        emit(ids[row], "ub:takesCourse", pool[pick])
        if name == "UndergraduateStudent":
            has = rng.random(n) < uba["undergraduate_advisor_share"]
            emit(ids[has], "ub:advisor",
                 prof[rng.integers(0, prof.shape[0], int(has.sum()))])
            ug = ids
        else:
            emit(ids, "ub:advisor", prof[rng.integers(0, prof.shape[0], n)])
            emit(ids, "ub:undergraduateDegreeFrom",
                 univ[rng.integers(0, n_deg, n)])
            gr = ids
    del ug  # undergraduates take no part below
    # teaching and research assistants: disjoint shares of the graduates
    order = rng.permutation(n_gr)
    n_ta = n_gr // int(_between(rng, uba["graduates_per_teaching_assistant"]))
    n_ra = n_gr // int(_between(rng, uba["graduates_per_research_assistant"]))
    ta = gr[order[:n_ta]]
    emit(ta, RDF_TYPE, cls["ub:TeachingAssistant"])
    emit(ta, "ub:teachingAssistantOf",
         ug_c[rng.integers(0, ug_c.shape[0], n_ta)])
    emit(gr[order[n_ta:n_ta + n_ra]], RDF_TYPE, cls["ub:ResearchAssistant"])

    n_grp = shape["groups"]
    grp = terms.block([f"ub:ResearchGroup{i}.{tag}" for i in range(n_grp)])
    emit(grp, RDF_TYPE, cls["ub:ResearchGroup"])
    emit(grp, "ub:subOrganizationOf", dept)

    # publications: a number per faculty member by rank, each authored by
    # it; graduates co-author some of the department's publications
    lo_hi = np.array([uba["publications"][k] for k in FACULTY_KINDS])
    per = rng.integers(lo_hi[kind, 0], lo_hi[kind, 1] + 1)
    author = np.repeat(np.arange(n_fac), per)
    local = np.arange(author.shape[0]) - np.repeat(np.cumsum(per) - per, per)
    names = [terms.table[fac[a]][3:] for a in range(n_fac)]
    pubs = terms.block([f"ub:Publication{j}.{names[a]}"
                        for a, j in zip(author.tolist(), local.tolist())])
    emit(pubs, RDF_TYPE, cls["ub:Publication"])
    emit(pubs, "ub:name",
         terms.shared([f'"Publication{j}"' for j in local.tolist()]))
    emit(pubs, "ub:publicationAuthor", fac[author])
    if pubs.shape[0]:
        row, pick = _pick_distinct(
            rng, n_gr, pubs.shape[0],
            _between(rng, uba["graduate_publications"], n_gr))
        emit(pubs[pick], "ub:publicationAuthor", gr[row])
