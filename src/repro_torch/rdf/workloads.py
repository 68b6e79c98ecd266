"""Benchmark query workloads, mirroring the paper's suites.

LUBM Q1–Q14 (paper Tables 2/3): adapted to the generator's ontology, keeping
each query's *shape class* — constant-solution queries (Q1, Q3–Q5, Q7, Q8,
Q10–Q12: a bound entity anchors one candidate region), increasing-solution
queries (Q2, Q6, Q9, Q13, Q14), triangles (Q2, Q9), and point-shaped queries
after type-aware transformation (Q6, Q14).

BSBM-like B1–B12 (paper Table 6): FILTER / OPTIONAL / UNION explore-use-case
analogues.  HETERO H1–H6 (paper Tables 4/5 stand-ins for YAGO/BTC).
"""

from __future__ import annotations

LUBM_QUERIES: dict[str, str] = {
    # Q1: constant — grad students taking a specific graduate course
    "Q1": """
        SELECT ?x WHERE {
          ?x rdf:type ub:GraduateStudent .
          ?x ub:takesCourse ub:GraduateCourse0.Dept0.Univ0 .
        }""",
    # Q2: triangle — grad student, university, department
    "Q2": """
        SELECT ?x ?y ?z WHERE {
          ?x rdf:type ub:GraduateStudent .
          ?y rdf:type ub:University .
          ?z rdf:type ub:Department .
          ?x ub:memberOf ?z .
          ?z ub:subOrganizationOf ?y .
          ?x ub:undergraduateDegreeFrom ?y .
        }""",
    # Q3: constant — publications of a specific assistant professor
    "Q3": """
        SELECT ?x WHERE {
          ?x rdf:type ub:Publication .
          ?x ub:publicationAuthor ub:AssistantProfessor0.Dept0.Univ0 .
        }""",
    # Q4: constant star — professors of a department with contact info
    "Q4": """
        SELECT ?x ?y1 ?y2 ?y3 WHERE {
          ?x rdf:type ub:Professor .
          ?x ub:worksFor ub:Dept0.Univ0 .
          ?x ub:name ?y1 .
          ?x ub:emailAddress ?y2 .
          ?x ub:telephone ?y3 .
        }""",
    # Q5: constant — members of a department (subsumption: Person)
    "Q5": """
        SELECT ?x WHERE {
          ?x rdf:type ub:Person .
          ?x ub:memberOf ub:Dept0.Univ0 .
        }""",
    # Q6: point-shaped — all students
    "Q6": """
        SELECT ?x WHERE { ?x rdf:type ub:Student . }""",
    # Q7: constant — students taking courses of a specific professor
    "Q7": """
        SELECT ?x ?y WHERE {
          ?x rdf:type ub:Student .
          ?y rdf:type ub:Course .
          ?x ub:takesCourse ?y .
          ub:AssociateProfessor0.Dept0.Univ0 ub:teacherOf ?y .
        }""",
    # Q8: constant 2-hop — students of departments of a university
    "Q8": """
        SELECT ?x ?y ?z WHERE {
          ?x rdf:type ub:Student .
          ?y rdf:type ub:Department .
          ?x ub:memberOf ?y .
          ?y ub:subOrganizationOf ub:Univ0 .
          ?x ub:emailAddress ?z .
        }""",
    # Q9: triangle — student, faculty advisor, course
    "Q9": """
        SELECT ?x ?y ?z WHERE {
          ?x rdf:type ub:Student .
          ?y rdf:type ub:Faculty .
          ?z rdf:type ub:Course .
          ?x ub:advisor ?y .
          ?y ub:teacherOf ?z .
          ?x ub:takesCourse ?z .
        }""",
    # Q10: constant — students taking a specific graduate course
    "Q10": """
        SELECT ?x WHERE {
          ?x rdf:type ub:Student .
          ?x ub:takesCourse ub:GraduateCourse0.Dept0.Univ0 .
        }""",
    # Q11: constant — research groups of a university (via department)
    "Q11": """
        SELECT ?x ?y WHERE {
          ?x rdf:type ub:ResearchGroup .
          ?x ub:subOrganizationOf ?y .
          ?y ub:subOrganizationOf ub:Univ0 .
        }""",
    # Q12: constant — chairs working for departments of a university
    "Q12": """
        SELECT ?x ?y WHERE {
          ?x rdf:type ub:Chair .
          ?y rdf:type ub:Department .
          ?x ub:worksFor ?y .
          ?y ub:subOrganizationOf ub:Univ0 .
        }""",
    # Q13: alumni of a specific university
    "Q13": """
        SELECT ?x WHERE {
          ?x rdf:type ub:Person .
          ?x ub:undergraduateDegreeFrom ub:Univ0 .
        }""",
    # Q14: point-shaped — all undergraduate students
    "Q14": """
        SELECT ?x WHERE { ?x rdf:type ub:UndergraduateStudent . }""",
}

# queries that keep a constant number of solutions as scale grows
LUBM_CONSTANT = ("Q1", "Q3", "Q4", "Q5", "Q7", "Q8", "Q10", "Q11", "Q12")
LUBM_INCREASING = ("Q2", "Q6", "Q9", "Q13", "Q14")


BSBM_QUERIES: dict[str, str] = {
    # B1: feature + numeric range FILTER
    "B1": """
        SELECT ?p WHERE {
          ?p rdf:type b:Product .
          ?p b:productFeature b:Feature1 .
          ?p b:propertyNumeric1 ?v .
          FILTER (?v > 1200)
        }""",
    # B2: product details star
    "B2": """
        SELECT ?p ?label ?producer WHERE {
          ?p rdf:type b:Product .
          ?p b:label ?label .
          ?p b:producer ?producer .
          ?p b:productFeature b:Feature3 .
        }""",
    # B3: two-range FILTER
    "B3": """
        SELECT ?p WHERE {
          ?p rdf:type b:Product .
          ?p b:propertyNumeric1 ?v1 .
          ?p b:propertyNumeric2 ?v2 .
          FILTER (?v1 > 600)
          FILTER (?v2 < 900)
        }""",
    # B4: UNION of two features
    "B4": """
        SELECT ?p WHERE {
          { ?p rdf:type b:Product . ?p b:productFeature b:Feature5 . }
          UNION
          { ?p rdf:type b:Product . ?p b:productFeature b:Feature6 . }
        }""",
    # B5: join FILTER (var-var comparison)
    "B5": """
        SELECT ?p ?v1 ?v2 WHERE {
          ?p rdf:type b:Product .
          ?p b:propertyNumeric1 ?v1 .
          ?p b:propertyNumeric2 ?v2 .
          FILTER (?v1 < ?v2)
        }""",
    # B6: regex FILTER on label
    "B6": """
        SELECT ?p ?label WHERE {
          ?p rdf:type b:Product .
          ?p b:label ?label .
          FILTER regex(?label, "product 1[0-3]")
        }""",
    # B7: review/offer star with vendor country
    "B7": """
        SELECT ?p ?offer ?vendor WHERE {
          ?p rdf:type b:Product .
          ?offer b:product ?p .
          ?offer b:vendor ?vendor .
          ?vendor b:country "US" .
        }""",
    # B8: reviews with optional second rating
    "B8": """
        SELECT ?r ?rating1 ?rating2 WHERE {
          ?r rdf:type b:Review .
          ?r b:reviewFor b:Product7 .
          ?r b:rating1 ?rating1 .
          OPTIONAL { ?r b:rating2 ?rating2 . }
        }""",
    # B9: optional homepage (mostly missing)
    "B9": """
        SELECT ?r ?home WHERE {
          ?r rdf:type b:Review .
          ?r b:reviewFor b:Product3 .
          OPTIONAL { ?r b:reviewerHomepage ?home . }
        }""",
    # B10: offers of a product below a price
    "B10": """
        SELECT ?offer ?price WHERE {
          ?offer rdf:type b:Offer .
          ?offer b:product b:Product5 .
          ?offer b:price ?price .
          FILTER (?price < 250.0)
        }""",
    # B11: predicate variable probe of one offer
    "B11": """
        SELECT ?prop ?val WHERE {
          ?o rdf:type b:Offer .
          ?o b:product b:Product11 .
          ?o ?prop ?val .
        }""",
    # B12: union + optional + filter combined
    "B12": """
        SELECT ?p ?v ?home WHERE {
          { ?p rdf:type b:Product . ?p b:productFeature b:Feature2 . }
          UNION
          { ?p rdf:type b:Product . ?p b:productFeature b:Feature4 . }
          ?p b:propertyNumeric1 ?v .
          FILTER (?v >= 100)
          OPTIONAL { ?r b:reviewFor ?p . ?r b:reviewerHomepage ?home . }
        }""",
}


HETERO_QUERIES: dict[str, str] = {
    # H1: typed 1-hop
    "H1": """
        SELECT ?x ?y WHERE {
          ?x rdf:type y:Type1 .
          ?x y:pred0 ?y .
        }""",
    # H2: typed 2-hop path
    "H2": """
        SELECT ?x ?y ?z WHERE {
          ?x rdf:type y:Type2 .
          ?x y:pred1 ?y .
          ?y y:pred2 ?z .
        }""",
    # H3: triangle
    "H3": """
        SELECT ?x ?y ?z WHERE {
          ?x y:pred0 ?y .
          ?y y:pred1 ?z .
          ?x y:pred2 ?z .
        }""",
    # H4: star with two typed leaves
    "H4": """
        SELECT ?x ?a ?b WHERE {
          ?x y:pred3 ?a .
          ?x y:pred4 ?b .
          ?a rdf:type y:Type3 .
          ?b rdf:type y:Type0 .
        }""",
    # H5: predicate variable
    "H5": """
        SELECT ?x ?p ?y WHERE {
          ?x rdf:type y:Type4 .
          ?x ?p ?y .
          ?y rdf:type y:Type1 .
        }""",
    # H6: 3-hop chain
    "H6": """
        SELECT ?a ?b ?c ?d WHERE {
          ?a y:pred0 ?b .
          ?b y:pred0 ?c .
          ?c y:pred0 ?d .
          ?a rdf:type y:Type5 .
        }""",
}
