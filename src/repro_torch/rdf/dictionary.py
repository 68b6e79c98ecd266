"""Dictionary encoding for RDF terms.

The paper (§3.2, §4.1) maps subjects/objects to a vertex-ID space and
predicates to an edge-label space; the type-aware transformation additionally
maps ``rdf:type`` / ``rdf:subClassOf`` objects to a vertex-*label* space.
This module owns the string <-> id bijections (``F_V``/``F_ID``, ``F_EL``,
``F_VL`` in Definition 3).  Benchmark timings exclude dictionary lookups,
matching the paper's protocol.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

# Canonical IRIs for the two predicates the type-aware transformation folds away.
RDF_TYPE = "rdf:type"
RDFS_SUBCLASSOF = "rdf:subClassOf"


@dataclass
class _Interner:
    """Append-only string interner with O(1) lookup both ways.

    Append-only is a load-bearing property: the live store keeps
    interning new terms *after* the triple store is finalized, and every
    id handed out earlier must stay stable across those insertions (and
    across compactions)."""

    to_id: dict[str, int] = field(default_factory=dict)
    to_str: list[str] = field(default_factory=list)

    def intern(self, term: str) -> int:
        tid = self.to_id.get(term)
        if tid is None:
            tid = len(self.to_str)
            self.to_id[term] = tid
            self.to_str.append(term)
        return tid

    def get(self, term: str) -> int | None:
        return self.to_id.get(term)

    def __len__(self) -> int:
        return len(self.to_str)


@dataclass
class Dictionary:
    """Three independent id spaces: terms (vertices), predicates, vertex labels."""

    terms: _Interner = field(default_factory=_Interner)
    predicates: _Interner = field(default_factory=_Interner)
    vlabels: _Interner = field(default_factory=_Interner)
    # literal ids (subset of term ids) — literals can never be subjects.
    literal_ids: set[int] = field(default_factory=set)

    # -- encoding -------------------------------------------------------------
    def encode_term(self, term: str) -> int:
        tid = self.terms.intern(term)
        if term.startswith('"'):
            self.literal_ids.add(tid)
        return tid

    def encode_predicate(self, pred: str) -> int:
        return self.predicates.intern(pred)

    def encode_vlabel(self, label: str) -> int:
        return self.vlabels.intern(label)

    # -- decoding / lookup ----------------------------------------------------
    def term(self, tid: int) -> str:
        return self.terms.to_str[tid]

    def predicate(self, pid: int) -> str:
        return self.predicates.to_str[pid]

    def vlabel(self, lid: int) -> str:
        return self.vlabels.to_str[lid]

    def term_id(self, term: str) -> int | None:
        return self.terms.get(term)

    def predicate_id(self, pred: str) -> int | None:
        return self.predicates.get(pred)

    def vlabel_id(self, label: str) -> int | None:
        return self.vlabels.get(label)

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    @property
    def n_predicates(self) -> int:
        return len(self.predicates)

    @property
    def n_vlabels(self) -> int:
        return len(self.vlabels)

    def encode_terms(self, terms: Iterable[str]) -> list[int]:
        return [self.encode_term(t) for t in terms]
