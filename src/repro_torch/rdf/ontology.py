"""Class-hierarchy handling: transitive ``rdf:subClassOf`` closure.

The type-aware transformation (Definition 3.7) labels a vertex with every
class reachable from its ``rdf:type`` objects through ``rdf:subClassOf``
chains — i.e. L(v) = types(v) expanded by the transitive closure of the
subclass DAG.  The closure is computed once per dataset with a memoized DFS
(cycle-safe: malformed data like BTC2012 can contain subclass cycles).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ClassHierarchy:
    """Superclass closure over class ids (vertex-label id space)."""

    parents: dict[int, set[int]] = field(default_factory=dict)  # direct superclasses
    _closure: dict[int, frozenset[int]] = field(default_factory=dict)

    def add_subclass(self, sub: int, sup: int) -> None:
        self.parents.setdefault(sub, set()).add(sup)
        self._closure.clear()

    def superclasses(self, cls: int) -> frozenset[int]:
        """All classes reachable from ``cls`` (including itself)."""
        hit = self._closure.get(cls)
        if hit is not None:
            return hit
        # iterative DFS with a visiting set for cycle safety
        result: set[int] = {cls}
        stack = [cls]
        seen = {cls}
        while stack:
            cur = stack.pop()
            for sup in self.parents.get(cur, ()):
                if sup not in seen:
                    seen.add(sup)
                    result.add(sup)
                    stack.append(sup)
        fs = frozenset(result)
        self._closure[cls] = fs
        return fs

    def expand_types(self, types: set[int]) -> frozenset[int]:
        out: set[int] = set()
        for t in types:
            out |= self.superclasses(t)
        return frozenset(out)


def closure_matrix(h: ClassHierarchy, n_classes: int) -> np.ndarray:
    """Dense bool [n, n] reachability matrix (for tests / small ontologies)."""
    mat = np.zeros((n_classes, n_classes), dtype=bool)
    for c in range(n_classes):
        for s in h.superclasses(c):
            if s < n_classes:
                mat[c, s] = True
    return mat
