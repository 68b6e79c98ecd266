"""Edge-delta buffers over a frozen base :class:`LabeledGraph`.

``EdgeDelta`` is the mutable write-side state: a set of inserted edges and
a set of tombstoned *base* edges, both keyed ``(src, elabel, dst)``.  The
two sets are kept disjoint from the base by construction:

- inserting an edge that exists in the base is a no-op (RDF set
  semantics), unless it was tombstoned — then the tombstone is removed;
- deleting an edge removes it from the insert buffer if it only ever
  lived there, tombstones it if it exists in the base, and is a no-op
  otherwise.

``materialize`` freezes the current buffers into the sorted COO arrays a
:class:`~repro_torch.store.versioned.Snapshot` serves from: one ``(el, key,
nbr)``-sorted array per direction for inserts and tombstones, from which
per-edge-label CSR rows (and the plain all-labels CSR for predicate-
variable steps) are derived lazily.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.rdf.graph import LabeledGraph


def base_has_edge(base: LabeledGraph, s: int, el: int, o: int) -> bool:
    """Is (s, el, o) an edge of the base graph?  O(log deg) binary search."""
    if not (0 <= s < base.n_vertices and 0 <= el < base.n_elabels):
        return False
    row = base.out.indptr_el[el]
    lo, hi = int(row[s]), int(row[s + 1])
    seg = base.out.nbr_el[lo:hi]
    i = int(np.searchsorted(seg, o))
    return i < seg.shape[0] and int(seg[i]) == o


@dataclass
class DeltaCOO:
    """One direction's frozen delta: arrays sorted by (el, key, nbr).

    For the outgoing direction ``key`` is the subject and ``nbr`` the
    object; the incoming direction swaps them.  ``nbr`` runs within one
    (el, key) group are ascending, so the executor's binary-search
    membership probes work on the per-(el, key) slices directly.
    """

    el: np.ndarray  # int32 [k]
    key: np.ndarray  # int32 [k]
    nbr: np.ndarray  # int32 [k]

    @staticmethod
    def from_edges(edges, forward: bool) -> "DeltaCOO":
        if not edges:
            z = np.zeros(0, np.int32)
            return DeltaCOO(z, z, z)
        # (s, el, o) tuples; the lexsort below is a total order, so no
        # Python-level pre-sort is needed
        arr = np.fromiter((x for e in edges for x in e), dtype=np.int64,
                          count=3 * len(edges)).reshape(-1, 3)
        s, el, o = arr[:, 0], arr[:, 1], arr[:, 2]
        key, nbr = (s, o) if forward else (o, s)
        order = np.lexsort((nbr, key, el))
        return DeltaCOO(el[order].astype(np.int32),
                        key[order].astype(np.int32),
                        nbr[order].astype(np.int32))

    @property
    def size(self) -> int:
        return int(self.el.shape[0])

    def el_slice(self, el: int) -> tuple[np.ndarray, np.ndarray]:
        """(keys, nbrs) of this edge label, sorted by (key, nbr)."""
        lo = int(np.searchsorted(self.el, el, side="left"))
        hi = int(np.searchsorted(self.el, el, side="right"))
        return self.key[lo:hi], self.nbr[lo:hi]

    def el_rows(self, el: int, n_rows: int) -> tuple[np.ndarray, np.ndarray]:
        """CSR (indptr[n_rows+1], nbr) for one edge label over ``n_rows``
        source vertices.  Returns empty arrays when the label is absent."""
        key, nbr = self.el_slice(el)
        if key.size == 0:
            return np.zeros(n_rows + 1, np.int32), np.zeros(0, np.int32)
        counts = np.bincount(key, minlength=n_rows)
        indptr = np.zeros(n_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:], dtype=np.int64)
        return indptr, nbr.copy()

    def plain_rows(self, n_rows: int) -> tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
        """All-labels CSR ``(indptr, nbr, lab)`` sorted by (key, nbr, el)
        — the predicate-variable expansion layout."""
        if self.size == 0:
            return (np.zeros(n_rows + 1, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.int32))
        order = np.lexsort((self.el, self.nbr, self.key))
        key = self.key[order]
        counts = np.bincount(key, minlength=n_rows)
        indptr = np.zeros(n_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:], dtype=np.int64)
        return indptr, self.nbr[order].copy(), self.el[order].copy()

    def composite_rows(self, n_rows: int,
                       n_elabels: int) -> tuple[np.ndarray, np.ndarray]:
        """All-labels CSR of composite keys ``nbr * n_elabels + el`` sorted
        ascending per source — the tombstone probe layout for predicate-
        variable steps (one binary search tests a specific (nbr, el) pair)."""
        if self.size == 0:
            return np.zeros(n_rows + 1, np.int32), np.zeros(0, np.int32)
        comp = self.nbr.astype(np.int64) * n_elabels + self.el.astype(np.int64)
        assert comp.size == 0 or int(comp.max()) < 2**31, \
            "composite (vertex, elabel) key exceeds int32"
        order = np.lexsort((comp, self.key))
        key = self.key[order]
        counts = np.bincount(key, minlength=n_rows)
        indptr = np.zeros(n_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:], dtype=np.int64)
        return indptr, comp[order].astype(np.int32)

    def max_run(self) -> int:
        """Largest per-(el, key) adjacency run — the delta fanout bound."""
        if self.size == 0:
            return 0
        group = (np.r_[True, (np.diff(self.el) != 0) | (np.diff(self.key) != 0)]
                 .cumsum() - 1)
        return int(np.bincount(group).max())


class EdgeDelta:
    """Mutable insert/tombstone buffers over a frozen base graph."""

    def __init__(self, base: LabeledGraph):
        self.base = base
        self.inserts: set[tuple[int, int, int]] = set()  # (s, el, o)
        self.tombs: set[tuple[int, int, int]] = set()

    def __len__(self) -> int:
        return len(self.inserts) + len(self.tombs)

    def insert(self, s: int, el: int, o: int) -> bool:
        """Apply one edge insertion; True if visible state changed."""
        e = (int(s), int(el), int(o))
        if e in self.tombs:
            self.tombs.discard(e)
            return True
        if e in self.inserts or base_has_edge(self.base, *e):
            return False
        self.inserts.add(e)
        return True

    def delete(self, s: int, el: int, o: int) -> bool:
        """Apply one edge deletion; True if visible state changed."""
        e = (int(s), int(el), int(o))
        if e in self.inserts:
            self.inserts.discard(e)
            return True
        if e in self.tombs or not base_has_edge(self.base, *e):
            return False
        self.tombs.add(e)
        return True

    def materialize(self) -> dict[str, DeltaCOO]:
        """Freeze the buffers into per-direction sorted COO views."""
        return {
            "ins_out": DeltaCOO.from_edges(self.inserts, forward=True),
            "ins_in": DeltaCOO.from_edges(self.inserts, forward=False),
            "tomb_out": DeltaCOO.from_edges(self.tombs, forward=True),
            "tomb_in": DeltaCOO.from_edges(self.tombs, forward=False),
        }
