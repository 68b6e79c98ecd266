"""In-memory labeled graph — the paper's §4.2 data structures, array-native.

The paper keeps (1) an *inverse vertex-label list* and (2) *adjacency lists
grouped by neighbor type* (edge label, vertex label), both as offset+array
pairs, one copy per direction.  We materialize the same information as flat
numpy/JAX arrays so the vectorized executor can gather slices with tensor ops:

- ``out_indptr_el[el, v] : out_indptr_el[el, v+1]`` slices ``out_nbr_el``
  (dst vertices sorted by (el, src, dst)) — the per-edge-label CSR used by
  tree-edge expansion and the +INT / edge-exists join primitives.  The
  ``[n_elabels, n_vertices+1]`` offset table lives on the *host*; compiled
  plans receive only the rows for edge labels the query mentions.
- a plain CSR (``out_indptr_all`` / ``out_nbr_all`` / ``out_lab_all``,
  sorted by (src, dst)) used when a query edge has a *predicate variable*
  (blank edge label) and for e-hom edge-label binding.
- the same two structures for the incoming direction.
- ``label_bitmap``: packed uint32 vertex-label sets (the two-attribute vertex
  model's label attribute) — O(words) superset tests replace the paper's
  sorted-set containment.
- inverse vertex-label index ``vl_indptr``/``vl_vertices`` (sorted ids) for
  ``freq(g, L(u))`` and start-candidate enumeration.
- predicate index: per edge label, sorted unique subjects and objects — used
  by ChooseStartQueryVertex when a query vertex has neither label nor ID.
- optional NLF bitmaps over neighbor types t = el * n_vlabels + vl (the
  homomorphism-weakened NLF filter: "at least one neighbor of each required
  neighbor type").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


def pack_bitmap(sets: Sequence[Sequence[int]], n_bits: int) -> np.ndarray:
    """Pack per-row integer sets into a uint32 bitmap [n_rows, ceil(n_bits/32)]."""
    n_words = max(1, (n_bits + 31) // 32)
    out = np.zeros((len(sets), n_words), dtype=np.uint32)
    for i, items in enumerate(sets):
        for b in items:
            out[i, b >> 5] |= np.uint32(1 << (b & 31))
    return out


def _csr_from_sorted(keys: np.ndarray, n_keys: int) -> np.ndarray:
    """indptr[n_keys+1] for an ascending-sorted key column."""
    counts = np.bincount(keys, minlength=n_keys)
    indptr = np.zeros(n_keys + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr


@dataclass
class _Direction:
    """One direction (outgoing or incoming) of the adjacency structures."""

    indptr_el: np.ndarray  # int64 [n_elabels, n_vertices+1] (host only)
    nbr_el: np.ndarray  # int32 [n_edges]  sorted by (el, v, nbr)
    indptr_all: np.ndarray  # int64 [n_vertices+1]
    nbr_all: np.ndarray  # int32 [n_edges]  sorted by (v, nbr, el)
    lab_all: np.ndarray  # int32 [n_edges]  edge label aligned with nbr_all
    degree: np.ndarray  # int32 [n_vertices]

    def slice_el(self, el: int, v: int) -> np.ndarray:
        s, e = self.indptr_el[el, v], self.indptr_el[el, v + 1]
        return self.nbr_el[s:e]

    def slice_all(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr_all[v], self.indptr_all[v + 1]
        return self.nbr_all[s:e], self.lab_all[s:e]


def _build_direction(
    src: np.ndarray, el: np.ndarray, dst: np.ndarray, n_vertices: int, n_elabels: int
) -> _Direction:
    m = src.shape[0]
    # (el, src, dst) sort for the per-label CSR.
    order = np.lexsort((dst, src, el))
    s1, e1, d1 = src[order], el[order], dst[order]
    # indptr_el[el, v]: start of run (el, v).  Composite key = el * n + v.
    comp = e1.astype(np.int64) * n_vertices + s1.astype(np.int64)
    counts = np.bincount(comp, minlength=n_elabels * n_vertices)
    indptr_el = np.zeros(n_elabels * n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr_el[1:])
    # reshape to [n_elabels, n_vertices+1]: row el must cover [el*n .. el*n + n]
    full = np.empty((n_elabels, n_vertices + 1), dtype=np.int64)
    for lbl in range(n_elabels):
        full[lbl, :] = indptr_el[lbl * n_vertices : lbl * n_vertices + n_vertices + 1]
    # (src, dst, el) sort for the plain CSR.
    order2 = np.lexsort((el, dst, src))
    s2, e2, d2 = src[order2], el[order2], dst[order2]
    indptr_all = _csr_from_sorted(s2, n_vertices)
    degree = np.diff(indptr_all).astype(np.int32)
    return _Direction(
        indptr_el=full,
        nbr_el=d1.astype(np.int32),
        indptr_all=indptr_all,
        nbr_all=d2.astype(np.int32),
        lab_all=e2.astype(np.int32),
        degree=degree,
    )


@dataclass
class LabeledGraph:
    n_vertices: int
    n_elabels: int
    n_vlabels: int
    out: _Direction
    inc: _Direction
    label_bitmap: np.ndarray  # uint32 [n_vertices, n_label_words]
    vl_indptr: np.ndarray  # int64 [n_vlabels+1]
    vl_vertices: np.ndarray  # int32 [sum |V_l|], sorted per label
    vlabel_sets: list[tuple[int, ...]] = field(repr=False, default_factory=list)
    # FILTER support: numeric value per vertex (NaN if not a numeric literal).
    numeric_value: np.ndarray | None = None
    # Lazily built structures.
    _pred_index: dict[int, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    _nlf_out: np.ndarray | None = None
    _nlf_in: np.ndarray | None = None

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(
        n_vertices: int,
        src: np.ndarray,
        el: np.ndarray,
        dst: np.ndarray,
        n_elabels: int,
        vlabel_sets: Sequence[Sequence[int]],
        n_vlabels: int,
        numeric_value: np.ndarray | None = None,
    ) -> "LabeledGraph":
        src = np.asarray(src, dtype=np.int64)
        el = np.asarray(el, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        # RDF set semantics: duplicate (s, p, o) edges would duplicate
        # expansion rows in the executor and corrupt solution counts
        sed = np.unique(np.stack([src, el, dst], axis=1), axis=0)
        src, el, dst = sed[:, 0], sed[:, 1], sed[:, 2]
        assert len(vlabel_sets) == n_vertices
        out = _build_direction(src, el, dst, n_vertices, n_elabels)
        inc = _build_direction(dst, el, src, n_vertices, n_elabels)
        label_bitmap = pack_bitmap(vlabel_sets, max(1, n_vlabels))
        # inverse vertex-label index
        pairs_l: list[np.ndarray] = []
        pairs_v: list[np.ndarray] = []
        for v, labels in enumerate(vlabel_sets):
            if labels:
                arr = np.fromiter(labels, dtype=np.int64)
                pairs_l.append(arr)
                pairs_v.append(np.full(arr.shape, v, dtype=np.int64))
        if pairs_l:
            ls = np.concatenate(pairs_l)
            vs = np.concatenate(pairs_v)
            order = np.lexsort((vs, ls))
            ls, vs = ls[order], vs[order]
        else:
            ls = np.zeros(0, dtype=np.int64)
            vs = np.zeros(0, dtype=np.int64)
        vl_indptr = _csr_from_sorted(ls, max(1, n_vlabels)) if ls.size else np.zeros(
            max(1, n_vlabels) + 1, dtype=np.int64
        )
        return LabeledGraph(
            n_vertices=n_vertices,
            n_elabels=n_elabels,
            n_vlabels=n_vlabels,
            out=out,
            inc=inc,
            label_bitmap=label_bitmap,
            vl_indptr=vl_indptr,
            vl_vertices=vs.astype(np.int32),
            vlabel_sets=[tuple(sorted(s)) for s in vlabel_sets],
            numeric_value=numeric_value,
        )

    # ------------------------------------------------------------- properties
    @property
    def n_edges(self) -> int:
        return int(self.out.nbr_el.shape[0])

    @property
    def n_label_words(self) -> int:
        return int(self.label_bitmap.shape[1])

    def vertices_with_label(self, lbl: int) -> np.ndarray:
        """Sorted vertex ids carrying vertex label ``lbl`` (inverse label list)."""
        return self.vl_vertices[self.vl_indptr[lbl] : self.vl_indptr[lbl + 1]]

    def freq(self, labels: Sequence[int]) -> int:
        """``freq(g, L(u))`` — |∩_l V(g)_l| (paper, ChooseStartQueryVertex)."""
        if not labels:
            return self.n_vertices
        cur = self.vertices_with_label(labels[0])
        for lbl in labels[1:]:
            cur = np.intersect1d(cur, self.vertices_with_label(lbl), assume_unique=True)
        return int(cur.shape[0])

    def candidates_with_labels(self, labels: Sequence[int]) -> np.ndarray:
        if not labels:
            return np.arange(self.n_vertices, dtype=np.int32)
        cur = self.vertices_with_label(labels[0])
        for lbl in labels[1:]:
            cur = np.intersect1d(cur, self.vertices_with_label(lbl), assume_unique=True)
        return cur.astype(np.int32)

    # -------------------------------------------------------- predicate index
    def predicate_index(self, el: int) -> tuple[np.ndarray, np.ndarray]:
        """(sorted unique subjects, sorted unique objects) for edge label el."""
        cached = self._pred_index.get(el)
        if cached is None:
            subs = np.flatnonzero(np.diff(self.out.indptr_el[el]) > 0).astype(np.int32)
            objs = np.flatnonzero(np.diff(self.inc.indptr_el[el]) > 0).astype(np.int32)
            cached = (subs, objs)
            self._pred_index[el] = cached
        return cached

    # -------------------------------------------------------------- NLF build
    def nlf_bitmaps(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-vertex neighbor-type bitmaps (out, in); type t = el*n_vlabels + vl.

        A vertex with an unlabeled neighbor via edge label el sets only the
        el-presence summary bit (t = el*n_vlabels + 0 would collide with a real
        label) — instead we reserve one extra pseudo-label slot per edge label:
        type space is el * (n_vlabels + 1) + (1 + vl), with slot el*(n+1)
        meaning "any neighbor via el".
        """
        if self._nlf_out is not None:
            return self._nlf_out, self._nlf_in
        stride = self.n_vlabels + 1
        n_types = self.n_elabels * stride
        self._nlf_out = self._nlf_direction(self.out, n_types, stride)
        self._nlf_in = self._nlf_direction(self.inc, n_types, stride)
        return self._nlf_out, self._nlf_in

    def _nlf_direction(self, d: _Direction, n_types: int, stride: int) -> np.ndarray:
        n_words = (n_types + 31) // 32
        bm = np.zeros((self.n_vertices, n_words), dtype=np.uint32)
        # iterate edges in plain CSR order: vertex v, neighbor w, label el
        v_of_edge = np.repeat(
            np.arange(self.n_vertices, dtype=np.int64), np.diff(d.indptr_all)
        )
        w = d.nbr_all.astype(np.int64)
        el = d.lab_all.astype(np.int64)
        # "any neighbor via el" pseudo-type
        t_any = el * stride
        np.bitwise_or.at(
            bm, (v_of_edge, t_any >> 5), (np.uint32(1) << (t_any & 31).astype(np.uint32))
        )
        # typed neighbor types for every label the neighbor carries
        for li in range(self.n_vlabels):
            has = (self.label_bitmap[w, li >> 5] >> np.uint32(li & 31)) & np.uint32(1)
            sel = has.astype(bool)
            if not sel.any():
                continue
            t = el[sel] * stride + (1 + li)
            np.bitwise_or.at(
                bm, (v_of_edge[sel], t >> 5), (np.uint32(1) << (t & 31).astype(np.uint32))
            )
        return bm

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        return {
            "n_vertices": self.n_vertices,
            "n_edges": self.n_edges,
            "n_elabels": self.n_elabels,
            "n_vlabels": self.n_vlabels,
            "avg_out_degree": float(self.out.degree.mean()) if self.n_vertices else 0.0,
            "max_out_degree": int(self.out.degree.max()) if self.n_vertices else 0,
        }
