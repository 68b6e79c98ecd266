"""Judge every answer of the window against the plain reference.

An answer is the port's rows (its vertex ids) with its variable names.
Its ids are read back to terms through the port's own dictionary, as a
user reads them, then to the data set's term ids by string, and the bag of
rows must equal the reference's answer to the same query text.  Answers
with identical bytes share one verdict; the reference answers each query
text once.
"""

from __future__ import annotations

import hashlib

import numpy as np

from portbench.reference import bgp


class Checker:
    def __init__(self, ds, ref_graph: bgp.Graph, maps,
                 term_id: dict | None = None):
        self.ds = ds
        self.ref = ref_graph
        self.maps = maps
        self._term_ids = term_id
        self._vmap: dict[int, int] = {}
        self._answers: dict[str, np.ndarray] = {}
        self._parsed: dict[str, bgp.Query] = {}

    def _to_terms(self, rows: np.ndarray) -> np.ndarray:
        """Port vertex ids -> data set term ids (-1: not a term of it)."""
        if self._term_ids is None:
            self._term_ids = self.ds.term_ids()
        d, v2t = self.maps.dict, self.maps.vertex_to_term
        uniq = np.unique(rows)
        for v in uniq.tolist():
            if v not in self._vmap:
                self._vmap[v] = (-1 if v < 0 else self._term_ids.get(
                    d.term(int(v2t[v])), -1))
        lut = np.asarray([self._vmap[v] for v in uniq.tolist()],
                         dtype=np.int64)
        return lut[np.searchsorted(uniq, rows)] if rows.size else \
            rows.astype(np.int64)

    def reference(self, text: str) -> tuple[bgp.Query, np.ndarray]:
        q = self._parsed.get(text)
        if q is None:
            q = self._parsed[text] = bgp.parse(text)
            self._answers[text] = self.ref.answer(q)
        return q, self._answers[text]

    def matches(self, text: str, rows: np.ndarray) -> bool:
        """Whether ``rows`` (data set term ids, in the query's SELECT
        order) are, as a bag, the reference's answer to ``text``."""
        _, want = self.reference(text)
        return rows.shape == want.shape and bool(
            np.array_equal(bgp.sort_rows(rows), want))

    def same(self, text: str, variables, kinds, rows) -> bool:
        """Whether the port's answer (its rows of vertex ids under
        ``variables``) is the reference's answer to ``text``."""
        q, want = self.reference(text)
        if any(k != "vertex" for k in kinds):
            return False
        try:
            cols = [list(variables).index(v) for v in q.select]
        except ValueError:
            return False
        got = np.asarray(rows)
        if got.ndim != 2 or got.shape[1] != len(variables) \
                or got.shape[0] != want.shape[0]:
            return False
        return self.matches(text, self._to_terms(
            got[:, cols].astype(np.int64)))

    def judge(self, answers) -> dict:
        """``answers``: (request text, result) pairs.  Returns counts of
        wrong answers and of distinct answers checked."""
        verdicts: dict[bytes, bool] = {}
        wrong = 0
        for text, res in answers:
            rows = np.ascontiguousarray(res.rows)
            h = hashlib.blake2b(text.encode(), digest_size=16)
            h.update(repr((list(res.variables), list(res.kinds), res.count,
                           rows.shape, str(rows.dtype))).encode())
            h.update(rows.tobytes())
            key = h.digest()
            ok = verdicts.get(key)
            if ok is None:
                ok = verdicts[key] = (res.count == rows.shape[0] and self.same(
                    text, res.variables, res.kinds, rows))
            wrong += not ok
        return {"wrong": wrong, "distinct": len(verdicts)}
