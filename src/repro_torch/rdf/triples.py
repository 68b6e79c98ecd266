"""Encoded triple store: the pre-transformation representation of an RDF dataset.

Triples arrive as python string 3-tuples (from the N-Triples parser or a
generator) and are dictionary-encoded into three parallel int32 arrays.
Duplicate triples are dropped (RDF set semantics) at ``finalize`` time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np

from repro_torch.rdf.dictionary import Dictionary


@dataclass
class TripleStore:
    dict: Dictionary = field(default_factory=Dictionary)
    _s: list[int] = field(default_factory=list)
    _p: list[int] = field(default_factory=list)
    _o: list[int] = field(default_factory=list)
    _finalized: bool = False
    s: np.ndarray | None = None
    p: np.ndarray | None = None
    o: np.ndarray | None = None

    def add(self, subj: str, pred: str, obj: str) -> None:
        assert not self._finalized, "store already finalized"
        self._s.append(self.dict.encode_term(subj))
        self._p.append(self.dict.encode_predicate(pred))
        self._o.append(self.dict.encode_term(obj))

    def add_many(self, triples: Iterable[tuple[str, str, str]]) -> None:
        for s, p, o in triples:
            self.add(s, p, o)

    def finalize(self) -> "TripleStore":
        """Deduplicate and freeze into numpy arrays."""
        if self._finalized:
            return self
        s = np.asarray(self._s, dtype=np.int64)
        p = np.asarray(self._p, dtype=np.int64)
        o = np.asarray(self._o, dtype=np.int64)
        # Dedup via a single composite key (ids are < 2**21 at our scales, but
        # use a safe composite on (s,p,o) rows instead of bit packing).
        spo = np.stack([s, p, o], axis=1)
        spo = np.unique(spo, axis=0)
        self.s = spo[:, 0].astype(np.int32)
        self.p = spo[:, 1].astype(np.int32)
        self.o = spo[:, 2].astype(np.int32)
        self._s, self._p, self._o = [], [], []
        self._finalized = True
        return self

    @property
    def n_triples(self) -> int:
        if self._finalized:
            return int(self.s.shape[0])
        return len(self._s)

    def iter_decoded(self) -> Iterator[tuple[str, str, str]]:
        assert self._finalized
        d = self.dict
        for i in range(self.n_triples):
            yield d.term(int(self.s[i])), d.predicate(int(self.p[i])), d.term(int(self.o[i]))
