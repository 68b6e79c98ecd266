"""Per-vertex neighborhood-signature index.

``sig[v]`` packs, as uint32 words, the set of edge labels incident to data
vertex ``v`` — outgoing labels in words ``[0, W)``, incoming labels in
words ``[W, 2W)``.  Labels are *hash-folded* onto ``n_bits = min(max(
n_elabels, 1), SIG_MAX_BITS)`` bits via ``el % n_bits``, so the index
width is bounded on graphs with huge predicate vocabularies.  Folding
preserves the pruning contract: if a data vertex really has every
predicate a query vertex requires, its folded signature is a superset of
the folded required signature — a failed superset test can only mean a
genuinely missing predicate.  Collisions cost false *positives* only;
pruning never drops a valid match.

Live-store snapshots get a conservative over-approximation
(:func:`signature_rows`): base rows extended with zero rows for
delta-born vertices, insert bits OR-ed in, tombstones ignored.  Exact
signatures are restored at compaction by :func:`patch_index`, which
recomputes only the rows of vertices touched by the delta (asserted
bit-identical to a rebuild in tests).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.rdf.graph import LabeledGraph

SIG_MAX_BITS = 128  # fold predicates onto at most this many bits per direction


def sig_bits(n_elabels: int) -> int:
    return min(max(int(n_elabels), 1), SIG_MAX_BITS)


def _or_edges(sig: np.ndarray, rows: np.ndarray, labels: np.ndarray,
              n_bits: int, word_off: int) -> None:
    """OR the folded bit of each (row, label) pair into ``sig`` in place."""
    t = labels.astype(np.int64) % n_bits
    np.bitwise_or.at(
        sig, (rows, word_off + (t >> 5)),
        np.uint32(1) << (t & 31).astype(np.uint32),
    )


@dataclass
class SignatureIndex:
    """Frozen per-vertex signature table for one :class:`LabeledGraph`."""

    graph: LabeledGraph
    n_bits: int
    sig: np.ndarray  # uint32 [V, 2*W]: out words then in words

    @property
    def n_words(self) -> int:
        """Words per direction."""
        return self.sig.shape[1] // 2

    @staticmethod
    def build(g: LabeledGraph) -> "SignatureIndex":
        n_bits = sig_bits(g.n_elabels)
        w = (n_bits + 31) // 32
        sig = np.zeros((g.n_vertices, 2 * w), dtype=np.uint32)
        for d, off in ((g.out, 0), (g.inc, w)):
            rows = np.repeat(np.arange(g.n_vertices, dtype=np.int64),
                             np.diff(d.indptr_all))
            if rows.size:
                _or_edges(sig, rows, d.lab_all, n_bits, off)
        return SignatureIndex(g, n_bits, sig)

    def dev(self, device) -> torch.Tensor:
        """The table as a torch tensor on ``device`` (cached per device):
        the uint32 words as int32 bit patterns, which the superset test
        treats bit-identically.  Plan-time pruning probes run through the
        ``signature_filter`` kernel dispatch on it."""
        cache = self.__dict__.setdefault("_dev", {})
        key = str(torch.device(device))
        t = cache.get(key)
        if t is None:
            t = torch.from_numpy(self.sig.view(np.int32)).to(device)
            cache[key] = t
        return t


def get_index(g) -> SignatureIndex:
    """The (cached) signature index of ``g``; snapshots resolve to their
    base graph's index — use :func:`signature_rows` for per-snapshot rows."""
    if getattr(g, "is_snapshot", False):
        return get_index(g.base)
    idx = getattr(g, "_sig_index", None)
    if idx is None or idx.graph is not g:
        idx = SignatureIndex.build(g)
        g._sig_index = idx
    return idx


def signature_rows(g) -> np.ndarray:
    """Per-vertex signature rows for ``g``.

    Plain graphs return the exact index table.  Snapshots return a
    conservative merge: base rows (zero-extended over delta-born
    vertices) with insert bits OR-ed in and tombstones ignored — an
    over-approximation, so superset pruning stays sound across updates.
    """
    if not getattr(g, "is_snapshot", False):
        return get_index(g).sig
    cached = getattr(g, "_sig_rows", None)
    if cached is not None:
        return cached
    idx = get_index(g.base)
    w = idx.n_words
    sig = idx.sig
    n_new = g.n_vertices - g.base.n_vertices
    ins_out, ins_in = g.coo["ins_out"], g.coo["ins_in"]
    if n_new or ins_out.size or ins_in.size:
        sig = np.vstack([sig, np.zeros((n_new, 2 * w), np.uint32)]) \
            if n_new else sig.copy()
        for d, off in ((ins_out, 0), (ins_in, w)):
            if d.size:
                _or_edges(sig, d.key.astype(np.int64), d.el, idx.n_bits, off)
    g._sig_rows = sig  # snapshots are immutable; attr cache is safe
    return sig


def required_signature(n_bits: int, q, u: int,
                       optional_groups: dict[int, int] | None = None
                       ) -> np.ndarray:
    """The folded signature a data vertex must carry to match query vertex
    ``u``: one out-bit per fixed-predicate edge where ``u`` is the subject,
    one in-bit per edge where it is the object.

    Edges reaching into a *different* optional group are skipped — ``u``
    can match with that group's pattern unmatched (left-join semantics),
    so their predicates are not required.  Edges within ``u``'s own group
    or to the required pattern are: any successful binding of ``u``
    implies they hold.
    """
    groups = optional_groups or {}
    gu = groups.get(u, -1)
    w = (n_bits + 31) // 32
    req = np.zeros(2 * w, dtype=np.uint32)
    for e in q.edges:
        if e.elabel < 0:
            continue
        for a, b, off in ((e.u, e.v, 0), (e.v, e.u, w)):
            if a != u:
                continue
            go = groups.get(b, -1)
            if go != -1 and go != gu:
                continue
            t = e.elabel % n_bits
            req[off + (t >> 5)] |= np.uint32(1 << (t & 31))
    return req


def prune_candidates(g, q, u: int, cands: np.ndarray,
                     optional_groups: dict[int, int] | None = None,
                     device: str = "cuda") -> np.ndarray:
    """Drop candidate vertices whose signature cannot satisfy query vertex
    ``u`` (the planner-side start/restart-candidate prune).  Sound: only
    vertices missing a required predicate are removed.  The probe runs on
    ``device`` against the index's cached device table."""
    if cands.size == 0:
        return cands
    idx = get_index(g)
    req = required_signature(idx.n_bits, q, u, optional_groups)
    if not req.any():
        return cands
    from repro_torch.kernels import ops as kops

    if getattr(g, "is_snapshot", False):
        rows = torch.from_numpy(
            np.ascontiguousarray(signature_rows(g)).view(np.int32)).to(device)
    else:
        rows = idx.dev(device)
    keep = kops.signature_filter(
        rows, torch.from_numpy(cands.astype(np.int32)).to(device),
        torch.from_numpy(req.view(np.int32)).to(device))
    return cands[keep.cpu().numpy()]


def patch_index(old: SignatureIndex, new_g: LabeledGraph, *,
                ins: np.ndarray, tombs: np.ndarray) -> SignatureIndex:
    """Exact index for the compacted graph: untouched rows carry over,
    rows of vertices incident to any inserted/tombstoned edge are
    recomputed from the new CSR.  Falls back to a full rebuild when the
    fold width changed (predicate vocabulary grew past the old modulus) —
    folded bits are not comparable across widths."""
    n_bits = sig_bits(new_g.n_elabels)
    if n_bits != old.n_bits:
        return SignatureIndex.build(new_g)
    w = old.n_words
    v_old = old.sig.shape[0]
    sig = np.zeros((new_g.n_vertices, 2 * w), dtype=np.uint32)
    sig[:v_old] = old.sig
    parts = [c[:, i] for c in (ins, tombs) if c.size for i in (0, 2)]
    touched = np.unique(np.concatenate(parts)) if parts else \
        np.zeros(0, np.int64)
    if touched.size:
        sig[touched] = 0
        is_touched = np.zeros(new_g.n_vertices, dtype=bool)
        is_touched[touched] = True
        for d, off in ((new_g.out, 0), (new_g.inc, w)):
            rows = np.repeat(np.arange(new_g.n_vertices, dtype=np.int64),
                             np.diff(d.indptr_all))
            m = is_touched[rows]
            if m.any():
                _or_edges(sig, rows[m], d.lab_all[m], n_bits, off)
    return SignatureIndex(new_g, n_bits, sig)
