"""Versioned live store: frozen base graph + copy-on-write delta snapshots.

``VersionedStore`` owns the mutable state (an :class:`EdgeDelta`, label
patches, new-vertex metadata, dictionary growth through the shared
``TransformMaps``) behind a lock.  ``snapshot()`` freezes the current delta
into an immutable :class:`Snapshot` — the object queries plan and execute
against.  A snapshot is *cheap*: it sorts the (small) delta buffers and
shares every base array; per-edge-label CSR rows, merged label bitmaps and
device tensors are derived lazily and cached on the snapshot, while padded
base rows are cached on the store so consecutive snapshots share them.
Every device cache is keyed by the torch device as well, so engines on
different devices can query one snapshot.

A ``Snapshot`` quacks like a :class:`~repro_torch.rdf.graph.LabeledGraph` for
everything the *planner* touches host-side (``candidates_with_labels``,
``predicate_index``, ``label_bitmap``, ``numeric_value``, ``freq``,
``out/inc.degree``) — all answers are exact for the merged graph.  The
*executor* recognizes ``is_snapshot`` and merges base CSR adjacency with
the snapshot's delta adjacency per step (see ``core.exec`` and
``kernels.ops.delta_merge``).

``compact()`` folds the delta into a fresh ``LabeledGraph`` (vertex /
edge-label ids are preserved, so compiled plans and the dictionary stay
valid) and incrementally patches the cached ``GraphStats`` instead of
recomputing them from scratch.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.exec import _tensor
from repro_torch.rdf.dictionary import RDF_TYPE, RDFS_SUBCLASSOF
from repro_torch.rdf.graph import LabeledGraph, pack_bitmap
from repro_torch.resilience import faults as _faults
from repro_torch.store.delta import DeltaCOO, EdgeDelta
from repro_torch.store.update_parser import UpdateError, parse_update
from repro_torch.utils import get_logger

log = get_logger("store.versioned")


class _SnapDirection:
    """Host-side stand-in for ``LabeledGraph.out`` / ``.inc``: only the
    pieces the planner reads (merged per-vertex degree)."""

    def __init__(self, snap: "Snapshot", forward: bool):
        self._snap = snap
        self._forward = forward
        self._degree: np.ndarray | None = None

    @property
    def degree(self) -> np.ndarray:
        if self._degree is None:
            s = self._snap
            base_dir = s.base.out if self._forward else s.base.inc
            deg = np.zeros(s.n_vertices, dtype=np.int64)
            deg[: s.base.n_vertices] = base_dir.degree
            ins = s.coo["ins_out" if self._forward else "ins_in"]
            tomb = s.coo["tomb_out" if self._forward else "tomb_in"]
            if ins.size:
                deg += np.bincount(ins.key, minlength=s.n_vertices)
            if tomb.size:
                deg -= np.bincount(tomb.key, minlength=s.n_vertices)
            self._degree = deg.astype(np.int32)
        return self._degree


class Snapshot:
    """Immutable view of the store at one version (base + frozen delta)."""

    is_snapshot = True
    supports_sampled_order = False  # planner falls back to greedy order

    def __init__(self, store: "VersionedStore", base: LabeledGraph,
                 version: int, epoch: int, n_vertices: int, n_elabels: int,
                 coo: dict[str, DeltaCOO],
                 new_vlabel_sets: list[tuple[int, ...]],
                 label_patch: dict[int, tuple[int, ...]],
                 numeric_value: np.ndarray | None):
        self.store = store
        self.base = base
        self.version = version
        self.epoch = epoch
        self.n_vertices = n_vertices
        self.n_elabels = n_elabels
        self.coo = coo
        self.new_vlabel_sets = new_vlabel_sets
        self.label_patch = label_patch
        self.numeric_value = numeric_value
        self.out = _SnapDirection(self, True)
        self.inc = _SnapDirection(self, False)
        self._label_bitmap: np.ndarray | None = None
        self._pred_index: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._dev: dict = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- metadata
    @property
    def n_vlabels(self) -> int:
        return self.base.n_vlabels

    @property
    def n_new_vertices(self) -> int:
        return self.n_vertices - self.base.n_vertices

    @property
    def n_edges(self) -> int:
        return (self.base.n_edges + self.coo["ins_out"].size
                - self.coo["tomb_out"].size)

    @property
    def has_delta(self) -> bool:
        return bool(self.coo["ins_out"].size or self.coo["tomb_out"].size
                    or self.n_new_vertices or self.label_patch)

    def token(self) -> tuple:
        """Identity for executor-side caches (epoch ties to the base)."""
        return (id(self.base), self.epoch, self.version)

    # ------------------------------------------------ host planner interface
    def _labels_of(self, v: int) -> tuple[int, ...]:
        if v >= self.base.n_vertices:
            return self.new_vlabel_sets[v - self.base.n_vertices]
        hit = self.label_patch.get(v)
        if hit is not None:
            return hit
        return self.base.vlabel_sets[v] if self.base.vlabel_sets else ()

    @property
    def label_bitmap(self) -> np.ndarray:
        if self._label_bitmap is None:
            base_bm = self.base.label_bitmap
            if not self.label_patch and not self.n_new_vertices:
                self._label_bitmap = base_bm
            else:
                n_bits = max(1, self.n_vlabels)
                new_rows = pack_bitmap(self.new_vlabel_sets, n_bits) \
                    if self.n_new_vertices else \
                    np.zeros((0, base_bm.shape[1]), np.uint32)
                merged = np.vstack([base_bm, new_rows])
                if self.label_patch:
                    vids = list(self.label_patch)
                    merged[vids] = pack_bitmap(
                        [self.label_patch[v] for v in vids], n_bits)
                self._label_bitmap = merged
        return self._label_bitmap

    def candidates_with_labels(self, labels: Sequence[int]) -> np.ndarray:
        if not labels:
            return np.arange(self.n_vertices, dtype=np.int32)
        cand = self.base.candidates_with_labels(labels)
        if not self.label_patch and not self.n_new_vertices:
            return cand
        req = set(labels)
        extra = [v for v, ls in self.label_patch.items() if req <= set(ls)]
        extra += [self.base.n_vertices + i
                  for i, ls in enumerate(self.new_vlabel_sets)
                  if req <= set(ls)]
        if self.label_patch:
            patched = np.fromiter(self.label_patch, dtype=np.int64,
                                  count=len(self.label_patch))
            cand = cand[~np.isin(cand, patched)]
        if extra:
            cand = np.union1d(cand, np.asarray(extra, dtype=np.int64))
        return np.sort(cand).astype(np.int32)

    def vertices_with_label(self, lbl: int) -> np.ndarray:
        return self.candidates_with_labels([lbl])

    def freq(self, labels: Sequence[int]) -> int:
        return int(self.candidates_with_labels(list(labels)).shape[0])

    def _merged_el_deg(self, el: int, keys: np.ndarray,
                       forward: bool) -> np.ndarray:
        """Exact merged (el, direction) degree for the given key vertices."""
        base_dir = self.base.out if forward else self.base.inc
        deg = np.zeros(keys.shape[0], dtype=np.int64)
        in_base = keys < self.base.n_vertices
        if el < self.base.n_elabels and in_base.any():
            row = base_dir.indptr_el[el]
            kb = keys[in_base]
            deg[in_base] = row[kb + 1] - row[kb]
        for name, sign in (("ins_out" if forward else "ins_in", 1),
                           ("tomb_out" if forward else "tomb_in", -1)):
            k_arr, _ = self.coo[name].el_slice(el)
            if k_arr.size:
                lo = np.searchsorted(k_arr, keys, side="left")
                hi = np.searchsorted(k_arr, keys, side="right")
                deg += sign * (hi - lo)
        return deg

    def predicate_index(self, el: int) -> tuple[np.ndarray, np.ndarray]:
        """(sorted distinct subjects, sorted distinct objects) of ``el`` in
        the merged graph — base index adjusted by the delta."""
        hit = self._pred_index.get(el)
        if hit is not None:
            return hit
        sides = []
        for forward in (True, False):
            if el < self.base.n_elabels:
                base_side = self.base.predicate_index(el)[0 if forward else 1]
            else:
                base_side = np.zeros(0, np.int32)
            ins_k, _ = self.coo["ins_out" if forward else "ins_in"].el_slice(el)
            tomb_k, _ = self.coo["tomb_out" if forward
                                 else "tomb_in"].el_slice(el)
            side = base_side
            if tomb_k.size:
                affected = np.unique(tomb_k).astype(np.int64)
                dead = affected[self._merged_el_deg(el, affected,
                                                    forward) <= 0]
                if dead.size:
                    side = side[~np.isin(side, dead)]
            if ins_k.size:
                side = np.union1d(side, np.unique(ins_k).astype(np.int64))
            sides.append(np.sort(side).astype(np.int32))
        self._pred_index[el] = (sides[0], sides[1])
        return self._pred_index[el]

    # ------------------------------------------------------- device arrays
    # Every upload is cached per torch device: one snapshot may be queried
    # from engines on different devices (a CUDA engine and its CPU check),
    # and each must receive tensors on its own device.  Bitmaps travel as
    # the int32 bit patterns of their uint32 words (``core.exec._tensor``).
    def el_clean(self, el: int, forward: bool) -> bool:
        """No delta inserts and no tombstones for (el, direction)."""
        ins = self.coo["ins_out" if forward else "ins_in"]
        tomb = self.coo["tomb_out" if forward else "tomb_in"]
        return (ins.el_slice(el)[0].size == 0
                and tomb.el_slice(el)[0].size == 0)

    def _dev_cached(self, key, device, build):
        device = torch.device(device)
        key = key + (device,)
        with self._lock:
            hit = self._dev.get(key)
            if hit is None:
                hit = build(device)
                self._dev[key] = hit
            return hit

    @staticmethod
    def _pad_pow2(a: np.ndarray, fill: int = -1, to: int = 1) -> np.ndarray:
        """Pad a delta value array to the next pow2 length ≥ ``to``.  Every
        read is bounded by an indptr slice over the real prefix, so the
        fill is never observed — the point is shape stability: consecutive
        snapshots keep the same array shapes until a bucket overflows."""
        from repro_torch.core.planner.ir import _next_pow2

        n = a.shape[0]
        target = _next_pow2(max(n, to))
        if n == target:
            return a
        return np.concatenate([a, np.full(target - n, fill, a.dtype)])

    def dev_el_step(self, el: int, forward: bool, n_pad: int,
                    device) -> dict:
        """Delta device arrays for one tree-edge step: ``d_iptr``/``d_nbr``
        for inserts and ``t_iptr``/``t_nbr`` for tombstones.

        Presence is decided per *direction*, not per label: once a
        direction has any inserts (or tombstones), every label gets its
        (possibly all-zero) rows.  A per-label decision would change which
        step arrays exist every time a batch first touches a label;
        direction granularity makes the structure stable from the first
        update on, at the cost of a no-op merge for still-clean labels."""

        def build(dev):
            d = {}
            for tag, name in (("d", "ins_out" if forward else "ins_in"),
                              ("t", "tomb_out" if forward else "tomb_in")):
                coo = self.coo[name]
                if not coo.size:
                    continue
                iptr, nbr = coo.el_rows(el, n_pad)
                # every label pads to the direction's LARGEST per-label
                # bucket, and buckets grow coarsely (floor 64, ×4 steps), so
                # shape changes are rare and happen for all labels at once
                bucket = 64
                need = int(np.bincount(coo.el).max(initial=1))
                while bucket < need:
                    bucket *= 4
                d[f"{tag}_iptr"] = _tensor(iptr, np.int32, dev)
                d[f"{tag}_nbr"] = _tensor(self._pad_pow2(nbr, to=bucket),
                                             np.int32, dev)
            return d

        return self._dev_cached(("el", el, forward, n_pad), device, build)

    def dev_plain(self, forward: bool, n_pad: int, device) -> dict:
        """Delta device arrays for a predicate-variable step: the plain
        all-labels insert CSR (+ edge labels) and the composite-key
        tombstone CSR (key = nbr * n_elabels + el)."""

        def build(dev):
            d = {}
            ins = self.coo["ins_out" if forward else "ins_in"]
            if ins.size:
                iptr, nbr, lab = ins.plain_rows(n_pad)
                d["d_iptr"] = _tensor(iptr, np.int32, dev)
                d["d_nbr"] = _tensor(self._pad_pow2(nbr), np.int32, dev)
                d["d_lab"] = _tensor(self._pad_pow2(lab), np.int32, dev)
            tomb = self.coo["tomb_out" if forward else "tomb_in"]
            if tomb.size:
                iptr, key = tomb.composite_rows(n_pad, self.n_elabels)
                d["t_iptr"] = _tensor(iptr, np.int32, dev)
                d["t_key"] = _tensor(self._pad_pow2(key), np.int32, dev)
            return d

        return self._dev_cached(("plain", forward, n_pad), device, build)

    def dev_flat(self, forward: bool, n_pad: int, device) -> dict:
        """Flattened per-(el, vertex) delta CSRs, layout ``el * (n_pad + 1)
        + v`` — the dynamic-edge-label non-tree probe tables."""

        def build(dev):
            d = {}
            for tag, name in (("d", "ins_out" if forward else "ins_in"),
                              ("t", "tomb_out" if forward else "tomb_in")):
                coo = self.coo[name]
                if not coo.size:
                    continue
                iptrs, nbrs, off = [], [], 0
                for el in range(self.n_elabels):
                    iptr, nbr = coo.el_rows(el, n_pad)
                    iptrs.append(iptr.astype(np.int64) + off)
                    nbrs.append(nbr)
                    off += nbr.size
                d[f"{tag}_flat_iptr"] = _tensor(np.concatenate(iptrs),
                                                np.int32, dev)
                flat_nbr = (np.concatenate(nbrs) if off
                            else np.zeros(1, np.int32))
                d[f"{tag}_flat_nbr"] = _tensor(self._pad_pow2(flat_nbr),
                                               np.int32, dev)
            return d

        return self._dev_cached(("flat", forward, n_pad), device, build)

    def dev_bitmap(self, n_pad: int, device):
        def build(dev):
            bm = self.label_bitmap
            if bm.shape[0] < n_pad:
                bm = np.vstack([bm, np.zeros((n_pad - bm.shape[0],
                                              bm.shape[1]), np.uint32)])
            return _tensor(bm, np.uint32, dev)

        return self._dev_cached(("bitmap", n_pad), device, build)

    def dev_sig(self, n_pad: int, device):
        """Padded per-vertex neighborhood-signature rows (conservative
        overlay: insert bits OR-ed onto the base index, tombstones
        ignored — see :func:`repro_torch.index.signature_rows`)."""

        def build(dev):
            from repro_torch.index import signature_rows

            sig = signature_rows(self)
            if sig.shape[0] < n_pad:
                sig = np.vstack([sig, np.zeros((n_pad - sig.shape[0],
                                                sig.shape[1]), np.uint32)])
            return _tensor(sig, np.uint32, dev)

        return self._dev_cached(("sig", n_pad), device, build)

    def dev_filter_bitmap(self, n_pad: int, device):
        """Padded (labels ++ signature) rows for the fused kernel's
        combined superset probe."""

        def build(dev):
            from repro_torch.index import signature_rows

            bm = self.label_bitmap
            sig = signature_rows(self)
            rows = max(bm.shape[0], sig.shape[0], n_pad)
            wide = np.zeros((rows, bm.shape[1] + sig.shape[1]), np.uint32)
            wide[:bm.shape[0], :bm.shape[1]] = bm
            wide[:sig.shape[0], bm.shape[1]:] = sig
            return _tensor(wide, np.uint32, dev)

        return self._dev_cached(("filter_bitmap", n_pad), device, build)

    def dev_numeric(self, n_pad: int, device):
        if self.numeric_value is None:
            return None

        def build(dev):
            nv = self.numeric_value.astype(np.float32)
            if nv.shape[0] < n_pad:
                nv = np.concatenate(
                    [nv, np.full(n_pad - nv.shape[0], np.nan, np.float32)])
            return _tensor(nv, np.float32, dev)

        return self._dev_cached(("numeric", n_pad), device, build)

    def base_el_row_padded(self, el: int, forward: bool, n_pad: int,
                           device):
        """Base per-label indptr row padded to ``n_pad + 1`` (cached on the
        store per device — shared by every snapshot of this epoch)."""
        return self.store._padded_base(("el", el, forward, n_pad), self.epoch,
                                       device, self._build_base_el_row, el,
                                       forward, n_pad)

    def _build_base_el_row(self, el: int, forward: bool, n_pad: int,
                           device):
        base_dir = self.base.out if forward else self.base.inc
        if 0 <= el < self.base.n_elabels:
            row = base_dir.indptr_el[el].astype(np.int64)
        else:  # label exists only in the delta
            row = np.zeros(self.base.n_vertices + 1, dtype=np.int64)
        if row.shape[0] < n_pad + 1:
            row = np.concatenate(
                [row, np.full(n_pad + 1 - row.shape[0], row[-1], np.int64)])
        return _tensor(row, np.int32, device)

    def base_plain_padded(self, forward: bool, n_pad: int, device):
        return self.store._padded_base(("plain", forward, n_pad), self.epoch,
                                       device, self._build_base_plain,
                                       forward, n_pad)

    def _build_base_plain(self, forward: bool, n_pad: int, device):
        base_dir = self.base.out if forward else self.base.inc
        row = base_dir.indptr_all.astype(np.int64)
        if row.shape[0] < n_pad + 1:
            row = np.concatenate(
                [row, np.full(n_pad + 1 - row.shape[0], row[-1], np.int64)])
        return _tensor(row, np.int32, device)


class VersionedStore:
    """Mutable store: immutable base graph + delta overlay + versioning.

    All mutating entry points take the store lock; ``snapshot()`` returns a
    cached immutable view that is invalidated by the next write.  Vertex,
    edge-label and vertex-label id spaces are append-only — ids handed out
    once stay valid across updates *and* compactions, which is what lets
    compiled plans and the serving layer's plan cache survive data changes.
    """

    def __init__(self, graph: LabeledGraph, maps=None, *,
                 compact_threshold: float = 0.25, compact_min: int = 4096,
                 auto_compact: bool = True):
        self.base = graph
        self.maps = maps
        self.version = 0
        self.epoch = 0
        self.compact_threshold = compact_threshold
        self.compact_min = compact_min
        self.auto_compact = auto_compact
        self._delta = EdgeDelta(graph)
        self._n_vertices = graph.n_vertices
        self._n_elabels = graph.n_elabels
        self._new_vlabel_sets: list[tuple[int, ...]] = []
        self._new_numeric: list[float] = []
        if maps is not None:
            # a reused TransformMaps may already have grown past this graph
            # (a previous store interned terms/predicates into it) — resume
            # from its id space so stale ids are never reassigned; the gap
            # vertices exist, label-free and edge-free, in every snapshot
            n0 = len(maps.vertex_to_term)
            if n0 > self._n_vertices:
                gap = n0 - self._n_vertices
                self._new_vlabel_sets = [()] * gap
                self._new_numeric = [math.nan] * gap
                self._n_vertices = n0
            self._n_elabels = max(self._n_elabels, len(maps.elabel_to_pred))
        self._label_patch: dict[int, tuple[int, ...]] = {}
        self._snapshot: Snapshot | None = None
        self._pad_cache: dict = {}
        self._lock = threading.RLock()
        self.counters = {"inserted": 0, "deleted": 0, "compactions": 0}

    # ------------------------------------------------------------ plumbing
    def _padded_base(self, key, epoch, device, build, *args):
        device = torch.device(device)
        full = (epoch,) + key + (device,)
        with self._lock:
            hit = self._pad_cache.get(full)
            if hit is None:
                hit = build(*args, device)
                self._pad_cache[full] = hit
            return hit

    def _dirty(self) -> None:
        self._snapshot = None
        self.version += 1

    def delta_size(self) -> int:
        return len(self._delta)

    def should_compact(self) -> bool:
        return len(self._delta) >= max(
            self.compact_min,
            int(self.compact_threshold * max(1, self.base.n_edges)))

    # ------------------------------------------------------ graph-level API
    def add_vertex(self, labels: Sequence[int] = (),
                   numeric: float = math.nan) -> int:
        with self._lock:
            for lbl in labels:
                if not 0 <= lbl < self.base.n_vlabels:
                    raise ValueError(f"vertex label {lbl} out of range "
                                     f"(new label spaces need a re-transform)")
            vid = self._n_vertices
            self._n_vertices += 1
            self._new_vlabel_sets.append(tuple(sorted(set(labels))))
            self._new_numeric.append(float(numeric))
            self._dirty()
            return vid

    def insert_edges(self,
                     edges: Iterable[tuple[int, int, int]]) -> int:
        """Insert (src, elabel, dst) edges; returns how many changed state.
        Edge labels ≥ n_elabels extend the label space; vertex ids must
        already exist (``add_vertex`` first)."""
        with self._lock:
            n = 0
            for s, el, o in edges:
                if not (0 <= s < self._n_vertices
                        and 0 <= o < self._n_vertices):
                    raise ValueError(f"edge ({s},{el},{o}) references an "
                                     f"unknown vertex (n={self._n_vertices})")
                if el < 0:
                    raise ValueError("edge label must be >= 0")
                self._n_elabels = max(self._n_elabels, int(el) + 1)
                n += self._delta.insert(s, el, o)
            if n:
                self.counters["inserted"] += n
                self._dirty()
            return n

    def delete_edges(self,
                     edges: Iterable[tuple[int, int, int]]) -> int:
        with self._lock:
            n = 0
            for s, el, o in edges:
                n += self._delta.delete(int(s), int(el), int(o))
            if n:
                self.counters["deleted"] += n
                self._dirty()
            return n

    def set_vertex_labels(self, vid: int, labels: Sequence[int]) -> bool:
        """Replace a vertex's label set (monotone growth is what the RDF
        layer uses; arbitrary replacement is allowed at graph level)."""
        with self._lock:
            for lbl in labels:
                if not 0 <= lbl < self.base.n_vlabels:
                    raise ValueError(f"vertex label {lbl} out of range")
            new = tuple(sorted(set(labels)))
            if vid >= self.base.n_vertices:
                i = vid - self.base.n_vertices
                if self._new_vlabel_sets[i] == new:
                    return False
                self._new_vlabel_sets[i] = new
            else:
                cur = self._label_patch.get(
                    vid, self.base.vlabel_sets[vid]
                    if self.base.vlabel_sets else ())
                if cur == new:
                    return False
                self._label_patch[vid] = new
            self._dirty()
            return True

    # -------------------------------------------------------- RDF-level API
    def _require_maps(self):
        if self.maps is None:
            raise UpdateError("store has no TransformMaps; RDF-level updates "
                              "need the transform's term mappings")
        return self.maps

    def _vertex_for_term(self, term: str, pending: list[int]) -> int:
        maps = self._require_maps()
        vid = maps.vertex_of(term)
        if vid is not None:
            return vid
        tid = maps.dict.encode_term(term)
        vid = self._n_vertices
        self._n_vertices += 1
        self._new_vlabel_sets.append(())
        self._new_numeric.append(_numeric_of(term))
        maps.term_to_vertex[tid] = vid
        pending.append(tid)
        return vid

    def _elabel_for_pred(self, pred: str, create: bool) -> int | None:
        maps = self._require_maps()
        el = maps.elabel_of(pred)
        if el is not None or not create:
            return el
        pid = maps.dict.encode_predicate(pred)
        el = self._n_elabels
        self._n_elabels += 1
        maps.pred_to_elabel[pid] = el
        maps.elabel_to_pred = np.append(maps.elabel_to_pred, pid)
        return el

    def _labels_of(self, vid: int) -> tuple[int, ...]:
        if vid >= self.base.n_vertices:
            return self._new_vlabel_sets[vid - self.base.n_vertices]
        hit = self._label_patch.get(vid)
        if hit is not None:
            return hit
        return self.base.vlabel_sets[vid] if self.base.vlabel_sets else ()

    def _validate_triples(self, action: str,
                          triples: list[tuple[str, str, str]]) -> None:
        """Raise for any triple this store cannot apply.  Every
        ``UpdateError`` source is checkable up front, which is what makes
        a batch (and a whole ``apply_update`` request) all-or-nothing."""
        maps = self._require_maps()
        if maps.kind != "type_aware":
            return
        for _s, p, o in triples:
            if p == RDFS_SUBCLASSOF:
                raise UpdateError(
                    "rdf:subClassOf updates change the class hierarchy; "
                    "re-transform the dataset instead")
            if p != RDF_TYPE:
                continue
            if action == "delete":
                raise UpdateError(
                    "deleting rdf:type triples under the type-aware "
                    "transform requires a re-transform (label closures "
                    "are not invertible)")
            if maps.vlabel_of(o) is None:
                raise UpdateError(
                    f"rdf:type object {o!r} is not a known class; "
                    "new classes require a re-transform")

    def insert_triples(self,
                       triples: Iterable[tuple[str, str, str]]) -> int:
        """Insert decoded (subject, predicate, object) string triples.
        Under the type-aware transform, ``rdf:type`` triples with a *known*
        class grow the subject's label set through the class closure; new
        classes or ``rdf:subClassOf`` assertions raise (they change the
        label space and need a re-transform)."""
        maps = self._require_maps()
        type_aware = maps.kind == "type_aware"
        with self._lock:
            triples = list(triples)
            # validate BEFORE touching any state: a failed batch applies
            # nothing (no half-applied prefix leaking into the next
            # successful update's version)
            self._validate_triples("insert", triples)
            n = 0
            pending: list[int] = []
            try:
                for s, p, o in triples:
                    if type_aware and p == RDF_TYPE:
                        lbl = maps.vlabel_of(o)
                        closure = (maps.hierarchy.expand_types({lbl})
                                   if maps.hierarchy is not None else {lbl})
                        vid = self._vertex_for_term(s, pending)
                        cur = self._labels_of(vid)
                        new = tuple(sorted({*cur, *closure}))
                        if new != cur:
                            if vid >= self.base.n_vertices:
                                self._new_vlabel_sets[
                                    vid - self.base.n_vertices] = new
                            else:
                                self._label_patch[vid] = new
                            n += 1
                        continue
                    el = self._elabel_for_pred(p, create=True)
                    sv = self._vertex_for_term(s, pending)
                    ov = self._vertex_for_term(o, pending)
                    n += self._delta.insert(sv, el, ov)
            finally:
                self._flush_terms(pending)
            if n:
                self.counters["inserted"] += n
                self._dirty()
            return n

    def delete_triples(self,
                       triples: Iterable[tuple[str, str, str]]) -> int:
        """Delete decoded string triples.  Unknown terms/predicates are
        no-ops (nothing to delete).  ``rdf:type`` retraction under the
        type-aware transform raises: label closures are not invertible
        without the direct type sets, so it needs a re-transform."""
        maps = self._require_maps()
        with self._lock:
            triples = list(triples)
            self._validate_triples("delete", triples)
            n = 0
            for s, p, o in triples:
                el = self._elabel_for_pred(p, create=False)
                sv = maps.vertex_of(s)
                ov = maps.vertex_of(o)
                if el is None or sv is None or ov is None:
                    continue
                n += self._delta.delete(sv, el, ov)
            if n:
                self.counters["deleted"] += n
                self._dirty()
            return n

    def _flush_terms(self, pending: list[int]) -> None:
        if pending:
            maps = self.maps
            maps.vertex_to_term = np.concatenate(
                [maps.vertex_to_term, np.asarray(pending, dtype=np.int64)])

    def apply_update(self, text: str) -> dict:
        """Parse and apply SPARQL UPDATE text atomically: every op is
        validated before any is applied, so a rejected request mutates
        nothing.  Auto-compacts past the threshold.  Returns counters for
        the serving layer."""
        ops = parse_update(text)
        with self._lock:
            for op in ops:
                self._validate_triples(op.action, op.triples)
            # fault-injection site: after validation, before any mutation —
            # an injected commit fault must leave the store untouched
            _faults.fire("store_commit")
            inserted = deleted = 0
            for op in ops:
                if op.action == "insert":
                    inserted += self.insert_triples(op.triples)
                else:
                    deleted += self.delete_triples(op.triples)
            compacted = False
            if self.auto_compact and self.should_compact():
                self.compact()
                compacted = True
            return {"inserted": inserted, "deleted": deleted,
                    "compacted": compacted, "version": self.version,
                    "delta": len(self._delta)}

    # ------------------------------------------------------------ snapshots
    def snapshot(self) -> Snapshot:
        with self._lock:
            if self._snapshot is None:
                self._snapshot = Snapshot(
                    store=self, base=self.base, version=self.version,
                    epoch=self.epoch, n_vertices=self._n_vertices,
                    n_elabels=self._n_elabels,
                    coo=self._delta.materialize(),
                    new_vlabel_sets=list(self._new_vlabel_sets),
                    label_patch=dict(self._label_patch),
                    numeric_value=self._merged_numeric())
            return self._snapshot

    def _merged_numeric(self) -> np.ndarray | None:
        base_nv = self.base.numeric_value
        if base_nv is None and not self._new_numeric:
            return None
        if base_nv is None:
            base_nv = np.full(self.base.n_vertices, np.nan, np.float64)
        if not self._new_numeric:
            return base_nv
        return np.concatenate(
            [base_nv, np.asarray(self._new_numeric, dtype=np.float64)])

    def _merged_vlabel_sets(self) -> list[tuple[int, ...]]:
        base_sets = self.base.vlabel_sets or \
            [()] * self.base.n_vertices
        merged = list(base_sets)
        for vid, ls in self._label_patch.items():
            merged[vid] = ls
        merged.extend(self._new_vlabel_sets)
        return merged

    # ----------------------------------------------------------- compaction
    def compact(self) -> Snapshot:
        """Fold the delta into a fresh ``LabeledGraph`` (ids preserved) and
        incrementally patch the base's cached ``GraphStats``."""
        from repro_torch.stats import patch_stats

        with self._lock:
            base = self.base
            src = np.repeat(np.arange(base.n_vertices, dtype=np.int64),
                            np.diff(base.out.indptr_all))
            dst = base.out.nbr_all.astype(np.int64)
            el = base.out.lab_all.astype(np.int64)
            tombs = np.asarray(list(self._delta.tombs), dtype=np.int64) \
                if self._delta.tombs else np.zeros((0, 3), np.int64)
            ins = np.asarray(list(self._delta.inserts), dtype=np.int64) \
                if self._delta.inserts else np.zeros((0, 3), np.int64)
            if tombs.shape[0]:
                nv, nel = self._n_vertices, self._n_elabels
                assert nv * nel * nv < 2**62, "composite edge key overflow"
                key = (src * nel + el) * nv + dst
                tkey = (tombs[:, 0] * nel + tombs[:, 1]) * nv + tombs[:, 2]
                keep = ~np.isin(key, tkey)
                src, el, dst = src[keep], el[keep], dst[keep]
            if ins.shape[0]:
                src = np.concatenate([src, ins[:, 0]])
                el = np.concatenate([el, ins[:, 1]])
                dst = np.concatenate([dst, ins[:, 2]])
            label_changes = [
                (vid, base.vlabel_sets[vid] if base.vlabel_sets else (), ls)
                for vid, ls in self._label_patch.items()]
            label_changes += [
                (base.n_vertices + i, (), ls)
                for i, ls in enumerate(self._new_vlabel_sets)]
            new_g = LabeledGraph.build(
                n_vertices=self._n_vertices, src=src, el=el, dst=dst,
                n_elabels=self._n_elabels,
                vlabel_sets=self._merged_vlabel_sets(),
                n_vlabels=base.n_vlabels,
                numeric_value=self._merged_numeric())
            old_stats = getattr(base, "_graph_stats", None)
            if old_stats is not None:
                new_g._graph_stats = patch_stats(
                    old_stats, new_g, ins=ins, tombs=tombs,
                    label_changes=label_changes)
            # repro_torch.index maintenance: snapshots ran on conservative
            # overlays; compaction restores *exact* structures by patching
            # only the touched rows / count cells (same contract as
            # GraphStats — asserted against a rebuild in tests)
            old_sig = getattr(base, "_sig_index", None)
            if old_sig is not None:
                from repro_torch.index import patch_index

                new_g._sig_index = patch_index(old_sig, new_g,
                                               ins=ins, tombs=tombs)
            old_sum = getattr(base, "_summary_graph", None)
            if old_sum is not None:
                from repro_torch.index import patch_summary

                new_g._summary_graph = patch_summary(
                    old_sum, new_g, ins=ins, tombs=tombs,
                    label_changes=label_changes)
            log.info("compacted store: %d vertices, %d edges (delta was %d)",
                     new_g.n_vertices, new_g.n_edges, len(self._delta))
            self.base = new_g
            self._delta = EdgeDelta(new_g)
            self._new_vlabel_sets = []
            self._new_numeric = []
            self._label_patch = {}
            self._pad_cache.clear()
            self.epoch += 1
            self.counters["compactions"] += 1
            self._dirty()
            return self.snapshot()


def _numeric_of(term: str) -> float:
    if term.startswith('"'):
        end = term.find('"', 1)
        lex = term[1:end] if end > 0 else term.strip('"')
        try:
            return float(lex)
        except ValueError:
            return math.nan
    return math.nan
