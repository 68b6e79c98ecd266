"""Vectorized e-graph-homomorphism executor on PyTorch.

The port of ``repro.core.exec``: a breadth-first *binding table* pipeline
that expands a table of partial embeddings ``B int32[capacity, |V(q)|]``
one query vertex at a time along the plan's matching order.  Each step is
a capacity-bounded ragged expansion over CSR adjacency slices followed by
vectorized filters (label bitmap, bound id, signature prune, degree / NLF,
numeric, injectivity under ``semantics="iso"``, non-tree joins through
binary search or the +INT tile compare, predicate-variable bindings), then
an order-preserving compaction.

The chunk program is an eager torch step loop over the plan, with the
reference's contract: each step runs at its own power-of-two capacity, a
step whose expansion exceeds its capacity *freezes* the chunk (the table is
carried unchanged through the later steps and the program reports the
overflowing step), and the host resumes from exactly that step with its
capacity doubled.  Steps with no non-tree checks run through the fused
expand/filter/compact kernel.  On a live-store snapshot, a tree step whose
direction carries a delta resolves its slots through ``delta_merge`` (base
CSR slice ++ delta slice, tombstones masked) instead, and non-tree joins
probe the base, tombstone and insert CSRs.  Kernels dispatch by the
tensors' device (:mod:`repro_torch.kernels.ops`): on CUDA the hand-written
Hopper kernels, on the CPU their plain versions.

A parameterized plan (one per query shape) reads its constants from a
``params`` vector on the device.  ``Executor.run_batch`` answers many
constant vectors of one shape with a batch program (``build_batch_fn``):
the reference ``vmap``s its chunk program over lanes; here the lanes' rows
form one table with a lane index per row, so each step is one set of
kernel launches for the whole batch, with per-lane capacities, freezes and
counters.

Nothing inside a chunk program reads a device value back to the host:
compaction is a cumsum-position scatter, and every per-step counter goes
into one packed int64 vector that the host reads once per chunk program,
after the next chunk has been enqueued (``ExecOpts.async_chunks``).

Bitmaps, masks and signatures live on the device as int32 bit patterns of
the reference's uint32 words (converted where they are uploaded:
:meth:`DeviceGraph.from_graph`, the plan arrays and the snapshot's device
tensors).

One executor may run on several threads at once (the serving scheduler's
workers).  They launch on their current stream, the device's default
stream unless a caller set another, so their kernels are ordered by that
stream.  What they share on the host is guarded: the learned capacity
schedules (a lock; a run works on its own copy of its schedule and merges
growth back, so a schedule only grows), the program cache (the first build
wins) and the small-plan verdicts (either verdict gives the same answers).
A profiled run times its steps on its thread's own stream
(``_StepTimer``), so other threads' work on the default stream is not in
its step times.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.analysis.roofline import estimate_step_ms
from repro_torch.core.planner import ExecPlan, Step
from repro_torch.core.planner.ir import _next_pow2
from repro_torch.kernels import ops as kops
from repro_torch.rdf.graph import LabeledGraph
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.cancel import CancelToken, QueryCancelled
from repro_torch.resilience.policy import (
    MAX_LEVEL,
    DegradationBreaker,
    RetryPolicy,
    degrade_opts,
    is_transient_fault,
)
from repro_torch.utils import get_logger

log = get_logger("core.exec")

I32 = torch.int32
I64 = torch.int64


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on.  ``"cuda"`` (the default of
    every entry point) raises when CUDA is absent: the port never carries on
    on the CPU unless the caller asked for ``"cpu"``."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain PyTorch path")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return d


def _tensor(x, dtype, device) -> torch.Tensor:
    """Host array -> device tensor (a copy; empty arrays pad to one row)."""
    x = np.array(x, dtype=dtype)
    if x.size == 0:
        x = np.zeros((1,) + x.shape[1:], dtype=dtype)
    if dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x).to(device)


def _scalar(v: int, device, dtype=I32) -> torch.Tensor:
    """A device scalar made by a fill, not a host copy (no stream sync)."""
    return torch.full((), v, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# Device-resident graph
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceGraph:
    n_vertices: int
    n_elabels: int
    n_vlabels: int
    max_log_deg: int
    arrays: dict[str, torch.Tensor]
    host: LabeledGraph
    device: torch.device
    # per-edge-label max degree (host, for the +INT tile decision)
    max_deg_out_el: np.ndarray = field(default=None)  # type: ignore[assignment]
    max_deg_in_el: np.ndarray = field(default=None)  # type: ignore[assignment]
    # --- live-store (snapshot) mode ---------------------------------------
    # delta_mode=True: ``arrays`` holds only the *base* graph; the merged
    # label bitmap / numeric column and all delta CSRs flow in per call via
    # the step arrays, so chunk programs are reused across snapshots of the
    # same base.  ``pad_vertices`` is the pow2-padded vertex bound every
    # per-vertex gather is sized/clamped to (stable across snapshots until
    # the vertex count crosses the bucket); ``base_vertices`` /
    # ``base_elabels`` bound the base-CSR id spaces.
    delta_mode: bool = False
    base_vertices: int = 0
    base_elabels: int = 0
    pad_vertices: int = 0

    def key(self) -> tuple:
        """Identity for the chunk-program cache, as in the reference.  The
        *logical* vertex count is absent in snapshot mode: programs depend
        only on the pow2-padded bound, so growing the vertex set inside one
        pad bucket keeps every chunk program."""
        return (self.delta_mode, self.pad_vertices,
                self.base_vertices, self.n_elabels, self.max_log_deg)

    @staticmethod
    def from_snapshot(snap, with_nlf: bool = False, with_prune: bool = False,
                      device="cuda") -> "DeviceGraph":
        """Device view of a live-store snapshot: the base graph's arrays
        (cached on the base per ``(with_nlf, with_prune, device)``, shared
        by successive snapshots) plus snapshot-mode metadata.  Delta arrays
        are not uploaded here: they are per-plan step inputs (see
        ``Executor._snapshot_arrays``)."""
        device = resolve_device(device)
        want = (bool(with_nlf), bool(with_prune), device)
        cache = snap.base.__dict__.setdefault("_device_graphs_torch", {})
        base_dg = cache.get(want)
        if base_dg is None:
            base_dg = DeviceGraph.from_graph(snap.base, with_nlf=with_nlf,
                                             with_prune=with_prune,
                                             device=device)
            cache[want] = base_dg
        return replace(
            base_dg,
            n_vertices=snap.n_vertices,
            n_elabels=snap.n_elabels,
            max_log_deg=32,  # safe bound: merged degrees are unbounded
            delta_mode=True,
            base_vertices=snap.base.n_vertices,
            base_elabels=snap.base.n_elabels,
            pad_vertices=_next_pow2(max(snap.n_vertices, 8)),
        )

    @staticmethod
    def from_graph(g: LabeledGraph, with_nlf: bool = False,
                   with_prune: bool = False,
                   device="cuda") -> "DeviceGraph":
        device = resolve_device(device)

        def dev(x, dtype):
            return _tensor(x, dtype, device)

        arrays = {
            "out_nbr_el": dev(g.out.nbr_el, np.int32),
            "in_nbr_el": dev(g.inc.nbr_el, np.int32),
            "out_indptr_all": dev(g.out.indptr_all, np.int32),
            "in_indptr_all": dev(g.inc.indptr_all, np.int32),
            "out_nbr_all": dev(g.out.nbr_all, np.int32),
            "in_nbr_all": dev(g.inc.nbr_all, np.int32),
            "out_lab_all": dev(g.out.lab_all, np.int32),
            "in_lab_all": dev(g.inc.lab_all, np.int32),
            "label_bitmap": dev(g.label_bitmap, np.uint32),
            "out_degree": dev(g.out.degree, np.int32),
            "in_degree": dev(g.inc.degree, np.int32),
        }
        if g.numeric_value is not None:
            arrays["numeric_value"] = dev(g.numeric_value, np.float32)
        if with_nlf:
            nlf_o, nlf_i = g.nlf_bitmaps()
            arrays["nlf_out"] = dev(nlf_o, np.uint32)
            arrays["nlf_in"] = dev(nlf_i, np.uint32)
        if with_prune:
            from repro_torch.index import get_index

            idx = get_index(g)
            arrays["sig"] = idx.dev(device)
            # the fused expand/filter/compact kernel is width-generic in the
            # bitmap, so composing the signature probe with the label filter
            # is just a wider bitmap (labels ++ signature) and a combined mask
            arrays["filter_bitmap"] = dev(
                np.hstack([g.label_bitmap, idx.sig]), np.uint32)
        max_deg = int(max(g.out.degree.max(initial=1), g.inc.degree.max(initial=1)))
        mdo = (np.max(np.diff(g.out.indptr_el, axis=1), axis=1, initial=0)
               if g.n_elabels else np.zeros(0, np.int64))
        mdi = (np.max(np.diff(g.inc.indptr_el, axis=1), axis=1, initial=0)
               if g.n_elabels else np.zeros(0, np.int64))
        return DeviceGraph(
            n_vertices=g.n_vertices,
            n_elabels=g.n_elabels,
            n_vlabels=g.n_vlabels,
            max_log_deg=max(2, int(np.ceil(np.log2(max(2, max_deg)))) + 1),
            arrays=arrays,
            host=g,
            device=device,
            max_deg_out_el=mdo,
            max_deg_in_el=mdi,
            base_vertices=g.n_vertices,
            base_elabels=g.n_elabels,
            pad_vertices=g.n_vertices,
        )


# --------------------------------------------------------------------------
# Options / results
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ExecOpts:
    semantics: str = "hom"  # "hom" (RDF) or "iso" (classical subgraph iso)
    use_int: bool = True  # +INT: bulk tile-compare joins where tiles fit
    use_nlf: bool = False  # paper default: disabled (-NLF)
    use_deg: bool = False  # paper default: disabled (-DEG)
    reuse_order: bool = True  # +REUSE
    int_tile: int = 128  # adjacency tile bound for the +INT path
    chunk: int = 8192  # starting vertices per chunk
    init_cap: int = 4096
    max_cap: int = 1 << 22
    # --- adaptive pipeline toggles (all False/1 ≈ the legacy executor) ---
    cap_schedule: bool = True  # per-step capacity schedule from the planner
    suffix_resume: bool = True  # overflow resumes from the overflowing step
    async_chunks: int = 2  # chunk programs kept in flight before readback
    use_fused: bool = True  # fused expand/filter/compact kernel fast path
    cap_slack: float = 1.0  # schedule headroom (pow2 rounding adds ~1.5x already)
    use_prune: bool = True  # neighborhood-signature pruning (repro_torch.index)
    profile: bool = False  # per-step wall-time stats (adds host syncs)
    # absolute time.monotonic() deadline; checked between chunk dispatches
    # and suffix-resume re-entries (None = no deadline); not in key()
    deadline: float | None = None

    def key(self) -> tuple:
        return (self.semantics, self.use_int, self.use_nlf, self.use_deg,
                self.int_tile, self.use_fused, self.use_prune)


@dataclass
class Result:
    count: int
    bindings: np.ndarray | None  # int32 [count, |V(q)|] (None if count-only)
    pvar_bindings: np.ndarray | None  # int32 [count, n_pvars]
    origins: np.ndarray | None = None  # source-row ids (for extension runs)
    chunks_retried: int = 0
    stats: dict[str, Any] = field(default_factory=dict)


# --------------------------------------------------------------------------
# Step arrays: per-plan device constants
# --------------------------------------------------------------------------


def _label_mask(g: LabeledGraph, labels: tuple[int, ...]) -> np.ndarray:
    n_words = g.label_bitmap.shape[1]
    mask = np.zeros(n_words, dtype=np.uint32)
    for lbl in labels:
        mask[lbl >> 5] |= np.uint32(1 << (lbl & 31))
    return mask


def _plan_arrays(g: LabeledGraph, plan: ExecPlan, use_prune: bool,
                 device) -> list[dict[str, torch.Tensor]]:
    """Per-step device constants: CSR indptr rows, label masks, etc."""
    def dev(x, dtype=np.int32):
        return _tensor(x, dtype, device)

    out: list[dict[str, torch.Tensor]] = []
    flat_out = flat_in = None
    if any(c.pvar_idx >= 0 for s in plan.steps for c in s.nontree):
        flat_out = dev(g.out.indptr_el.reshape(-1))
        flat_in = dev(g.inc.indptr_el.reshape(-1))
    for s in plan.steps:
        # the fused kernel reads a baked bound id on the device, as it reads
        # a parameterized one from ``params``
        d: dict[str, torch.Tensor] = {
            "bound_id": _scalar(s.bound_id, device)}
        if s.restart_candidates is not None:
            cands = s.restart_candidates.astype(np.int32)
            d["restart"] = dev(cands)
            d["restart_n"] = _scalar(int(cands.size), device)
        elif s.elabel >= 0:
            dirn = g.out if s.forward else g.inc
            d["iptr"] = dev(dirn.indptr_el[s.elabel])
        if s.labels:
            d["label_mask"] = dev(_label_mask(g, s.labels), np.uint32)
        if use_prune and s.sig_mask is not None \
                and s.restart_candidates is None:
            # restart steps carry pre-pruned candidate arrays; tree steps
            # probe on device.  ``fmask`` = labels ++ signature drives the
            # fused kernel's single combined superset test.
            d["sig_mask"] = dev(s.sig_mask, np.uint32)
            lm = _label_mask(g, s.labels) if s.labels else \
                np.zeros(g.label_bitmap.shape[1], np.uint32)
            d["fmask"] = dev(np.concatenate([lm, s.sig_mask]), np.uint32)
        if s.nlf_out_mask is not None:
            d["nlf_out_mask"] = dev(s.nlf_out_mask, np.uint32)
            d["nlf_in_mask"] = dev(s.nlf_in_mask, np.uint32)
        for ci, c in enumerate(s.nontree):
            use_out = c.forward or c.self_loop
            if c.pvar_idx >= 0:
                d[f"nt{ci}_flat"] = flat_out if use_out else flat_in
            else:
                dirn = g.out if use_out else g.inc
                d[f"nt{ci}_iptr"] = dev(dirn.indptr_el[c.elabel])
        out.append(d)
    return out


# --------------------------------------------------------------------------
# The chunk program
# --------------------------------------------------------------------------


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Pad a table/vector along dim 0 with nulls up to ``rows`` (a new
    tensor whenever rows are added)."""
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    fill = torch.full((pad,) + tuple(x.shape[1:]), -1, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill])


def _nontree_mask(dg: DeviceGraph, step: Step, sarr, b_rows, p_rows, v_new,
                  opts: ExecOpts) -> torch.Tensor:
    n = dg.pad_vertices if dg.delta_mode else dg.n_vertices
    ok = torch.ones(v_new.shape[0], dtype=torch.bool, device=v_new.device)
    for ci, c in enumerate(step.nontree):
        use_out = c.forward or c.self_loop
        nbr = dg.arrays["out_nbr_el" if use_out else "in_nbr_el"]
        probe = v_new if c.self_loop else b_rows[:, c.other]
        if c.pvar_idx >= 0:
            psafe = probe.clamp(0, n - 1)
            el_raw = p_rows[:, c.pvar_idx]
            bound_ok = el_raw >= 0
            if dg.delta_mode:
                # base flat tables cover the base id spaces only; probes or
                # labels born in the delta have no base edges by definition
                in_base = (probe < dg.base_vertices) & \
                    (el_raw < dg.base_elabels)
                pb = probe.clamp(0, dg.base_vertices - 1)
                el_b = el_raw.clamp(0, dg.base_elabels - 1)
                flat = sarr[f"nt{ci}_flat"]
                bi = el_b * (dg.base_vertices + 1) + pb
                found = kops.edge_exists(nbr, flat[bi], flat[bi + 1], v_new,
                                         n_iters=dg.max_log_deg) & in_base
                fi = el_raw.clamp(0, dg.n_elabels - 1) * (n + 1) + psafe
                tf = sarr.get(f"nt{ci}_t_flat_iptr")
                if tf is not None:
                    dead = kops.edge_exists(
                        sarr[f"nt{ci}_t_flat_nbr"], tf[fi], tf[fi + 1],
                        v_new, n_iters=dg.max_log_deg)
                    found = found & ~dead
                df = sarr.get(f"nt{ci}_d_flat_iptr")
                if df is not None:
                    found = found | kops.edge_exists(
                        sarr[f"nt{ci}_d_flat_nbr"], df[fi], df[fi + 1],
                        v_new, n_iters=dg.max_log_deg)
            else:
                flat = sarr[f"nt{ci}_flat"]
                base = el_raw.clamp(0, dg.n_elabels - 1) * (n + 1)
                lo = flat[base + psafe]
                hi = flat[base + psafe + 1]
                found = kops.edge_exists(nbr, lo, hi, v_new,
                                         n_iters=dg.max_log_deg)
            ok = ok & found & bound_ok
            continue
        iptr = sarr[f"nt{ci}_iptr"]
        if dg.delta_mode:
            psafe = probe.clamp(0, n - 1)
            # base membership (padded rows: zero-degree past the base id
            # spaces), minus tombstones, plus delta inserts; +INT tiles only
            # cover the base CSR, so delta mode always searches
            found = kops.edge_exists(nbr, iptr[psafe], iptr[psafe + 1],
                                     v_new, n_iters=dg.max_log_deg)
            ti = sarr.get(f"nt{ci}_t_iptr")
            if ti is not None:
                dead = kops.edge_exists(sarr[f"nt{ci}_t_nbr"], ti[psafe],
                                        ti[psafe + 1], v_new,
                                        n_iters=dg.max_log_deg)
                found = found & ~dead
            di = sarr.get(f"nt{ci}_d_iptr")
            if di is not None:
                found = found | kops.edge_exists(
                    sarr[f"nt{ci}_d_nbr"], di[psafe], di[psafe + 1], v_new,
                    n_iters=dg.max_log_deg)
            ok = ok & found
            continue
        max_deg = int(
            (dg.max_deg_out_el if use_out else dg.max_deg_in_el)[c.elabel]
        )
        if opts.use_int and 0 < max_deg <= opts.int_tile:
            # +INT: test every candidate of this step against the probe
            # side's whole adjacency tile (bounded by int_tile); the kernel
            # clamps the probe and reads the tile from iptr and nbr itself
            tb = _next_pow2(max(8, max_deg))
            found = kops.tile_membership(v_new, nbr, iptr=iptr, probe=probe,
                                         tb=tb)
        else:
            psafe = probe.clamp(0, n - 1)
            found = kops.edge_exists(nbr, iptr[psafe], iptr[psafe + 1],
                                     v_new, n_iters=dg.max_log_deg)
        ok = ok & found
    return ok


def _fused_eligible(step: Step, opts: ExecOpts) -> bool:
    """Steps the fused expand/filter/compact kernel covers: a tree edge (or
    restart) whose only filters are the label bitmap and a bound ID."""
    return (opts.use_fused and not step.nontree and opts.semantics == "hom"
            and step.pvar_idx < 0 and not step.num_filters
            and not step.min_out_ntypes and not step.min_in_ntypes
            and step.nlf_out_mask is None)


def _cmp(vals: torch.Tensor, op: str, c: float) -> torch.Tensor:
    c = float(np.float32(c))  # the float32 constant, compared in float32
    if op == "<":
        return vals < c
    if op == "<=":
        return vals <= c
    if op == ">":
        return vals > c
    if op == ">=":
        return vals >= c
    if op == "=":
        return vals == c
    if op == "!=":
        return vals != c
    raise ValueError(op)


class ProgramKey(NamedTuple):
    """A chunk program's identity, as the reference keys its compile cache:
    the plan, the step window and its capacities, the input width, and the
    options' and device graph's keys; a batch program (``run_batch``) also
    its lane count and whether each lane has its own start row.  The delta
    arrays' sizes are not in it: an eager program takes any size."""
    plan: Any
    caps: tuple
    n_in: int
    table_input: bool
    collect: str
    start: int
    stop: int
    opts: tuple
    graph: tuple
    lanes: int = 0  # 0: a single-query program
    per_lane_start: bool = False


def _check_caps(caps, n_in: int, start_step: int, stop: int) -> None:
    for si in range(start_step, stop):
        prev = n_in if si == start_step else caps[si - 1]
        if caps[si] < prev:
            raise ValueError(
                "capacity schedule must be monotone non-decreasing "
                f"(step {si}: {caps[si]} < {prev})")


class _StepSrc(NamedTuple):
    """Where a step's candidates come from, per input row."""
    nbr_src: torch.Tensor
    start: torch.Tensor
    deg: torch.Tensor  # 0 for rows that are not alive
    deg_b: torch.Tensor | None  # base part of a merged slice
    start_d: torch.Tensor | None
    t_lo: torch.Tensor | None
    t_hi: torch.Tensor | None
    merged: bool  # live store: base slice ++ delta slice, tombstones masked


def _step_src(dg: DeviceGraph, step: Step, sarr, b: torch.Tensor,
              alive: torch.Tensor) -> _StepSrc:
    dmode = dg.delta_mode
    arrays = dg.arrays
    n = dg.pad_vertices if dmode else dg.n_vertices
    # delta overlay per-step inputs (snapshot mode only)
    d_iptr = sarr.get("d_iptr") if dmode else None
    t_iptr = sarr.get("t_iptr") if dmode else None
    start_d = deg_b = t_lo = t_hi = None
    if step.restart_candidates is not None:
        deg = torch.where(alive, sarr["restart_n"], 0)
        nbr_src = sarr["restart"]
        start = torch.zeros(alive.shape[0], dtype=I32, device=alive.device)
        return _StepSrc(nbr_src, start, deg, None, None, None, None, False)
    if step.elabel >= 0:
        iptr = sarr["iptr"]
        nbr_src = arrays["out_nbr_el" if step.forward else "in_nbr_el"]
    else:  # predicate variable: plain CSR
        iptr = sarr["all_iptr"] if dmode else \
            arrays["out_indptr_all" if step.forward else "in_indptr_all"]
        nbr_src = arrays["out_nbr_all" if step.forward else "in_nbr_all"]
    vp = b[:, step.parent].clamp(0, n - 1)
    start = iptr[vp]
    deg_b = iptr[vp + 1] - start
    deg = deg_b
    if d_iptr is not None:
        start_d = d_iptr[vp]
        deg = deg + (d_iptr[vp + 1] - start_d)
    if t_iptr is not None:
        t_lo, t_hi = t_iptr[vp], t_iptr[vp + 1]
    deg = torch.where(alive, deg, 0)
    return _StepSrc(nbr_src, start, deg, deg_b, start_d, t_lo, t_hi,
                    d_iptr is not None or t_iptr is not None)


def _unfused_ok(dg: DeviceGraph, plan: ExecPlan, step: Step, sarr,
                opts: ExecOpts, src: _StepSrc, row, j, valid, b, p, org,
                bid: torch.Tensor | None):
    """An unfused step after ``ragged_expand``: resolve each slot's
    candidate, extend the rows and run every filter.  ``bid`` is the
    parameterized bound id (a scalar, or one per slot), ``None`` for a
    baked step.  Returns ``(b_rows, p_rows, org_rows, ok, pre_sig,
    post_sig)``; the last two are the masks just before and just after the
    signature probe (``None`` when the step has none)."""
    dmode = dg.delta_mode
    arrays = dg.arrays
    n = dg.pad_vertices if dmode else dg.n_vertices
    nbr_src = src.nbr_src
    el_new = None
    if src.merged:
        # live store: position j < deg_b reads the base CSR (minus
        # tombstones), later positions read the delta
        d_nbr = sarr.get("d_nbr")
        if step.elabel >= 0:
            # the row-level fields as they are: the kernel reads each slot's
            # row itself
            v_new, ok = kops.delta_merge(
                nbr_src, d_nbr, sarr.get("t_nbr"), src.start, src.deg_b,
                src.start_d, src.t_lo, src.t_hi, j, valid,
                n_iters=dg.max_log_deg, row=row)
        else:
            zero = torch.zeros_like(row)
            sd = src.start_d[row] if src.start_d is not None else zero
            tl = src.t_lo[row] if src.t_lo is not None else zero
            th = src.t_hi[row] if src.t_hi is not None else zero
            lab_src = arrays["out_lab_all" if step.forward else "in_lab_all"]
            v_new, el_new, ok = kops.delta_merge_labeled(
                nbr_src, lab_src, d_nbr, sarr.get("d_lab"),
                sarr.get("t_key"), src.start[row], src.deg_b[row], sd, tl,
                th, j, valid, n_elabels=dg.n_elabels,
                n_iters=dg.max_log_deg)
    else:
        idx = (src.start[row] + j).clamp(0, nbr_src.shape[0] - 1)
        v_new = torch.where(valid, nbr_src[idx], -1)
        ok = valid

    b_rows = b[row]
    p_rows = p[row]
    org_rows = org[row]
    b_rows[:, step.u] = v_new

    if step.pvar_idx >= 0:  # tree-edge M_e binding
        if el_new is None:
            lab_src = arrays["out_lab_all" if step.forward else "in_lab_all"]
            el_new = torch.where(valid, lab_src[idx], -1)
        prev = p_rows[:, step.pvar_idx].clone()
        ok = ok & ((prev < 0) | (prev == el_new))
        p_rows[:, step.pvar_idx] = torch.where(prev < 0, el_new, prev)
    if bid is not None:
        ok = ok & (v_new == bid)
    elif step.bound_id >= 0:
        ok = ok & (v_new == step.bound_id)
    vsafe = v_new.clamp(0, n - 1)
    bitmap_src = sarr.get("bitmap") if dmode else arrays["label_bitmap"]
    # the filters gather their rows at vsafe in the kernel: no gathered copy
    if "label_mask" in sarr:
        ok = ok & kops.bitmap_superset(bitmap_src, sarr["label_mask"],
                                       ids=vsafe)
    pre_sig = post_sig = None
    sig_mask = sarr.get("sig_mask")
    sig_src = (sarr.get("sig") if dmode else arrays.get("sig")) \
        if sig_mask is not None else None
    if sig_src is not None:
        pre_sig = ok
        ok = ok & kops.signature_filter(sig_src, vsafe, sig_mask)
        post_sig = ok
    if (step.min_out_ntypes or step.min_in_ntypes) and not dmode:
        # degree/NLF prunes use base-build summaries that no delta
        # maintains, so snapshots skip them (they are pure optimizations)
        ok = ok & (arrays["out_degree"][vsafe] >= step.min_out_ntypes)
        ok = ok & (arrays["in_degree"][vsafe] >= step.min_in_ntypes)
    if "nlf_out_mask" in sarr and "nlf_out" in arrays and not dmode:
        ok = ok & kops.bitmap_superset(arrays["nlf_out"],
                                       sarr["nlf_out_mask"], ids=vsafe)
        ok = ok & kops.bitmap_superset(arrays["nlf_in"],
                                       sarr["nlf_in_mask"], ids=vsafe)
    num_src = sarr.get("numeric") if dmode else arrays.get("numeric_value")
    if step.num_filters and num_src is not None:
        vals = num_src[vsafe]
        for op, cval in step.num_filters:
            ok = ok & _cmp(vals, op, cval)
    if opts.semantics == "iso":
        for w in plan.order:
            if w == step.u:
                break
            ok = ok & (b_rows[:, w] != v_new)
    if step.nontree:
        ok = ok & _nontree_mask(dg, step, sarr, b_rows, p_rows, v_new, opts)
    return b_rows, p_rows, org_rows, ok, pre_sig, post_sig


def build_chunk_fn(dg: DeviceGraph, plan: ExecPlan, caps: tuple[int, ...],
                   n_in: int, opts: ExecOpts, table_input: bool,
                   collect: str = "bindings", start_step: int = 0,
                   stop_step: int | None = None):
    """Build the chunk program for plan steps ``[start_step, stop_step)``
    with the per-step capacity schedule ``caps``.

    ``table_input=False``: the input is a vector of start-vertex candidates
    (``n_in`` wide) and the program seeds the binding table from it.
    ``table_input=True``: the input is ``(B0, count, P0, origins)`` rows of
    capacity ``n_in`` (OPTIONAL extensions and suffix-resume re-entries).

    Overflow: the first step whose expansion total exceeds its capacity
    freezes the table (later steps pass it through unchanged) and becomes
    ``ovf_step`` (``len(steps)`` = completed); the frozen table is exactly
    the input that step needs on re-entry.  ``caps`` must be monotone
    non-decreasing from ``n_in`` so the freeze carry is lossless.  With
    ``collect="count"`` the final step only tallies survivors.

    ``params`` (int32 ``[plan.n_params]`` on the device, ``None`` for a
    fully baked plan) is an input of the program: a step with
    ``param_slot >= 0`` checks its new binding against
    ``params[param_slot]`` (the fused kernel reads it on the device), so
    one program serves every constant vector of the shape.

    The program returns ``(b, p, org, count, scalars)``: the binding table,
    pvar table and origins (device tensors), the device count, and one
    int64 vector ``[count, ovf_step, totals..., kepts..., pins...,
    pouts...]`` over the executed steps (``-1`` once frozen / no probe) —
    the only thing the host reads back per chunk program.
    """
    nq = plan.query.n_vertices
    npv = max(1, plan.n_pvars)
    steps = plan.steps
    n_steps = len(steps)
    stop = n_steps if stop_step is None else stop_step
    dmode = dg.delta_mode
    arrays = dg.arrays
    _check_caps(caps, n_in, start_step, stop)

    def fn(chunk, chunk_count, p_init, org_init, params, sarrs):
        dev = chunk.device
        if not table_input:
            b = torch.full((n_in, nq), -1, dtype=I32, device=dev)
            b[:, plan.start_vertex] = chunk
            p = torch.full((n_in, npv), -1, dtype=I32, device=dev)
            org = torch.arange(n_in, dtype=I32, device=dev)
            count = chunk_count.clamp(max=n_in).to(I32)
        else:
            b, p, org = chunk, p_init, org_init
            count = chunk_count.to(I32)

        none = _scalar(-1, dev, I64)
        ovf_step = _scalar(n_steps, dev)  # sentinel: completed
        totals: list[torch.Tensor] = []
        kepts: list[torch.Tensor] = []
        pins: list[torch.Tensor] = []
        pouts: list[torch.Tensor] = []
        cap_prev = n_in
        for si in range(start_step, stop):
            step = steps[si]
            sarr = sarrs[si]
            cap = caps[si]
            active = ovf_step == n_steps
            alive = torch.arange(cap_prev, dtype=I32, device=dev) < count
            src = _step_src(dg, step, sarr, b, alive)
            deg = src.deg

            # int64 prefix sums: the total cannot wrap, so an oversized
            # expansion is always reported as overflow
            coffs = torch.cumsum(deg, 0, dtype=I64)
            total = coffs[-1]
            offs = (coffs - deg).to(I32)
            ovf_here = active & (total > cap)
            keep_new = active & ~ovf_here
            ovf_step = torch.where(ovf_here, si, ovf_step)
            count_only = collect == "count" and si == n_steps - 1

            p_in = p_out = None
            if _fused_eligible(step, opts) and not count_only \
                    and not src.merged:
                fmask = sarr.get("fmask")
                fb_src = (sarr.get("filter_bitmap") if dmode
                          else arrays.get("filter_bitmap")) \
                    if fmask is not None else None
                if fmask is not None and fb_src is not None:
                    # composed label + signature probe: one superset test
                    # over the widened (labels ++ signature) bitmap
                    filt_bitmap, filt_mask = fb_src, fmask
                    p_in = total
                else:
                    filt_bitmap = sarr.get("bitmap") if dmode \
                        else arrays["label_bitmap"]
                    filt_mask = sarr.get("label_mask")
                    if filt_mask is None:
                        filt_mask = torch.zeros(filt_bitmap.shape[1],
                                                dtype=I32, device=dev)
                bound = params[step.param_slot] if step.param_slot >= 0 \
                    else sarr["bound_id"]
                v_out, row_sel, kept = kops.expand_filter_compact(
                    src.nbr_src, filt_bitmap, src.start, deg, offs,
                    filt_mask, bound, cap)
                if p_in is not None:
                    p_out = kept
                # gather-based table build: when frozen, the identity index
                # carries the old table through
                ident = torch.arange(cap, dtype=I32,
                                     device=dev).clamp(max=cap_prev - 1)
                idg = torch.where(keep_new, row_sel.clamp(0, cap_prev - 1),
                                  ident)
                nb = b[idg]
                nb[:, step.u] = torch.where(keep_new, v_out, nb[:, step.u])
                b, p, org = nb, p[idg], org[idg]
                count = torch.where(keep_new, kept, count)
            else:
                row, j, valid = kops.ragged_expand(offs, deg, cap)
                bid = params[step.param_slot] if step.param_slot >= 0 \
                    else None
                b_rows, p_rows, org_rows, ok, pre_sig, post_sig = \
                    _unfused_ok(dg, plan, step, sarr, opts, src, row, j,
                                valid, b, p, org, bid)
                if pre_sig is not None:
                    p_in = pre_sig.sum(dtype=I32)
                    p_out = post_sig.sum(dtype=I32)
                oki = ok.to(I32)
                kept = oki.sum(dtype=I32)
                if count_only:
                    # final tally only: carry the (possibly frozen) table —
                    # no compacted binding table is materialized
                    b = _pad_rows(b, cap)
                    p = _pad_rows(p, cap)
                    org = _pad_rows(org, cap)
                else:
                    pos = torch.where(ok, torch.cumsum(oki, 0, dtype=I32) - 1,
                                      cap)
                    pos = torch.where(keep_new, pos, cap)  # frozen: drop all
                    # scatter into the padded previous table: rows the
                    # scatter misses keep stale values beyond ``count``,
                    # which every consumer masks on — and when frozen the
                    # untouched pad IS the carried table
                    b = _pad_rows(b, cap + 1)
                    p = _pad_rows(p, cap + 1)
                    org = _pad_rows(org, cap + 1)
                    b[pos] = b_rows
                    p[pos] = p_rows
                    org[pos] = org_rows
                    b, p, org = b[:cap], p[:cap], org[:cap]
                count = torch.where(keep_new, kept, count)

            totals.append(torch.where(active, total, none))
            kepts.append(torch.where(keep_new, count.to(I64), none))
            if p_in is None:
                pins.append(none)
                pouts.append(none)
            else:
                pins.append(torch.where(active, p_in.to(I64), none))
                pouts.append(torch.where(keep_new, p_out.to(I64), none))
            cap_prev = cap

        scalars = torch.stack([count.to(I64), ovf_step.to(I64),
                               *totals, *kepts, *pins, *pouts])
        return b, p, org, count, scalars

    return fn


def _lane_sums(x: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Per-lane sums of ``x`` over lane-major runs: lane ``l`` owns
    ``x[bounds[l]:bounds[l+1]]`` (int64 prefix-sum differences)."""
    c = torch.cumsum(x, 0, dtype=I64)
    c = torch.cat([c.new_zeros(1), c])
    return c[bounds[1:]] - c[bounds[:-1]]


def build_batch_fn(dg: DeviceGraph, plan: ExecPlan, caps: tuple[int, ...],
                   n_in: int, lanes: int, opts: ExecOpts,
                   collect: str = "bindings"):
    """The chunk program for ``lanes`` queries of one parameterized shape,
    with the lane axis written out: the rows of every lane form one
    binding table, lane-major, with a lane index per row, so each step is
    one set of kernel launches for the whole batch.

    Every lane starts from ``n_in`` start rows (``chunk`` int32
    ``[lanes, n_in]``: its own start vertex, or the shared start set) and
    reads its constants from its row of ``pmat`` (int32 ``[lanes,
    n_params]``).  Each lane has its own capacity ``caps[si]`` per step and
    freezes on its own: a lane whose expansion total passes its cap reports
    the step in its ``ovf_step`` and drops its rows (the caller reruns it
    alone), while the other lanes go on.  Compaction is stable over the
    whole table, so each lane keeps stream order.  Every step runs
    unfused (``ragged_expand`` and the filter kernels).

    The program returns ``(b, p, org, scalars)``: the tables (lane ``l``'s
    rows follow lanes ``< l``'s) and an int64 ``[lanes, 2 + 4 * steps]``
    matrix of ``[count, ovf_step, totals..., kepts..., pins...,
    pouts...]`` per lane, with the single-query program's ``-1``
    sentinels — the only thing the host reads back."""
    nq = plan.query.n_vertices
    npv = max(1, plan.n_pvars)
    steps = plan.steps
    n_steps = len(steps)
    _check_caps(caps, n_in, 0, n_steps)

    def fn(chunk, pmat, sarrs):
        dev = chunk.device
        rows0 = lanes * n_in
        # each row's lane
        ln = torch.arange(lanes, dtype=I32, device=dev).repeat_interleave(n_in)
        b = torch.full((rows0, nq), -1, dtype=I32, device=dev)
        b[:, plan.start_vertex] = chunk.reshape(-1)
        p = torch.full((rows0, npv), -1, dtype=I32, device=dev)
        org = torch.arange(n_in, dtype=I32, device=dev).repeat(lanes)
        cnt = torch.full((lanes,), n_in, dtype=I64, device=dev)
        count = _scalar(rows0, dev, I64)

        none = torch.full((lanes,), -1, dtype=I64, device=dev)
        active = torch.ones(lanes, dtype=torch.bool, device=dev)
        ovf_step = torch.full((lanes,), n_steps, dtype=I64, device=dev)
        totals, kepts, pins, pouts = [], [], [], []
        for si, step in enumerate(steps):
            sarr = sarrs[si]
            cap = caps[si]
            out_rows = lanes * cap
            alive = torch.arange(b.shape[0], device=dev) < count
            src = _step_src(dg, step, sarr, b, alive)
            # row runs of the lanes: the table is compacted lane-major
            row_bounds = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])
            total = _lane_sums(src.deg, row_bounds)
            ovf_here = active & (total > cap)
            keep = active & ~ovf_here
            ovf_step = torch.where(ovf_here, si, ovf_step)
            # a frozen or overflowing lane expands nothing from here on
            deg = torch.where(keep[ln], src.deg, 0)
            coffs = torch.cumsum(deg, 0, dtype=I64)
            offs = (coffs - deg).to(I32)
            slot_bounds = torch.cat([coffs.new_zeros(1), coffs])[row_bounds]
            row, j, valid = kops.ragged_expand(offs, deg, out_rows)
            ln_rows = ln[row]
            bid = pmat[ln_rows, step.param_slot] if step.param_slot >= 0 \
                else None
            b_rows, p_rows, org_rows, ok, pre_sig, post_sig = _unfused_ok(
                dg, plan, step, sarr, opts, src, row, j, valid, b, p, org,
                bid)
            kept = _lane_sums(ok.to(I32), slot_bounds)
            cnt = torch.where(keep, kept, 0)
            count = cnt.sum()
            if not (collect == "count" and si == n_steps - 1):
                pos = torch.where(ok, torch.cumsum(ok.to(I64), 0) - 1,
                                  out_rows)
                b = torch.full((out_rows + 1, nq), -1, dtype=I32, device=dev)
                p = torch.full((out_rows + 1, npv), -1, dtype=I32,
                               device=dev)
                org = torch.full((out_rows + 1,), -1, dtype=I32, device=dev)
                new_ln = torch.zeros(out_rows + 1, dtype=I32, device=dev)
                b[pos] = b_rows
                p[pos] = p_rows
                org[pos] = org_rows
                new_ln[pos] = ln_rows
                b, p, org, ln = (b[:out_rows], p[:out_rows], org[:out_rows],
                                 new_ln[:out_rows])
            totals.append(torch.where(active, total, none))
            kepts.append(torch.where(keep, cnt, none))
            if pre_sig is None:
                pins.append(none)
                pouts.append(none)
            else:
                pins.append(torch.where(
                    active, _lane_sums(pre_sig.to(I32), slot_bounds), none))
                pouts.append(torch.where(
                    keep, _lane_sums(post_sig.to(I32), slot_bounds), none))
            active = keep

        scalars = torch.stack([cnt, ovf_step, *totals, *kepts, *pins,
                               *pouts], dim=1)
        return b, p, org, scalars

    return fn


# --------------------------------------------------------------------------
# Host-level executor
# --------------------------------------------------------------------------


def _grow_caps(caps: list[int], si: int, max_cap: int) -> list[int]:
    """Double step ``si``'s capacity after an overflow (raising once it is
    already at ``max_cap``) and restore monotonicity for later steps.
    Mutates and returns ``caps``."""
    if caps[si] >= max_cap:
        raise RuntimeError(
            f"binding-table overflow at max capacity {max_cap};"
            " raise ExecOpts.max_cap")
    caps[si] = min(max_cap, caps[si] * 2)
    for j in range(si + 1, len(caps)):
        caps[j] = max(caps[j], caps[si])
    return caps


_SMALL_PLAN_ROWS = 512.0
_SMALL_PLAN_STEPS = 6


def _small_plan(plan: ExecPlan, opts: ExecOpts) -> bool:
    """Is this plan a *candidate* for skipping the pipelined machinery?  A
    tiny expected result, few steps, no estimated intermediate blow-up, and
    a start set that fits one chunk; the executor settles shortlisted plans
    with a one-time timed probe of both configurations."""
    if not (opts.cap_schedule or opts.use_fused or opts.suffix_resume):
        return False  # already running the legacy configuration
    if not plan.steps or len(plan.steps) > _SMALL_PLAN_STEPS:
        return False
    if plan.start_candidates.shape[0] > opts.chunk:
        return False
    peak = max(plan.est_rows, default=plan.estimated_rows())
    return (plan.estimated_rows() <= _SMALL_PLAN_ROWS
            and peak <= 4 * _SMALL_PLAN_ROWS)


def _empty_stats(n_steps: int) -> dict[str, Any]:
    return {
        "step_rows": [0] * n_steps,
        "step_kept": [0] * n_steps,
        "step_retries": [0] * n_steps,
        "step_prune_in": [0] * n_steps,
        "step_prune_out": [0] * n_steps,
        "step_wall_ms": None,
        "caps": [],
        "chunks": 0,
        "resumes": 0,
        "compiles": 0,
        "wall_ms": 0.0,
    }


def _step_kernel_name(dg: DeviceGraph, step: Step, sarr: dict,
                      opts: ExecOpts, count_only: bool) -> str:
    """Which kernel a step runs through — mirrors the dispatch in
    ``build_chunk_fn`` (fused fast path vs. ragged expand vs. live-store
    delta merge)."""
    if dg.delta_mode and ("d_iptr" in sarr or "t_iptr" in sarr):
        return "delta_merge" if step.elabel >= 0 else "delta_merge_labeled"
    if _fused_eligible(step, opts) and not count_only:
        return "expand_filter"
    return "ragged_expand"


def _annotate_step_spans(trace, plan: ExecPlan, dg: DeviceGraph, sarrs,
                         opts: ExecOpts, stats: dict, collect: str,
                         n_src: int) -> None:
    """Attach one summary span per plan step: executed-counter meta
    (rows/kept/retries/capacity), the kernel that ran, and a roofline
    estimate for this device type next to the measured wall time (profiled
    runs have real per-step durations; others report zero-duration
    spans)."""
    backend = dg.device.type
    nq = plan.query.n_vertices
    bitmap_words = int(dg.arrays["label_bitmap"].shape[1])
    wall = stats.get("step_wall_ms")
    caps = stats.get("caps") or []
    rows_in = float(n_src)
    for si, step in enumerate(plan.steps):
        count_only = collect == "count" and si == len(plan.steps) - 1
        kernel = _step_kernel_name(dg, step, sarrs[si], opts, count_only)
        expanded = stats["step_rows"][si]
        kept = stats["step_kept"][si]
        cap = int(caps[si]) if si < len(caps) else 0
        meta: dict[str, Any] = {
            "step": si, "kernel": kernel, "rows": expanded, "kept": kept,
            "retries": stats["step_retries"][si], "capacity": cap,
        }
        if step.sig_mask is not None:
            p_in = stats["step_prune_in"][si]
            meta["prune_in"] = p_in
            meta["prune_out"] = stats["step_prune_out"][si]
            if p_in:
                meta["prune_ratio"] = round(
                    stats["step_prune_out"][si] / p_in, 4)
        if step.nontree:
            meta["nontree_checks"] = len(step.nontree)
        est = estimate_step_ms(
            kernel, backend=backend, expanded=expanded, rows=rows_in,
            capacity=cap, nq=nq, bitmap_words=bitmap_words,
            n_iters=dg.max_log_deg)
        model_ms = est["model_ms"]
        for _ in step.nontree:
            model_ms += estimate_step_ms(
                "edge_exists", backend=backend, expanded=expanded,
                n_iters=dg.max_log_deg)["model_ms"]
        meta["model_ms"] = round(model_ms, 6)
        meta["model_dominant"] = est["dominant"]
        dur_s = (wall[si] / 1e3) if wall is not None else 0.0
        trace.add("step", dur_s, **meta)
        rows_in = float(kept)


class _StepTimer:
    """Times the steps of one profiled chunk on ``device``.

    On CUDA the chunk runs on ``stream``, the calling thread's own timing
    stream (after the current stream's earlier work), and each step is
    timed with CUDA events on it, so a step's time holds this query's work
    alone, not the work other threads queued on the shared default stream
    meanwhile.  The stream has high priority: the card hands its blocks
    out before those of kernels already waiting on other streams, so a
    step does not wait for another thread's long kernel to drain either.
    On exit the current stream waits for it.  On the CPU a step is timed
    by the host clock."""

    def __init__(self, device: torch.device, stream=None):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self._caller = torch.cuda.current_stream(device)
            self._stream = stream

    @contextlib.contextmanager
    def stream(self):
        if not self.cuda:
            yield
            return
        self._stream.wait_stream(self._caller)
        try:
            with torch.cuda.stream(self._stream):
                yield
        finally:
            self._caller.wait_stream(self._stream)

    def start(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def stop_ms(self, start) -> float:
        """Milliseconds since ``start``, once the step's work is done."""
        if not self.cuda:
            return (time.perf_counter() - start) * 1e3
        end = torch.cuda.Event(enable_timing=True)
        end.record(self._stream)
        end.synchronize()
        return start.elapsed_time(end)


def _poisoned(out):
    """Injected silent corruption: this chunk's count reads as zero."""
    b, p, org, count, scalars = out
    scalars = scalars.clone()
    scalars[0] = 0
    return b, p, org, count * 0, scalars


class Executor:
    """Chunked plan executor on one torch device: per-step capacity
    schedule, suffix-resume on overflow, in-flight chunk dispatch, a
    per-plan chunk-program cache, and the transient-fault ladder.

    ``g`` may be a plain :class:`LabeledGraph` or a live-store
    :class:`~repro_torch.store.versioned.Snapshot`.  In snapshot mode the
    base graph's device arrays are shared across snapshots, delta CSRs flow
    in per call through the step arrays (so chunk programs survive
    updates), and start / restart candidate sets are re-resolved against
    the current snapshot, which also makes plans built against an older
    version execute correctly.

    ``run`` executes one plan (with ``params`` for a parameterized one);
    ``run_batch`` answers a batch of constant vectors of one parameterized
    plan.  ``device`` defaults to ``"cuda"`` and raises without CUDA; pass
    ``"cpu"`` to run the kernels' plain versions.  ``policy`` / ``breaker``
    carry a previous executor's retry policy and learned degradations
    into a rebuilt one (the engine rebuilds after a compaction)."""

    def __init__(self, g, opts: ExecOpts | None = None, *, device="cuda",
                 policy: RetryPolicy | None = None,
                 breaker: DegradationBreaker | None = None):
        self.opts = opts or ExecOpts()
        self.device = resolve_device(device)
        self._policy = policy or RetryPolicy.from_env()
        self._breaker = breaker or DegradationBreaker(
            cooldown_s=self._policy.cooldown_s)
        self._res_counters = {"degraded_runs": 0, "fault_retries": 0,
                              "escalations": 0}
        if getattr(g, "is_snapshot", False):
            view = g
            self.graph = g.base
            dg = DeviceGraph.from_snapshot(g, with_nlf=self.opts.use_nlf,
                                           with_prune=self.opts.use_prune,
                                           device=self.device)
        else:
            view = None
            self.graph = g
            dg = DeviceGraph.from_graph(g, with_nlf=self.opts.use_nlf,
                                        with_prune=self.opts.use_prune,
                                        device=self.device)
        # (view, dg) swap together in one tuple assignment, so a query that
        # pinned the pair mid-update stays on one version
        self._state: tuple[Any, DeviceGraph] = (view, dg)
        self._compiled: dict[ProgramKey, Any] = {}
        # learned per-plan capacity schedules (overflow doublings persist,
        # so later chunks / queries start right-sized); runs on several
        # threads read and grow them under the lock
        self._caps_cache: dict[tuple, list[int]] = {}
        self._caps_lock = threading.Lock()
        # learned pipelined-vs-legacy choice for small plans (_small_plan);
        # two threads may both probe a plan, and the later verdict stays
        self._small_mode: dict[tuple, bool] = {}
        # each thread's high-priority stream for profiled steps
        # (_StepTimer), made at its first profiled run: the caching
        # allocator keeps blocks per stream, so a thread reuses its own
        self._timing = threading.local()

    @property
    def view(self):
        return self._state[0]

    @property
    def dg(self) -> DeviceGraph:
        return self._state[1]

    def pin(self) -> tuple[Any, DeviceGraph]:
        """Capture the current (view, dg) pair.  Callers composing several
        ``run`` calls into one logical query pass it to each, so a
        concurrent ``set_snapshot`` cannot tear the query across
        versions."""
        return self._state

    def set_snapshot(self, snap) -> None:
        """Swap to a newer snapshot of the *same* base graph.  Chunk
        programs are reused (only the delta step arrays change); in-flight
        queries keep executing against the state they pinned."""
        if self.view is None or snap.base is not self.graph:
            raise ValueError("snapshot has a different base graph; "
                             "build a new Executor")
        self._state = (snap,
                       DeviceGraph.from_snapshot(
                           snap, with_nlf=self.opts.use_nlf,
                           with_prune=self.opts.use_prune,
                           device=self.device))

    @property
    def policy(self) -> RetryPolicy:
        return self._policy

    @property
    def breaker(self) -> DegradationBreaker:
        return self._breaker

    def resilience_snapshot(self) -> dict:
        """Breaker state + fault counters."""
        d = self._breaker.snapshot()
        d.update(self._res_counters)
        return d

    def program_keys(self) -> set[ProgramKey]:
        """The keys of the chunk programs built so far."""
        return set(self._compiled)

    def _get_fn(self, plan: ExecPlan, caps: tuple[int, ...], n_in: int,
                table_input: bool, collect: str, start: int, stop: int,
                dg: DeviceGraph, opts: ExecOpts):
        """The chunk program for this window, built once per key — the
        reference's compile-cache key, so ``stats["compiles"]`` counts the
        same events.  (There is no buffer donation: an eager torch program
        allocates its outputs, and the caching allocator reuses the freed
        inputs' memory.)"""
        key = ProgramKey(plan.signature(), caps[start:stop], n_in,
                         table_input, collect, start, stop, opts.key(),
                         dg.key())
        fn = self._compiled.get(key)
        fresh = fn is None
        if fresh:
            _faults.fire("compile")
            built = build_chunk_fn(dg, plan, caps, n_in, opts,
                                   table_input, collect, start, stop)
            # another thread may have built the same program meanwhile:
            # the first one in the cache is used, and only its build counts
            fn = self._compiled.setdefault(key, built)
            fresh = fn is built
        return fn, fresh

    def _arrays(self, plan: ExecPlan,
                state: tuple) -> list[dict[str, torch.Tensor]]:
        view, dg = state
        if view is not None:
            return self._snapshot_arrays(plan, view, dg)
        # cache on the plan object itself (an id()-keyed dict can collide
        # when a dead plan's id is recycled by the allocator)
        use_prune = self.opts.use_prune
        cached = getattr(plan, "_dev_arrays_torch", None)
        if cached is not None and cached[0] is self.graph \
                and cached[1] == use_prune and cached[2] == self.device:
            return cached[3]
        arrs = _plan_arrays(self.graph, plan, use_prune, self.device)
        plan._dev_arrays_torch = (self.graph, use_prune, self.device, arrs)  # type: ignore[attr-defined]
        return arrs

    def _snapshot_arrays(self, plan: ExecPlan, snap,
                         dg: DeviceGraph) -> list[dict[str, torch.Tensor]]:
        """Per-step device constants for snapshot execution: padded base
        CSR rows, the snapshot's delta/tombstone CSRs, merged label bitmap,
        signature and numeric column, and freshly resolved (and re-pruned)
        restart candidates.  Cached on the plan per (snapshot, prune,
        device)."""
        from repro_torch.core.planner.cost import CostModel

        use_prune = self.opts.use_prune
        dev = self.device
        token = (snap.token(), use_prune, dev)
        cached = getattr(plan, "_dev_arrays_snap_torch", None)
        if cached is not None and cached[0] == token:
            return cached[1]
        _faults.fire("delta_merge")
        n_pad = dg.pad_vertices
        cm = CostModel(snap)
        flat_cache: dict[bool, torch.Tensor] = {}

        def base_flat(fwd: bool) -> torch.Tensor:
            if fwd not in flat_cache:
                dirn = self.graph.out if fwd else self.graph.inc
                flat_cache[fwd] = _tensor(dirn.indptr_el.reshape(-1),
                                          np.int32, dev)
            return flat_cache[fwd]

        def mask(x) -> torch.Tensor:
            return _tensor(x, np.uint32, dev)

        out: list[dict[str, torch.Tensor]] = []
        for s in plan.steps:
            d: dict[str, torch.Tensor] = {
                "bound_id": _scalar(s.bound_id, dev)}
            if s.restart_candidates is not None:
                cands = np.sort(cm.candidates(plan.query, s.u)) \
                    .astype(np.int32)
                if use_prune and s.sig_mask is not None and cands.size:
                    # re-apply the plan's baked candidate prune to the
                    # freshly resolved set (conservative snapshot rows)
                    from repro_torch.index import signature_rows

                    rows = signature_rows(snap)
                    keep = np.all((rows[cands] & s.sig_mask) == s.sig_mask,
                                  axis=-1)
                    cands = cands[keep]
                n_real = cands.size
                # pow2 padding keeps the shapes stable across snapshots
                target = _next_pow2(max(1, n_real))
                if n_real < target:
                    cands = np.concatenate(
                        [cands, np.full(target - n_real, -1, np.int32)])
                d["restart"] = _tensor(cands, np.int32, dev)
                d["restart_n"] = _scalar(int(n_real), dev)
            elif s.elabel >= 0:
                d["iptr"] = snap.base_el_row_padded(s.elabel, s.forward,
                                                    n_pad, dev)
                d.update(snap.dev_el_step(s.elabel, s.forward, n_pad, dev))
            else:
                d["all_iptr"] = snap.base_plain_padded(s.forward, n_pad, dev)
                d.update(snap.dev_plain(s.forward, n_pad, dev))
            if s.labels:
                d["label_mask"] = mask(_label_mask(self.graph, s.labels))
            if s.labels or _fused_eligible(s, self.opts):
                d["bitmap"] = snap.dev_bitmap(n_pad, dev)
            if use_prune and s.sig_mask is not None \
                    and s.restart_candidates is None:
                d["sig_mask"] = mask(s.sig_mask)
                d["sig"] = snap.dev_sig(n_pad, dev)
                if _fused_eligible(s, self.opts):
                    lm = _label_mask(self.graph, s.labels) if s.labels else \
                        np.zeros(self.graph.label_bitmap.shape[1], np.uint32)
                    d["fmask"] = mask(np.concatenate([lm, s.sig_mask]))
                    d["filter_bitmap"] = snap.dev_filter_bitmap(n_pad, dev)
            if s.num_filters:
                nv = snap.dev_numeric(n_pad, dev)
                if nv is not None:
                    d["numeric"] = nv
            for ci, c in enumerate(s.nontree):
                use_out = c.forward or c.self_loop
                if c.pvar_idx >= 0:
                    d[f"nt{ci}_flat"] = base_flat(use_out)
                    for k, v in snap.dev_flat(use_out, n_pad, dev).items():
                        d[f"nt{ci}_{k}"] = v
                else:
                    d[f"nt{ci}_iptr"] = snap.base_el_row_padded(
                        c.elabel, use_out, n_pad, dev)
                    for k, v in snap.dev_el_step(c.elabel, use_out, n_pad,
                                                 dev).items():
                        d[f"nt{ci}_{k}"] = v
            out.append(d)
        plan._dev_arrays_snap_torch = (token, out)  # type: ignore[attr-defined]
        return out

    def _start_candidates(self, plan: ExecPlan, view) -> np.ndarray:
        """The plan's start-candidate set, re-resolved against ``view`` when
        executing a live store (plans are cached across versions; their
        baked candidate arrays go stale, the spec — labels / bound id /
        cheap numeric filters / start signature — does not)."""
        if view is None:
            return plan.start_candidates
        from repro_torch.core.planner.cost import CostModel
        from repro_torch.core.planner.ir import np_cmp

        token = (view.token(), self.opts.use_prune)
        cached = getattr(plan, "_snap_start", None)
        if cached is not None and cached[0] == token:
            return cached[1]
        cands = CostModel(view).candidates(plan.query, plan.start_vertex)
        nf = getattr(plan, "start_num_filters", ())
        if nf and view.numeric_value is not None:
            vals = view.numeric_value[cands]
            keep = np.ones(cands.shape[0], bool)
            for op, c in nf:
                keep &= np_cmp(vals, op, c)
            cands = cands[keep]
        sig = getattr(plan, "start_sig", None)
        if self.opts.use_prune and sig is not None and cands.size:
            from repro_torch.index import signature_rows

            rows = signature_rows(view)
            cands = cands[np.all((rows[cands] & sig) == sig, axis=-1)]
        cands = np.sort(cands).astype(np.int32)
        plan._snap_start = (token, cands)  # type: ignore[attr-defined]
        return cands

    def _param_start_candidates(self, plan: ExecPlan, params: np.ndarray,
                                view=None) -> np.ndarray:
        """Start candidates of a parameterized start vertex: exactly the
        parameter's vertex id, subject to the label-containment check the
        cost model applies to a baked bound vertex.  The signature prune is
        skipped (a pure optimization on a one-element set).  Never cached on
        the plan, since it varies with ``params``; valid on the base graph
        and on snapshots (ids are stable across versions)."""
        g = view if view is not None else self.graph
        cid = int(params[plan.start_param_slot])
        if cid < 0 or cid >= int(g.n_vertices):
            return np.zeros(0, np.int32)
        qv = plan.query.vertices[plan.start_vertex]
        if qv.labels:
            bm = np.asarray(g.label_bitmap[cid])
            for lbl in qv.labels:
                if not (int(bm[lbl >> 5]) >> (lbl & 31)) & 1:
                    return np.zeros(0, np.int32)
        return np.array([cid], np.int32)

    def _schedule(self, plan: ExecPlan, chunk_size: int,
                  opts: ExecOpts | None = None) -> tuple[tuple, list[int]]:
        """The (learned) per-step capacity schedule for this plan+chunk: a
        copy, which the run grows and merges back (:meth:`_learn_caps`)."""
        opts = self.opts if opts is None else opts
        key = (plan.signature(), chunk_size, bool(opts.cap_schedule),
               opts.cap_slack, opts.init_cap)
        with self._caps_lock:
            caps = self._caps_cache.get(key)
            if caps is not None:
                return key, list(caps)
            if opts.cap_schedule:
                caps = list(plan.capacity_schedule(
                    chunk_size, opts.init_cap, opts.max_cap, opts.cap_slack))
            else:
                # legacy presizing: one global capacity from the whole-plan
                # fanout product, identical for every step
                est = 1.0
                for f in plan.est_fanout:
                    est *= max(1.0, min(f, 64.0))
                cap0 = int(min(opts.max_cap,
                               max(opts.init_cap,
                                   _next_pow2(int(chunk_size * min(est, 512.0))))))
                cap0 = max(cap0, _next_pow2(chunk_size))
                caps = [cap0] * len(plan.steps)
            self._caps_cache[key] = caps
            return key, list(caps)

    def _learn_caps(self, key: tuple, used) -> list[int]:
        """Merge a run's grown capacities into the shared schedule (each
        step keeps the larger one) and return a copy of it."""
        with self._caps_lock:
            shared = self._caps_cache[key]
            for si, c in enumerate(used):
                shared[si] = max(shared[si], c)
            return list(shared)

    def run(
        self,
        plan: ExecPlan,
        collect: str = "bindings",
        initial: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
        profile: bool | None = None,
        state: tuple | None = None,
        trace=None,
        params: np.ndarray | None = None,
        cancel: CancelToken | None = None,
        _opts_override: ExecOpts | None = None,
    ) -> Result:
        """Execute a plan.  ``initial=(B0, P0, origins)`` runs the plan's
        steps as an *extension* of existing rows (OPTIONAL left joins).
        ``profile=True`` (or ``ExecOpts.profile``) executes step by step
        with device syncs to fill per-step wall times in ``Result.stats``.
        ``state`` pins a ``pin()``-captured (view, device graph) pair so a
        multi-run query stays on one snapshot under concurrent updates.
        ``trace`` (a :class:`repro_torch.obs.Trace`) records compile (a
        chunk program's build) / dispatch / device-wait / per-step spans
        under the caller's current span; a trace with
        ``profile_steps=True`` forces profiled execution, so the step spans
        carry measured times.  ``params`` is a parameterized plan's
        constant vector (int32
        ``[plan.n_params]``); a negative entry is a constant missing from
        the dictionary and gives an empty result without touching the
        device.  ``cancel`` is polled between chunk dispatches and
        suffix-resume re-entries.

        Transient faults (out-of-memory shaped, CUDA's included) are
        absorbed by a retry/degradation ladder: bounded backoff retries at
        the current config, then progressively degraded configs down to
        the legacy executor, remembered per plan signature."""
        if cancel is None and self.opts.deadline is not None:
            cancel = CancelToken(self.opts.deadline)
        if _opts_override is not None:
            # explicit config (small-plan probes, degraded re-runs)
            return self._run_impl(plan, collect, initial, profile, state,
                                  trace, params, cancel, _opts_override)
        sig = plan.signature()
        policy = self._policy
        level = self._breaker.level(sig)
        attempt = 0
        while True:
            try:
                res = self._run_impl(
                    plan, collect, initial, profile, state, trace, params,
                    cancel, degrade_opts(self.opts, level) if level else None)
            except QueryCancelled:
                raise
            except Exception as e:  # noqa: BLE001 - filtered just below
                if not is_transient_fault(e):
                    raise
                self._res_counters["fault_retries"] += 1
                if attempt < policy.max_retries:
                    delay = policy.backoff(attempt)
                    attempt += 1
                    if cancel is not None:
                        if cancel.expired:
                            raise QueryCancelled(
                                f"query cancelled: "
                                f"{cancel.reason or 'cancelled'}") from e
                        rem = cancel.remaining()
                        if rem is not None:
                            delay = min(delay, max(0.0, rem))
                    time.sleep(delay)
                    continue
                if level >= MAX_LEVEL:
                    raise
                prev = level
                level = self._breaker.record_failure(sig, level)
                self._res_counters["escalations"] += 1
                attempt = 0
                log.warning(
                    "transient fault at degradation level %d; "
                    "escalating to level %d: %s", prev, level, e)
                continue
            self._breaker.record_success(sig, level)
            if level:
                self._res_counters["degraded_runs"] += 1
                res.stats["degraded_level"] = level
            return res

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host -> device copy kept off the critical path: pinned staging
        and a non-blocking copy on the current stream."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _run_impl(
        self,
        plan: ExecPlan,
        collect: str = "bindings",
        initial: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
        profile: bool | None = None,
        state: tuple | None = None,
        trace=None,
        params: np.ndarray | None = None,
        cancel: CancelToken | None = None,
        _opts_override: ExecOpts | None = None,
    ) -> Result:
        state = self.pin() if state is None else state
        view, dg = state
        if plan.unsat:
            return Result(0, _empty(plan), _empty_p(plan), np.zeros(0, np.int32))
        if plan.n_params:
            if params is None:
                raise ValueError(
                    f"plan expects {plan.n_params} parameters; none given")
            params = np.asarray(params, np.int32).reshape(-1)
            if params.shape[0] != plan.n_params:
                raise ValueError(f"expected {plan.n_params} parameters, "
                                 f"got {params.shape[0]}")
            if (params < 0).any():
                # a hoisted constant missing from the dictionary: provably
                # zero solutions (the contract of an unsat baked plan)
                return Result(0,
                              _empty(plan) if collect == "bindings" else None,
                              _empty_p(plan), np.zeros(0, np.int32))
        dev = self.device
        opts = self.opts if _opts_override is None else _opts_override
        small_legacy = False  # remembered small-probe verdict applied?
        if (_opts_override is None and initial is None and trace is None
                and not profile and _small_plan(plan, opts)):
            # B1-class small queries: probe once per plan signature (each
            # configuration twice — first warm, second timed) and remember
            # the winner.  Both return identical results.
            sig = plan.signature()
            mode = self._small_mode.get(sig)
            if mode is None:
                legacy = replace(opts, cap_schedule=False,
                                 suffix_resume=False, async_chunks=1,
                                 use_fused=False)
                kw = dict(collect=collect, state=state, params=params,
                          cancel=cancel)
                res = self.run(plan, _opts_override=opts, **kw)
                t0 = time.perf_counter()
                res = self.run(plan, _opts_override=opts, **kw)
                t_pipe = time.perf_counter() - t0
                self.run(plan, _opts_override=legacy, **kw)
                t0 = time.perf_counter()
                res_l = self.run(plan, _opts_override=legacy, **kw)
                t_leg = time.perf_counter() - t0
                # require a clear win before abandoning the pipeline
                mode = t_leg < 0.9 * t_pipe
                self._small_mode[sig] = mode
                win = res_l if mode else res
                win.stats["small_probe"] = {
                    "t_pipelined_ms": round(t_pipe * 1e3, 3),
                    "t_legacy_ms": round(t_leg * 1e3, 3),
                    "legacy_wins": bool(mode)}
                return win
            if mode:
                opts = replace(opts, cap_schedule=False, suffix_resume=False,
                               async_chunks=1, use_fused=False)
                small_legacy = True
        profile = opts.profile if profile is None else profile
        if trace is not None and trace.profile_steps:
            profile = True
        nq = plan.query.n_vertices
        param_start = plan.start_param_slot >= 0 and params is not None

        if initial is None and not plan.steps:
            # point-shaped query (paper Algorithm 1 lines 2–4)
            cands = (self._param_start_candidates(plan, params, view)
                     if param_start else self._start_candidates(plan, view))
            b = np.full((cands.shape[0], nq), -1, dtype=np.int32)
            b[:, plan.start_vertex] = cands
            return Result(
                int(cands.shape[0]),
                b if collect == "bindings" else None,
                np.full((cands.shape[0], max(1, plan.n_pvars)), -1, np.int32),
                np.arange(cands.shape[0], dtype=np.int32),
            )

        sarrs = self._arrays(plan, state)
        extension = initial is not None
        if extension:
            b0, p0, org0 = initial
            n_src = b0.shape[0]
        else:
            start_cands = (self._param_start_candidates(plan, params, view)
                           if param_start
                           else self._start_candidates(plan, view))
            n_src = start_cands.shape[0]
        if n_src == 0 or (not extension and not plan.steps):
            return Result(0, _empty(plan) if collect == "bindings" else None,
                          _empty_p(plan), np.zeros(0, np.int32))

        t_run0 = time.perf_counter()
        n_steps = len(plan.steps)
        npv = max(1, plan.n_pvars)
        stats = _empty_stats(n_steps)
        if small_legacy:
            stats["small_mode"] = True

        def check_cancel() -> None:
            if cancel is not None and cancel.expired:
                stats["wall_ms"] = (time.perf_counter() - t_run0) * 1e3
                raise QueryCancelled(
                    f"query cancelled: {cancel.reason or 'cancelled'}",
                    partial_stats=dict(stats))

        if profile:
            stats["step_wall_ms"] = [0.0] * n_steps
        total = 0
        out_b: list[np.ndarray] = []
        out_p: list[np.ndarray] = []
        out_o: list[np.ndarray] = []
        chunk_size = min(opts.chunk, max(1, n_src))
        # this run's copy of the learned schedule: a chunk starts from it,
        # and its growth is merged into the shared one and copied back here
        caps_key, caps = self._schedule(plan, chunk_size, opts)
        params_dev = self._upload(params) if plan.n_params else None

        def host_args(offset: int, hi: int):
            n_real = hi - offset
            if not extension:
                chunk = np.full(chunk_size, -1, dtype=np.int32)
                chunk[:n_real] = start_cands[offset:hi]
                return (self._upload(chunk), _scalar(n_real, dev),
                        torch.zeros((chunk_size, npv), dtype=I32, device=dev),
                        torch.zeros(chunk_size, dtype=I32, device=dev))
            bpad = np.full((chunk_size, nq), -1, dtype=np.int32)
            bpad[:n_real] = b0[offset:hi]
            ppad = np.full((chunk_size, npv), -1, np.int32)
            ppad[:n_real, : p0.shape[1]] = p0[offset:hi]
            opad = np.full(chunk_size, -1, dtype=np.int32)
            opad[:n_real] = org0[offset:hi]
            return (self._upload(bpad), _scalar(n_real, dev),
                    self._upload(ppad), self._upload(opad))

        def call_fn(fn, fresh, args, **meta):
            """One chunk-program invocation (enqueues its kernels); with
            tracing on, the span is named ``compile`` when this call built
            the program and ``dispatch`` when it only enqueues it."""
            poison = _faults.fire("dispatch")
            if fresh:
                stats["compiles"] += 1
            if trace is None:
                out = fn(*args)
            else:
                with trace.span("compile" if fresh else "dispatch", **meta):
                    out = fn(*args)
            if poison:
                stats["poisoned"] = stats.get("poisoned", 0) + 1
                out = _poisoned(out)
            return out

        def dispatch(offset: int, hi: int) -> dict:
            args = host_args(offset, hi)
            used = tuple(caps)
            fn, fresh = self._get_fn(plan, used, chunk_size, extension,
                                     collect, 0, n_steps, dg, opts)
            ci = stats["chunks"]
            stats["chunks"] += 1
            return {"out": call_fn(fn, fresh, (*args, params_dev, sarrs),
                                   chunk=ci),
                    "args": args, "caps": used, "offset": offset}

        def accumulate(start: int, upto: int, acc_from: int,
                       sc: np.ndarray) -> None:
            """Fold one window's step counters into the run stats."""
            if upto <= acc_from:
                return
            k = (sc.shape[0] - 2) // 4
            t_np, k_np = sc[2:2 + k], sc[2 + k:2 + 2 * k]
            pi_np, po_np = sc[2 + 2 * k:2 + 3 * k], sc[2 + 3 * k:]
            for si in range(max(start, acc_from), min(upto, n_steps)):
                ii = si - start
                if t_np[ii] >= 0:
                    stats["step_rows"][si] += int(t_np[ii])
                if k_np[ii] >= 0:
                    stats["step_kept"][si] += int(k_np[ii])
                if pi_np[ii] >= 0:
                    stats["step_prune_in"][si] += int(pi_np[ii])
                if po_np[ii] >= 0:
                    stats["step_prune_out"][si] += int(po_np[ii])

        def drain(rec: dict) -> None:
            nonlocal total
            b, p, org, count, scalars = rec["out"]
            used = list(rec["caps"])
            start = 0
            acc_from = 0
            while True:
                # the one device->host readback of this chunk program; with
                # tracing on, the host's wait for it is the device_wait span
                if trace is None:
                    sc = scalars.cpu().numpy()
                else:
                    with trace.span("device_wait"):
                        sc = scalars.cpu().numpy()
                ovf = int(sc[1])
                accumulate(start, ovf, acc_from, sc)
                acc_from = max(acc_from, min(ovf, n_steps))
                if ovf >= n_steps:
                    break
                # overflow retry is a fresh dispatch: honor an expired
                # deadline before re-entering the plan
                check_cancel()
                stats["step_retries"][ovf] += 1
                if opts.suffix_resume:
                    # re-enter from the overflowing step only: the frozen
                    # table is exactly that step's input
                    new_caps = _grow_caps(list(used), ovf, opts.max_cap)
                    n_in = used[ovf - 1] if ovf > 0 else chunk_size
                    fn, fresh = self._get_fn(plan, tuple(new_caps), n_in,
                                             True, collect, ovf, n_steps, dg,
                                             opts)
                    b, p, org, count, scalars = call_fn(
                        fn, fresh,
                        (b[:n_in], count, p[:n_in], org[:n_in], params_dev,
                         sarrs), resume_step=ovf)
                    start = ovf
                    acc_from = ovf
                    stats["resumes"] += 1
                else:
                    # legacy: double every capacity, redo the whole chunk
                    if used[ovf] >= opts.max_cap:
                        raise RuntimeError(
                            f"binding-table overflow at max capacity "
                            f"{opts.max_cap}; raise ExecOpts.max_cap")
                    new_caps = [min(opts.max_cap, c * 2) for c in used]
                    fn, fresh = self._get_fn(plan, tuple(new_caps),
                                             chunk_size, extension, collect,
                                             0, n_steps, dg, opts)
                    b, p, org, count, scalars = call_fn(
                        fn, fresh, (*rec["args"], params_dev, sarrs),
                        retry=True)
                    start = 0
                used = new_caps
                # persist the learned schedule for subsequent chunks
                caps[:] = self._learn_caps(caps_key, used)
            c = int(sc[0])
            total += c
            if collect == "bindings" and c:
                out_b.append(b[:c].cpu().numpy())
                out_p.append(p[:c].cpu().numpy())
                o = org[:c].cpu().numpy()
                if not extension:
                    o = o + rec["offset"]  # chunk-local start index -> global
                out_o.append(o)

        pending: deque[dict] = deque()
        max_inflight = max(1, int(opts.async_chunks))
        offset = 0
        while offset < n_src:
            check_cancel()
            hi = min(offset + chunk_size, n_src)
            if profile and n_steps:
                caps[:] = self._run_profiled_chunk(
                    plan, sarrs, offset, hi, chunk_size, extension, collect,
                    caps_key, caps, stats, host_args, drain, dg, trace,
                    params_dev, opts, check_cancel)
            else:
                pending.append(dispatch(offset, hi))
                if len(pending) >= max_inflight:
                    drain(pending.popleft())
            offset = hi
        while pending:
            drain(pending.popleft())

        with self._caps_lock:
            stats["caps"] = list(self._caps_cache[caps_key])
        stats["wall_ms"] = (time.perf_counter() - t_run0) * 1e3
        # which kernel each step ran through (read by the workload
        # profiler's kernel-mix accounting)
        stats["step_kernels"] = [
            _step_kernel_name(dg, st, sarrs[si], opts,
                              collect == "count" and si == n_steps - 1)
            for si, st in enumerate(plan.steps)]
        if trace is not None and n_steps:
            _annotate_step_spans(trace, plan, dg, sarrs, opts, stats,
                                 collect, n_src)
        bindings = (np.concatenate(out_b) if out_b else _empty(plan)) \
            if collect == "bindings" else None
        pb = (np.concatenate(out_p) if out_p else _empty_p(plan)) \
            if collect == "bindings" else None
        origins = np.concatenate(out_o) if out_o else np.zeros(0, np.int32)
        # one overflow event == one step retry, in every execution mode
        return Result(total, bindings, pb, origins,
                      chunks_retried=sum(stats["step_retries"]), stats=stats)

    def run_batch(self, plan: ExecPlan, params_mat: np.ndarray,
                  collect: str = "bindings",
                  state: tuple | None = None,
                  cancel: CancelToken | None = None,
                  trace=None) -> list[Result]:
        """Answer ``B`` same-shape queries in one batch program.

        ``params_mat`` (int32 ``[B, plan.n_params]``) stacks one constant
        vector per query.  The lanes run as one row set (``build_batch_fn``),
        so each step is one set of kernel launches for the whole batch.  The
        lane count is padded to a power of two (pad lanes repeat the first
        live lane and are discarded).  A parameterized start gives each lane
        its own start row; otherwise the lanes share the plan's start set,
        and a start set wider than one chunk runs the queries one by one.
        Each lane has its own capacities and freezes on its own; a lane that
        overflows is rerun alone through :meth:`run` (suffix-resume), so
        every result equals the query's own run.

        Lanes whose constants are missing from the dictionary (negative
        ids) or whose parameterized start fails its label check return
        empty results without touching the device.  A transient fault in
        the batch program falls back to :meth:`run` per query.  Every step
        runs unfused, as in the reference's vmapped program.

        ``trace`` records the batch program's ``compile`` (a build) or
        ``dispatch`` span (``lanes`` meta), the ``device_wait`` for its one
        readback, and a ``lane`` span per query (``index``) holding that
        lane's ``step`` spans, or the spans of its own :meth:`run` when it
        ran alone.  A batch program is one set of launches for every step,
        so its step spans carry no time."""
        state = self.pin() if state is None else state
        view, dg = state
        params_mat = np.asarray(params_mat, np.int32)
        if params_mat.ndim != 2 or params_mat.shape[1] != plan.n_params:
            raise ValueError(
                f"expected params [B, {plan.n_params}], got "
                f"{params_mat.shape}")
        n_q = params_mat.shape[0]
        n_steps = len(plan.steps)

        def empty() -> Result:
            return Result(0,
                          _empty(plan) if collect == "bindings" else None,
                          _empty_p(plan), np.zeros(0, np.int32))

        def solo(i: int) -> Result:
            if trace is None:
                return self.run(plan, collect=collect, state=state,
                                params=params_mat[i], cancel=cancel)
            with trace.span("lane", index=i):
                return self.run(plan, collect=collect, state=state,
                                trace=trace, params=params_mat[i],
                                cancel=cancel)

        results: list[Result | None] = [None] * n_q
        if plan.unsat:
            return [empty() for _ in range(n_q)]
        if not plan.steps or plan.n_params == 0 or n_q == 1:
            # degenerate shapes: nothing to amortize
            return [solo(i) for i in range(n_q)]

        opts = replace(self.opts, use_fused=False, async_chunks=1)
        per_lane_start = plan.start_param_slot >= 0
        if per_lane_start:
            chunk_size = 1
            lane_start = np.full(n_q, -1, np.int32)
            for i in range(n_q):
                if (params_mat[i] < 0).any():
                    results[i] = empty()
                    continue
                cands = self._param_start_candidates(plan, params_mat[i],
                                                     view)
                if cands.size == 0:
                    results[i] = empty()
                else:
                    lane_start[i] = cands[0]
        else:
            start_cands = self._start_candidates(plan, view)
            n_src = start_cands.shape[0]
            if n_src == 0:
                return [empty() for _ in range(n_q)]
            if n_src > opts.chunk:
                # per-lane accumulation across chunks would lose the
                # one-program win anyway
                return [solo(i) for i in range(n_q)]
            chunk_size = n_src
            for i in range(n_q):
                if (params_mat[i] < 0).any():
                    results[i] = empty()

        live = [i for i in range(n_q) if results[i] is None]
        if not live:
            return results  # type: ignore[return-value]
        n_live = len(live)
        lanes = 1 << max(0, (n_live - 1).bit_length())
        rows = live + [live[0]] * (lanes - n_live)
        sarrs = self._arrays(plan, state)
        if per_lane_start:
            # one start row per lane: the single-query floor (init_cap)
            # would size every lane for a whole chunk, so caps follow the
            # estimate with a small floor; an undersized lane freezes and
            # reruns alone, which keeps every result exact
            caps = list(plan.capacity_schedule(
                chunk_size, min(opts.init_cap, 64), opts.max_cap,
                opts.cap_slack))
            chunk = lane_start[rows][:, None]
        else:
            _, caps = self._schedule(plan, chunk_size, opts)
            chunk = np.broadcast_to(start_cands, (lanes, n_src))
        used = tuple(caps)
        key = ProgramKey(plan.signature(), used, chunk_size, False, collect,
                         0, n_steps, opts.key(), dg.key(), lanes=lanes,
                         per_lane_start=per_lane_start)
        fn = self._compiled.get(key)
        fresh = fn is None
        if fresh:
            built = build_batch_fn(dg, plan, used, chunk_size, lanes, opts,
                                   collect)
            fn = self._compiled.setdefault(key, built)
            fresh = fn is built
        if cancel is not None and cancel.expired:
            raise QueryCancelled(
                f"query cancelled: {cancel.reason or 'cancelled'}")
        try:
            poison = _faults.fire("dispatch")
            with (trace.span("compile" if fresh else "dispatch", lanes=lanes)
                  if trace is not None else contextlib.nullcontext()):
                b, p, org, scalars = fn(
                    self._upload(np.ascontiguousarray(chunk, np.int32)),
                    self._upload(np.ascontiguousarray(params_mat[rows])),
                    sarrs)
        except Exception as e:  # noqa: BLE001 - filtered just below
            if not is_transient_fault(e):
                raise
            # the batch program hit memory pressure: run the queries one by
            # one, whose per-run ladder absorbs the fault
            return [results[i] if results[i] is not None else solo(i)
                    for i in range(n_q)]
        with (trace.span("device_wait") if trace is not None
              else contextlib.nullcontext()):
            sc = scalars.cpu().numpy()  # the one readback of the batch
        count_h = sc[:, 0]
        offs_h = np.concatenate([[0], np.cumsum(count_h)])
        if poison:
            count_h = np.zeros_like(count_h)
        k = n_steps
        tot_h, kep_h = sc[:, 2:2 + k], sc[:, 2 + k:2 + 2 * k]
        pin_h, pout_h = sc[:, 2 + 2 * k:2 + 3 * k], sc[:, 2 + 3 * k:]
        if collect == "bindings":
            n_rows = int(offs_h[-1])
            b_h = b[:n_rows].cpu().numpy()
            p_h = p[:n_rows].cpu().numpy()
            org_h = org[:n_rows].cpu().numpy()
        kernels = [_step_kernel_name(dg, st, sarrs[si], opts,
                                     collect == "count" and si == n_steps - 1)
                   for si, st in enumerate(plan.steps)]
        for li, qi in enumerate(live):
            if int(sc[li, 1]) < n_steps:
                # an overflowing lane: rerun alone (suffix-resume doubling
                # is deterministic, so its answer equals a lane that fit)
                results[qi] = solo(qi)
                continue
            c = int(count_h[li])
            stats = _empty_stats(n_steps)
            stats["chunks"] = 1
            stats["batched"] = True
            stats["batch_lanes"] = lanes
            stats["batch_fill"] = n_live / lanes
            stats["step_kernels"] = kernels
            for si in range(n_steps):
                for key_, vals in (("step_rows", tot_h),
                                   ("step_kept", kep_h),
                                   ("step_prune_in", pin_h),
                                   ("step_prune_out", pout_h)):
                    if vals[li, si] >= 0:
                        stats[key_][si] = int(vals[li, si])
            if trace is not None:
                with trace.span("lane", index=qi):
                    _annotate_step_spans(trace, plan, dg, sarrs, opts,
                                         {**stats, "caps": list(used)},
                                         collect, chunk_size)
            if collect == "bindings":
                lo = int(offs_h[li])
                results[qi] = Result(c, b_h[lo:lo + c].copy(),
                                     p_h[lo:lo + c].copy(),
                                     org_h[lo:lo + c].copy(), stats=stats)
            else:
                results[qi] = Result(c, None, _empty_p(plan),
                                     np.zeros(0, np.int32), stats=stats)
        return results  # type: ignore[return-value]

    def _run_profiled_chunk(self, plan, sarrs, offset, hi, chunk_size,
                            extension, collect, caps_key, caps, stats,
                            host_args, drain, dg: DeviceGraph, trace,
                            params_dev, opts: ExecOpts,
                            check_cancel) -> list[int]:
        """Step-at-a-time execution of one chunk, each step timed on its
        own (:class:`_StepTimer`), filling per-step wall times; overflow
        handling is inherently suffix-resume (each window re-runs alone
        with a doubled capacity).  ``caps`` is the run's schedule; returns
        it with this chunk's growth merged into the shared one."""
        n_steps = len(plan.steps)
        caps = list(caps)
        stream = None
        if self.device.type == "cuda":
            stream = getattr(self._timing, "stream", None)
            if stream is None:
                stream = self._timing.stream = torch.cuda.Stream(
                    self.device, priority=-1)
        timer = _StepTimer(self.device, stream)
        with timer.stream():
            args = host_args(offset, hi)
            state = None
            ci = stats["chunks"]
            stats["chunks"] += 1
            for si in range(n_steps):
                while True:
                    check_cancel()
                    used = tuple(caps)
                    n_in = chunk_size if si == 0 else used[si - 1]
                    fn, fresh = self._get_fn(plan, used, n_in,
                                             extension or si > 0,
                                             collect, si, si + 1, dg, opts)
                    if fresh:
                        stats["compiles"] += 1
                    span = (trace.span("compile" if fresh else "dispatch",
                                       chunk=ci, step=si)
                            if trace is not None else contextlib.nullcontext())
                    with span:
                        poison = _faults.fire("dispatch")
                        t0 = timer.start()
                        if si == 0:
                            out = fn(*args, params_dev, sarrs)
                        else:
                            b, p, org, count = state
                            out = fn(b[:n_in], count, p[:n_in], org[:n_in],
                                     params_dev, sarrs)
                        if poison:
                            stats["poisoned"] = stats.get("poisoned", 0) + 1
                            out = _poisoned(out)
                        stats["step_wall_ms"][si] += timer.stop_ms(t0)
                    b, p, org, count, scalars = out
                    sc = scalars.cpu().numpy()
                    if int(sc[1]) >= n_steps:
                        for key, v in zip(("step_rows", "step_kept",
                                           "step_prune_in",
                                           "step_prune_out"), sc[2:6]):
                            if v >= 0:
                                stats[key][si] += int(v)
                        state = (b, p, org, count)
                        break
                    stats["step_retries"][si] += 1
                    stats["resumes"] += 1
                    _grow_caps(caps, si, opts.max_cap)
            caps = self._learn_caps(caps_key, caps)
            # hand the finished table to the shared collection path (the -1
            # counters mean "already accumulated above")
            b, p, org, count = state
            scalars = torch.full((2 + 4 * n_steps,), -1, dtype=I64,
                                 device=count.device)
            scalars[0] = count.to(I64)
            scalars[1] = n_steps
            drain({"out": (b, p, org, count, scalars), "args": args,
                   "caps": tuple(caps), "offset": offset})
        return caps


def _empty(plan: ExecPlan) -> np.ndarray:
    return np.zeros((0, plan.query.n_vertices), dtype=np.int32)


def _empty_p(plan: ExecPlan) -> np.ndarray:
    return np.zeros((0, max(1, plan.n_pvars)), dtype=np.int32)
