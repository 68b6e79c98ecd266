"""Vectorized e-graph-homomorphism executor on PyTorch (static graphs).

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
expand/filter/compact kernel.  Kernels dispatch by the tensors' device
(:mod:`repro_torch.kernels.ops`): on CUDA the hand-written Hopper kernels,
on the CPU their plain versions.

Nothing inside a chunk program reads a device value back to the host:
compaction is a cumsum-position scatter, and every per-step counter goes
into one packed int64 vector that the host reads once per chunk program,
after the next chunk has been enqueued (``ExecOpts.async_chunks``).

Bitmaps, masks and signatures live on the device as int32 bit patterns of
the reference's uint32 words (converted in :meth:`DeviceGraph.from_graph`
and :func:`_plan_arrays` only).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch

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

    def key(self) -> tuple:
        """Identity for the chunk-program cache, as in the reference
        (``(delta_mode, pad_vertices, base_vertices, n_elabels,
        max_log_deg)``; a static graph pads nothing)."""
        return (False, self.n_vertices, self.n_vertices, self.n_elabels,
                self.max_log_deg)

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
        d: dict[str, torch.Tensor] = {}
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
    n = dg.n_vertices
    ok = torch.ones(v_new.shape[0], dtype=torch.bool, device=v_new.device)
    for ci, c in enumerate(step.nontree):
        use_out = c.forward or c.self_loop
        nbr = dg.arrays["out_nbr_el" if use_out else "in_nbr_el"]
        probe = v_new if c.self_loop else b_rows[:, c.other]
        psafe = probe.clamp(0, n - 1)
        if c.pvar_idx >= 0:
            el_raw = p_rows[:, c.pvar_idx]
            bound_ok = el_raw >= 0
            flat = sarr[f"nt{ci}_flat"]
            base = el_raw.clamp(0, dg.n_elabels - 1) * (n + 1)
            lo = flat[base + psafe]
            hi = flat[base + psafe + 1]
            found = kops.edge_exists(nbr, lo, hi, v_new,
                                     n_iters=dg.max_log_deg)
            ok = ok & found & bound_ok
            continue
        iptr = sarr[f"nt{ci}_iptr"]
        lo = iptr[psafe]
        hi = iptr[psafe + 1]
        max_deg = int(
            (dg.max_deg_out_el if use_out else dg.max_deg_in_el)[c.elabel]
        )
        if opts.use_int and 0 < max_deg <= opts.int_tile:
            # +INT: gather the probe side's whole adjacency tile (bounded by
            # int_tile) and test every candidate of this step against it
            tb = _next_pow2(max(8, max_deg))
            pos = lo[:, None] + torch.arange(tb, dtype=I32,
                                             device=lo.device)[None, :]
            in_range = pos < hi[:, None]
            adj_tile = torch.where(
                in_range, nbr[pos.clamp(0, nbr.shape[0] - 1)], -2)
            found = kops.tile_membership(v_new[:, None], adj_tile)[:, 0]
        else:
            found = kops.edge_exists(nbr, lo, hi, v_new,
                                     n_iters=dg.max_log_deg)
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
    has_numeric = "numeric_value" in dg.arrays
    n = dg.n_vertices
    arrays = dg.arrays
    for si in range(start_step, stop):
        prev = n_in if si == start_step else caps[si - 1]
        if caps[si] < prev:
            raise ValueError("capacity schedule must be monotone "
                             f"non-decreasing (step {si}: {caps[si]} < {prev})")

    def fn(chunk, chunk_count, p_init, org_init, sarrs):
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

            if step.restart_candidates is not None:
                deg = torch.where(alive, sarr["restart_n"], 0)
                nbr_src = sarr["restart"]
                start = torch.zeros(cap_prev, dtype=I32, device=dev)
            else:
                if step.elabel >= 0:
                    iptr = sarr["iptr"]
                    nbr_src = arrays["out_nbr_el" if step.forward
                                     else "in_nbr_el"]
                else:  # predicate variable: plain CSR
                    iptr = arrays["out_indptr_all" if step.forward
                                  else "in_indptr_all"]
                    nbr_src = arrays["out_nbr_all" if step.forward
                                     else "in_nbr_all"]
                vp = b[:, step.parent].clamp(0, n - 1)
                start = iptr[vp]
                deg = torch.where(alive, iptr[vp + 1] - start, 0)

            # int64 prefix sums: the total cannot wrap, so an oversized
            # expansion is always reported as overflow
            coffs = torch.cumsum(deg, 0, dtype=I64)
            total = coffs[-1]
            offs = (coffs - deg).to(I32)
            ovf_here = active & (total > cap)
            keep_new = active & ~ovf_here
            ovf_step = torch.where(ovf_here, si, ovf_step)
            count_only = collect == "count" and si == n_steps - 1

            bitmap_src = arrays["label_bitmap"]
            p_in = p_out = None
            if _fused_eligible(step, opts) and not count_only:
                fmask = sarr.get("fmask")
                fb_src = arrays.get("filter_bitmap") \
                    if fmask is not None else None
                if fmask is not None and fb_src is not None:
                    # composed label + signature probe: one superset test
                    # over the widened (labels ++ signature) bitmap
                    filt_bitmap, filt_mask = fb_src, fmask
                    p_in = total
                else:
                    filt_bitmap = bitmap_src
                    filt_mask = sarr.get("label_mask")
                    if filt_mask is None:
                        filt_mask = torch.zeros(bitmap_src.shape[1],
                                                dtype=I32, device=dev)
                v_out, row_sel, kept = kops.expand_filter_compact(
                    nbr_src, filt_bitmap, start, deg, offs, filt_mask,
                    step.bound_id, cap)
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
                idx = (start[row] + j).clamp(0, nbr_src.shape[0] - 1)
                v_new = torch.where(valid, nbr_src[idx], -1)
                ok = valid

                b_rows = b[row]
                p_rows = p[row]
                org_rows = org[row]
                b_rows[:, step.u] = v_new

                if step.pvar_idx >= 0:  # tree-edge M_e binding
                    lab_src = arrays["out_lab_all" if step.forward
                                     else "in_lab_all"]
                    el_new = torch.where(valid, lab_src[idx], -1)
                    prev = p_rows[:, step.pvar_idx].clone()
                    ok = ok & ((prev < 0) | (prev == el_new))
                    p_rows[:, step.pvar_idx] = torch.where(prev < 0, el_new,
                                                           prev)
                if step.bound_id >= 0:
                    ok = ok & (v_new == step.bound_id)
                vsafe = v_new.clamp(0, n - 1)
                if "label_mask" in sarr:
                    ok = ok & kops.bitmap_superset(bitmap_src[vsafe],
                                                   sarr["label_mask"])
                sig_mask = sarr.get("sig_mask")
                sig_src = arrays.get("sig") if sig_mask is not None else None
                if sig_src is not None:
                    p_in = ok.sum(dtype=I32)
                    ok = ok & kops.signature_filter(sig_src, vsafe, sig_mask)
                    p_out = ok.sum(dtype=I32)
                if step.min_out_ntypes or step.min_in_ntypes:
                    ok = ok & (arrays["out_degree"][vsafe]
                               >= step.min_out_ntypes)
                    ok = ok & (arrays["in_degree"][vsafe]
                               >= step.min_in_ntypes)
                if "nlf_out_mask" in sarr and "nlf_out" in arrays:
                    ok = ok & kops.bitmap_superset(arrays["nlf_out"][vsafe],
                                                   sarr["nlf_out_mask"])
                    ok = ok & kops.bitmap_superset(arrays["nlf_in"][vsafe],
                                                   sarr["nlf_in_mask"])
                if step.num_filters and has_numeric:
                    vals = arrays["numeric_value"][vsafe]
                    for op, cval in step.num_filters:
                        ok = ok & _cmp(vals, op, cval)
                if opts.semantics == "iso":
                    for w in plan.order:
                        if w == step.u:
                            break
                        ok = ok & (b_rows[:, w] != v_new)
                if step.nontree:
                    ok = ok & _nontree_mask(dg, step, sarr, b_rows, p_rows,
                                            v_new, opts)

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


def _step_kernel_name(step: Step, opts: ExecOpts, count_only: bool) -> str:
    """Which kernel a step runs through — mirrors the dispatch in
    ``build_chunk_fn`` (fused fast path vs. ragged expand)."""
    if _fused_eligible(step, opts) and not count_only:
        return "expand_filter"
    return "ragged_expand"


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

    ``device`` defaults to ``"cuda"`` and raises without CUDA; pass
    ``"cpu"`` to run the kernels' plain versions."""

    def __init__(self, g, opts: ExecOpts | None = None, *, device="cuda"):
        if getattr(g, "is_snapshot", False):
            raise NotImplementedError(
                "live-store snapshots are not ported yet")
        self.opts = opts or ExecOpts()
        self.device = resolve_device(device)
        self._policy = RetryPolicy.from_env()
        self._breaker = DegradationBreaker(cooldown_s=self._policy.cooldown_s)
        self._res_counters = {"degraded_runs": 0, "fault_retries": 0,
                              "escalations": 0}
        self.graph = g
        self.dg = DeviceGraph.from_graph(g, with_nlf=self.opts.use_nlf,
                                         with_prune=self.opts.use_prune,
                                         device=self.device)
        self._compiled: dict[tuple, Any] = {}
        # learned per-plan capacity schedules (overflow doublings persist,
        # so later chunks / queries start right-sized)
        self._caps_cache: dict[tuple, list[int]] = {}
        # learned pipelined-vs-legacy choice for small plans (_small_plan)
        self._small_mode: dict[tuple, bool] = {}

    def resilience_snapshot(self) -> dict:
        """Breaker state + fault counters."""
        d = self._breaker.snapshot()
        d.update(self._res_counters)
        return d

    def _get_fn(self, plan: ExecPlan, caps: tuple[int, ...], n_in: int,
                table_input: bool, collect: str, start: int, stop: int,
                opts: ExecOpts | None = None):
        """The chunk program for this window, built once per key — the
        reference's compile-cache key, so ``stats["compiles"]`` counts the
        same events.  (There is no buffer donation: an eager torch program
        allocates its outputs, and the caching allocator reuses the freed
        inputs' memory.)"""
        opts = self.opts if opts is None else opts
        key = (plan.signature(), caps[start:stop], n_in, table_input,
               collect, start, stop, opts.key(), self.dg.key())
        fn = self._compiled.get(key)
        fresh = fn is None
        if fresh:
            _faults.fire("compile")
            fn = build_chunk_fn(self.dg, plan, caps, n_in, opts,
                                table_input, collect, start, stop)
            self._compiled[key] = fn
        return fn, fresh

    def _arrays(self, plan: ExecPlan) -> list[dict[str, torch.Tensor]]:
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

    def _schedule(self, plan: ExecPlan, chunk_size: int,
                  opts: ExecOpts | None = None) -> tuple[tuple, list[int]]:
        """The (learned) per-step capacity schedule for this plan+chunk."""
        opts = self.opts if opts is None else opts
        key = (plan.signature(), chunk_size, bool(opts.cap_schedule),
               opts.cap_slack, opts.init_cap)
        caps = self._caps_cache.get(key)
        if caps is None:
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
        return key, caps

    def run(
        self,
        plan: ExecPlan,
        collect: str = "bindings",
        initial: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
        profile: bool | None = None,
        cancel: CancelToken | None = None,
        _opts_override: ExecOpts | None = None,
    ) -> Result:
        """Execute a plan.  ``initial=(B0, P0, origins)`` runs the plan's
        steps as an *extension* of existing rows (OPTIONAL left joins).
        ``profile=True`` (or ``ExecOpts.profile``) executes step by step
        with device syncs to fill per-step wall times in ``Result.stats``.
        ``cancel`` is polled between chunk dispatches and suffix-resume
        re-entries.

        Transient faults (out-of-memory shaped, CUDA's included) are
        absorbed by a retry/degradation ladder: bounded backoff retries at
        the current config, then progressively degraded configs down to
        the legacy executor, remembered per plan signature."""
        if cancel is None and self.opts.deadline is not None:
            cancel = CancelToken(self.opts.deadline)
        if _opts_override is not None:
            # explicit config (small-plan probes, degraded re-runs)
            return self._run_impl(plan, collect, initial, profile, cancel,
                                  _opts_override)
        sig = plan.signature()
        policy = self._policy
        level = self._breaker.level(sig)
        attempt = 0
        while True:
            try:
                res = self._run_impl(
                    plan, collect, initial, profile, cancel,
                    degrade_opts(self.opts, level) if level else None)
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
        cancel: CancelToken | None = None,
        _opts_override: ExecOpts | None = None,
    ) -> Result:
        if plan.unsat:
            return Result(0, _empty(plan), _empty_p(plan), np.zeros(0, np.int32))
        if plan.n_params:
            raise NotImplementedError(
                "parameterized plans are not ported yet")
        dev = self.device
        opts = self.opts if _opts_override is None else _opts_override
        small_legacy = False  # remembered small-probe verdict applied?
        if (_opts_override is None and initial is None and not profile
                and _small_plan(plan, opts)):
            # B1-class small queries: probe once per plan signature (each
            # configuration twice — first warm, second timed) and remember
            # the winner.  Both return identical results.
            sig = plan.signature()
            mode = self._small_mode.get(sig)
            if mode is None:
                legacy = replace(opts, cap_schedule=False,
                                 suffix_resume=False, async_chunks=1,
                                 use_fused=False)
                kw = dict(collect=collect, cancel=cancel)
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
        nq = plan.query.n_vertices

        if initial is None and not plan.steps:
            # point-shaped query (paper Algorithm 1 lines 2–4)
            cands = plan.start_candidates
            b = np.full((cands.shape[0], nq), -1, dtype=np.int32)
            b[:, plan.start_vertex] = cands
            return Result(
                int(cands.shape[0]),
                b if collect == "bindings" else None,
                np.full((cands.shape[0], max(1, plan.n_pvars)), -1, np.int32),
                np.arange(cands.shape[0], dtype=np.int32),
            )

        sarrs = self._arrays(plan)
        extension = initial is not None
        if extension:
            b0, p0, org0 = initial
            n_src = b0.shape[0]
        else:
            start_cands = plan.start_candidates
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
        caps_key, caps = self._schedule(plan, chunk_size, opts)

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

        def call_fn(fn, fresh, args):
            """One chunk-program invocation (enqueues its kernels)."""
            poison = _faults.fire("dispatch")
            if fresh:
                stats["compiles"] += 1
            out = fn(*args)
            if poison:
                stats["poisoned"] = stats.get("poisoned", 0) + 1
                out = _poisoned(out)
            return out

        def dispatch(offset: int, hi: int) -> dict:
            args = host_args(offset, hi)
            used = tuple(caps)
            fn, fresh = self._get_fn(plan, used, chunk_size, extension,
                                     collect, 0, n_steps, opts)
            stats["chunks"] += 1
            return {"out": call_fn(fn, fresh, (*args, sarrs)),
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
                # the one device->host readback of this chunk program
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
                                             True, collect, ovf, n_steps,
                                             opts)
                    b, p, org, count, scalars = call_fn(
                        fn, fresh,
                        (b[:n_in], count, p[:n_in], org[:n_in], sarrs))
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
                                             0, n_steps, opts)
                    b, p, org, count, scalars = call_fn(
                        fn, fresh, (*rec["args"], sarrs))
                    start = 0
                used = new_caps
                # persist the learned schedule for subsequent chunks
                shared = self._caps_cache[caps_key]
                for si in range(n_steps):
                    shared[si] = max(shared[si], used[si])
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
                self._run_profiled_chunk(plan, sarrs, offset, hi, chunk_size,
                                         extension, collect, caps_key, stats,
                                         host_args, drain, opts, check_cancel)
            else:
                pending.append(dispatch(offset, hi))
                if len(pending) >= max_inflight:
                    drain(pending.popleft())
            offset = hi
        while pending:
            drain(pending.popleft())

        stats["caps"] = list(self._caps_cache[caps_key])
        stats["wall_ms"] = (time.perf_counter() - t_run0) * 1e3
        stats["step_kernels"] = [
            _step_kernel_name(st, opts, collect == "count" and si == n_steps - 1)
            for si, st in enumerate(plan.steps)]
        bindings = (np.concatenate(out_b) if out_b else _empty(plan)) \
            if collect == "bindings" else None
        pb = (np.concatenate(out_p) if out_p else _empty_p(plan)) \
            if collect == "bindings" else None
        origins = np.concatenate(out_o) if out_o else np.zeros(0, np.int32)
        # one overflow event == one step retry, in every execution mode
        return Result(total, bindings, pb, origins,
                      chunks_retried=sum(stats["step_retries"]), stats=stats)

    def _run_profiled_chunk(self, plan, sarrs, offset, hi, chunk_size,
                            extension, collect, caps_key, stats, host_args,
                            drain, opts: ExecOpts, check_cancel) -> None:
        """Step-at-a-time execution of one chunk with device syncs, filling
        per-step wall times; overflow handling is inherently suffix-resume
        (each window re-runs alone with a doubled capacity)."""
        n_steps = len(plan.steps)
        caps = self._caps_cache[caps_key]
        args = host_args(offset, hi)
        state = None
        stats["chunks"] += 1
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        for si in range(n_steps):
            while True:
                check_cancel()
                used = tuple(caps)
                n_in = chunk_size if si == 0 else used[si - 1]
                fn, fresh = self._get_fn(plan, used, n_in,
                                         extension or si > 0,
                                         collect, si, si + 1, opts)
                if fresh:
                    stats["compiles"] += 1
                poison = _faults.fire("dispatch")
                sync()
                t0 = time.perf_counter()
                if si == 0:
                    out = fn(*args, sarrs)
                else:
                    b, p, org, count = state
                    out = fn(b[:n_in], count, p[:n_in], org[:n_in], sarrs)
                if poison:
                    stats["poisoned"] = stats.get("poisoned", 0) + 1
                    out = _poisoned(out)
                sync()
                stats["step_wall_ms"][si] += (time.perf_counter() - t0) * 1e3
                b, p, org, count, scalars = out
                sc = scalars.cpu().numpy()
                if int(sc[1]) >= n_steps:
                    for key, v in zip(("step_rows", "step_kept",
                                       "step_prune_in", "step_prune_out"),
                                      sc[2:6]):
                        if v >= 0:
                            stats[key][si] += int(v)
                    state = (b, p, org, count)
                    break
                stats["step_retries"][si] += 1
                stats["resumes"] += 1
                _grow_caps(caps, si, opts.max_cap)
        # hand the finished table to the shared collection path (the -1
        # counters mean "already accumulated above")
        b, p, org, count = state
        scalars = torch.full((2 + 4 * n_steps,), -1, dtype=I64,
                             device=count.device)
        scalars[0] = count.to(I64)
        scalars[1] = n_steps
        rec = {"out": (b, p, org, count, scalars),
               "args": args, "caps": tuple(caps), "offset": offset}
        drain(rec)


def _empty(plan: ExecPlan) -> np.ndarray:
    return np.zeros((0, plan.query.n_vertices), dtype=np.int32)


def _empty_p(plan: ExecPlan) -> np.ndarray:
    return np.zeros((0, max(1, plan.n_pvars)), dtype=np.int32)
