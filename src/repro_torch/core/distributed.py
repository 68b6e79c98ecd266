"""Distributed engine execution (paper §5.2, NUMA → mesh).

The paper parallelizes over *starting data vertices* with dynamic chunking
across NUMA sockets.  Here the sockets become the shards of a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
with the reference's axis names ``("pod", "data", "model")``:

- ``run_sharded``: every rank holds its own replica of the graph (the
  analogue of the paper's per-socket round-robin page interleave),
  computes the same greedy partition of the starting vertices over the
  data-parallel axes ``pod`` and ``data``, runs the chunk program of its
  own row, and the count and the overflow flag are summed with one
  ``all_reduce`` over each group of those axes.  Ranks that differ only
  on ``model`` run the same row.
- ``engine_chunk_step``: the SPMD query step of the multi-pod dry run — the
  same expansion / filter / join pipeline as
  :func:`repro_torch.core.exec.build_chunk_fn`, but over explicit graph
  tensors, through ``ops.bitmap_superset`` and ``ops.edge_exists``.
- dynamic chunk scheduling: ``GreedyChunker`` orders candidates by
  estimated region size (degree) and deals each to the least-loaded shard
  so every rank gets a balanced workload — the paper's dynamic
  distribution, precomputed (an SPMD program cannot steal work at run
  time).

NCCL serves a mesh on CUDA and gloo a mesh on the CPU; a gloo mesh may also
drive CUDA executors (its ranks then share the card), and its reductions
go through host tensors.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.exec import I32, I64, Executor, build_chunk_fn
from repro_torch.core.planner import ExecPlan
from repro_torch.kernels import ops as kops
from repro_torch.utils import get_logger

log = get_logger("core.distributed")

# the data-parallel mesh axes, in the order their coordinates nest
DP_AXES = ("pod", "data")


# ---------------------------------------------------------------------------
# work partitioning (the paper's dynamic chunking, precomputed)
# ---------------------------------------------------------------------------


@dataclass
class GreedyChunker:
    """Deal starting vertices to D shards, balancing estimated region size."""

    n_shards: int

    def partition(self, candidates: np.ndarray, degree: np.ndarray):
        """``(chunks, counts, loads)``: int32 ``[D, width]`` rows of each
        shard's candidates in their input order (``-1`` padded), int32
        ``[D]`` real lengths, float64 ``[D]`` estimated loads.

        Heaviest first, each candidate goes to the least-loaded shard (the
        lowest index among equal loads, as ``np.argmin`` picks it); the
        loads are summed in that order, so every output is bit-identical
        to the plain per-candidate loop of the reference."""
        est = degree[candidates].astype(np.float64) + 1.0
        order = np.argsort(-est)  # heaviest first
        shard_of = np.zeros(candidates.shape[0], dtype=np.int32)
        if self.n_shards == 1:
            # one shard takes everything; cumsum adds in the loop's order
            loads = np.cumsum(est[order])[-1:] if est.size else np.zeros(1)
        else:
            heap = [(0.0, s) for s in range(self.n_shards)]
            for idx in order.tolist():
                load, s = heap[0]
                shard_of[idx] = s
                heapq.heapreplace(heap, (load + est[idx], s))
            loads = np.zeros(self.n_shards)
            for load, s in heap:
                loads[s] = load
        shards = [candidates[shard_of == s] for s in range(self.n_shards)]
        width = max(1, max(s.shape[0] for s in shards))
        out = np.full((self.n_shards, width), -1, dtype=np.int32)
        counts = np.zeros(self.n_shards, dtype=np.int32)
        for s, arr in enumerate(shards):
            out[s, : arr.shape[0]] = arr
            counts[s] = arr.shape[0]
        return out, counts, loads


# ---------------------------------------------------------------------------
# sharded execution over a device mesh
# ---------------------------------------------------------------------------


def _dp_layout(mesh) -> tuple[tuple[str, ...], int, int]:
    """The mesh's data-parallel axes, their shard count, and this rank's
    row: its coordinates over those axes taken row-major (``pod`` major),
    as ``P(("pod", "data"))`` lays the rows out."""
    names = tuple(mesh.mesh_dim_names or ())
    dp = tuple(a for a in DP_AXES if a in names)
    n_shards, row = 1, 0
    for a in dp:
        size = mesh.shape[names.index(a)]
        n_shards *= size
        row = row * size + mesh.get_local_rank(a)
    return dp, n_shards, row


def _reduce_groups(value: torch.Tensor, groups: list,
                   device: torch.device,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``value`` (an int64 vector on ``device``) reduced by ``op`` over
    each group in turn, one ``all_reduce`` a group.  A gloo group on a CUDA
    device reduces a host copy; any other group reduces in place (an NCCL
    group on the card, a gloo one on the CPU, the dry run's fake one)."""
    for grp in groups:
        host = device.type == "cuda" and "gloo" in str(dist.get_backend(grp))
        t = value.cpu() if host else value
        dist.all_reduce(t, op=op, group=grp)
        value = t
    return value


def _all_reduce_sum(value: torch.Tensor, groups: list,
                    device: torch.device) -> list[int]:
    """:func:`_reduce_groups`, read to the host once."""
    return _reduce_groups(value, groups, device).tolist()


def run_sharded(executor: Executor, plan: ExecPlan, mesh,
                collect: str = "count") -> int:
    """The plan's solution count, its starting chunks dealt over the mesh's
    data-parallel axes (``pod`` and ``data``, where present).

    Every rank of the mesh calls this with the same plan and its own
    replica of the graph in ``executor``.  Exits, as in the reference: a
    live-store snapshot executor runs the host loop (``executor.run``); no
    candidates or an unsat plan gives 0; a capacity overflow on any rank
    logs a warning, and every rank then returns the host loop's count.
    ``mesh.device_type`` must be the executor's device type."""
    if collect != "count":
        raise ValueError(f"run_sharded collects counts, not {collect!r}")
    if mesh.device_type != executor.device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot drive an "
                         f"executor on {executor.device}")
    state = executor.pin()
    view, dg = state
    if view is not None:
        # live-store snapshots re-resolve candidates per version and ship
        # delta arrays per call: route them through the host loop
        return executor.run(plan, collect="count", state=state).count
    if plan.n_params:
        raise ValueError("run_sharded takes a plan with its constants baked "
                         "in, not a parameterized one")
    dp, n_shards, row = _dp_layout(mesh)
    cands = plan.start_candidates
    if cands.shape[0] == 0 or plan.unsat:
        return 0
    chunker = GreedyChunker(n_shards)
    chunks, counts, _ = chunker.partition(cands, executor.graph.out.degree)
    width = chunks.shape[1]
    opts = executor.opts
    cap = max(opts.init_cap, 1 << max(6, (width - 1).bit_length()))
    # widen capacity by the plan's fanout estimate, like the host loop
    est = 1.0
    for f in plan.est_fanout:
        est *= max(1.0, min(f, 64.0))
    cap = min(opts.max_cap,
              max(cap, 1 << int(np.ceil(np.log2(max(2.0, width * min(est, 512.0)))))))

    n_steps = len(plan.steps)
    fn = build_chunk_fn(dg, plan, (cap,) * n_steps, width, opts,
                        table_input=False, collect="count")
    sarrs = executor._arrays(plan, state)
    dev = executor.device
    chunk = torch.from_numpy(chunks[row]).to(dev)
    n_real = torch.full((), int(counts[row]), dtype=I32, device=dev)
    _, _, _, count, scalars = fn(chunk, n_real, None, None, None, sarrs)
    # one collective a group: the count and the rows that overflowed
    total, ovf = _all_reduce_sum(
        torch.stack([count.to(I64), (scalars[1] < n_steps).to(I64)]),
        [mesh.get_group(a) for a in dp], dev)
    if ovf > 0:
        log.warning("sharded run overflowed capacity %d; falling back to host "
                    "loop with retry", cap)
        return executor.run(plan, collect="count", state=state).count
    return total


# ---------------------------------------------------------------------------
# SPMD dry-run step (production-scale query step)
# ---------------------------------------------------------------------------


def engine_chunk_step(nbr_el, iptr_rows, label_bitmap, chunk, chunk_count,
                      *, cap: int, n_steps: int, max_log_deg: int = 32):
    """One fused query-chunk step at production scale.

    Semantically the executor's plan program for an n_steps-deep tree query
    with a label filter per step and one non-tree join check at the last
    step (the Q2/Q9 triangle shape):

      nbr_el       int32 [n_edges]           (el,src,dst)-sorted adjacency
      iptr_rows    int32 [n_steps, n_v + 1]  per-step CSR indptr rows
      label_bitmap int32 [n_v, W]            vertex label words (the
                                             uint32 words' bit patterns)
      chunk        int32 [chunk_width]       starting vertices (-1 padded)
      chunk_count  int32 []                  (a tensor or an int)

    Returns ``(count, overflow)``: an int32 and a bool scalar tensor on the
    inputs' device.  The label filter runs through ``ops.bitmap_superset``
    (its ids form gathers the rows) and the join through
    ``ops.edge_exists``; the per-step compaction is a cumsum and a scatter
    to a sink slot at ``cap``."""
    dev = chunk.device
    if chunk.shape[0] > cap:
        raise ValueError(f"engine_chunk_step: a chunk of {chunk.shape[0]} "
                         f"exceeds the capacity {cap}")
    n_v, w = label_bitmap.shape
    n_e = nbr_el.shape[0]
    required = torch.ones(w, dtype=I32, device=dev)  # representative mask

    b = torch.full((cap,), -1, dtype=I32, device=dev)
    b[: chunk.shape[0]] = chunk
    count = torch.as_tensor(chunk_count, dtype=I32, device=dev).clamp(max=cap)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    slots = torch.arange(cap, dtype=I32, device=dev)

    for step in range(n_steps):
        iptr = iptr_rows[step]
        alive = slots < count
        vp = b.clamp(0, n_v - 1)
        start = iptr[vp]
        deg = torch.where(alive, iptr[vp + 1] - start, 0)
        # int64 prefix sums: the total cannot wrap, so an oversized
        # expansion is always reported
        coffs = torch.cumsum(deg, 0, dtype=I64)
        total = coffs[-1]
        offs = (coffs - deg).to(I32)
        overflow = overflow | (total > cap)
        row, j, valid = kops.ragged_expand(offs, deg, cap)
        idx = (start[row] + j).clamp(0, n_e - 1)
        v_new = torch.where(valid, nbr_el[idx], -1)
        ok = valid & kops.bitmap_superset(label_bitmap, required, ids=v_new)
        if step == n_steps - 1:
            # non-tree join: edge (prev_binding -> v_new) must exist
            pv = b[row].clamp(0, n_v - 1)
            lo = iptr_rows[0][pv]
            hi = iptr_rows[0][pv + 1]
            ok = ok & kops.edge_exists(nbr_el, lo, hi, v_new,
                                       n_iters=max_log_deg)
        # compact
        oki = ok.to(I32)
        pos = torch.where(ok, torch.cumsum(oki, 0, dtype=I32) - 1, cap)
        nb = torch.full((cap + 1,), -1, dtype=I32, device=dev)
        nb[pos] = v_new
        b = nb[:cap]
        count = oki.sum(dtype=I32)
    return count, overflow


def engine_cell(mesh, cfg, cell_meta: dict):
    """The engine cell's per-rank step over ``mesh`` (the reference's
    ``lower_engine_cell``; torch has no lowering, so the step itself):
    ``(step, args)``.

    ``step(nbr_el, iptr_rows, label_bitmap, chunks, counts)`` runs
    :func:`engine_chunk_step` on this rank's own row of ``chunks [D,
    chunk]`` / ``counts [D]`` (``D`` the data-parallel shard count, the row
    from ``_dp_layout``), then, as the reference's ``psum`` / ``pmax``,
    sums the count and takes the max of the overflow flag over each
    data-parallel group in turn (``_reduce_groups``: two ``all_reduce``s a
    group); it returns them as an int64 ``[count, overflow]`` tensor on the
    inputs' device, the same on every rank.  ``args`` are ``meta`` tensors
    of the cell's global shapes.  The dry run calls the step on fake
    tensors, the card on real ones."""
    dp, n_shards, row = _dp_layout(mesh)
    cap = cell_meta["cap"]
    n_steps = cell_meta.get("n_steps", cfg.n_steps)
    w = (cfg.n_vlabels + 31) // 32

    def step(nbr_el, iptr_rows, label_bitmap, chunks, counts):
        dev = nbr_el.device
        count, ovf = engine_chunk_step(nbr_el, iptr_rows, label_bitmap,
                                       chunks[row], counts[row], cap=cap,
                                       n_steps=n_steps)
        groups = [mesh.get_group(a) for a in dp]
        count = _reduce_groups(count.to(I64).reshape(1), groups, dev)
        ovf = _reduce_groups(ovf.to(I64).reshape(1), groups, dev,
                             op=dist.ReduceOp.MAX)
        return torch.cat([count, ovf])

    def meta(shape, dtype=I32):
        return torch.empty(shape, dtype=dtype, device="meta")

    args = (meta((cfg.n_edges,)), meta((n_steps, cfg.n_vertices + 1)),
            meta((cfg.n_vertices, w)), meta((n_shards, cell_meta["chunk"])),
            meta((n_shards,)))
    return step, args
