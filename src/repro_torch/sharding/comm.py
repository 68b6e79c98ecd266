"""Collectives over a mesh's named axes, and the mesh a step runs under.

The reference runs its SPMD code inside ``shard_map``, where a collective
names mesh axes (``psum(x, ("data", "model"))``).  Here every rank runs
its own program, and a collective needs the process group of the ranks
that differ only along those axes.  :func:`mesh_scope` sets the mesh a
step runs under and :func:`axis_group` resolves a tuple of axis names to
this rank's group of it (built once a mesh and tuple, by every rank in
the same order), so a model's config keeps only axis names: it still
compares and pickles.

The differentiable collectives keep ``shard_map``'s transposes:

- :func:`psum`: an all-reduce whose backward all-reduces the cotangent
  (``psum`` transposes to ``psum``), so a gradient that crosses an
  aggregation is summed over the ranks and a ``pmean`` of the per-rank
  parameter gradients afterwards gives the global gradient exactly;
- :func:`all_gather_tiled`: the shards concatenated along dim 0 in the
  group's rank order; its backward keeps this rank's slice of the
  cotangents summed over the ranks (a reduce-scatter, here an all-reduce
  and a slice, which gloo serves on CUDA tensors too);
- :func:`ppermute_next`: sends to the next rank of the group and takes
  from the previous one (the last sends nothing, the first takes zeros);
  its backward sends the cotangent the other way.

``pmax`` carries no gradient (the reference stops it).
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import unset_fake_temporarily

_scope = threading.local()


@contextmanager
def mesh_scope(mesh):
    """Run the body under ``mesh``: :func:`axis_group` resolves axis names
    against it."""
    prev = getattr(_scope, "mesh", None)
    _scope.mesh = mesh
    try:
        yield mesh
    finally:
        _scope.mesh = prev


def current_mesh():
    mesh = getattr(_scope, "mesh", None)
    if mesh is None:
        raise RuntimeError("a collective over mesh axes runs under "
                           "sharding.comm.mesh_scope(mesh)")
    return mesh


def _as_tuple(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_group(axes, mesh=None):
    """This rank's process group over the mesh axes ``axes`` (a name or a
    tuple of names, major first): the ranks whose mesh coordinates differ
    only along them, in row-major order of those axes (a tiled gather's
    order, as ``shard_map``'s).  A group over several axes is made once
    and kept on the mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    axes = _as_tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_axis_groups", {})
    if axes not in groups:
        names = tuple(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        size = math.prod(mesh.mesh.shape[d] for d in dims)
        # outside the dry run's fake mode, if it is on: the ranks are
        # values it would not have
        with unset_fake_temporarily():
            rows = mesh.mesh.permute(rest + dims).reshape(-1, size).tolist()
        me = dist.get_rank()
        for ranks in rows:  # every rank creates every group, in this order
            g = dist.new_group(ranks)
            if me in ranks:
                groups[axes] = g
    return groups[axes]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``; its backward sums the
    cotangents over them too."""
    return _AllReduceSum.apply(x, axis_group(axes))


@torch.no_grad()
def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    """The element-wise max over the ranks of ``axes``, without gradient."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis_group(axes))
    return out


@torch.no_grad()
def pmean_(tensors, axes) -> None:
    """Replace each tensor by its mean over the ranks of ``axes``, in
    place, without gradient."""
    group = axis_group(axes)
    n = dist.get_world_size(group)
    for t in tensors:
        dist.all_reduce(t, group=group)
        t.div_(n)


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None


def all_gather_tiled(x: torch.Tensor, axes) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 (``all_gather(...,
    tiled=True)``); backward: this rank's slice of the summed
    cotangents."""
    return _AllGatherTiled.apply(x, axis_group(axes))


def _shift(x: torch.Tensor, group, forward: bool) -> torch.Tensor:
    """Send ``x`` one rank on (``forward``) or back in the group's order
    and return what arrives: zeros where nothing does."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    to, frm = (me + 1, me - 1) if forward else (me - 1, me + 1)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if 0 <= to < n:
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, to), group))
    if 0 <= frm < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, frm), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PpermuteNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, forward=True)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, forward=False), None


def ppermute_next(x: torch.Tensor, axes) -> torch.Tensor:
    """``ppermute(x, axes, [(i, i + 1)])``: rank i's ``x`` arrives at rank
    i + 1; rank 0 gets zeros."""
    return _PpermuteNext.apply(x, axis_group(axes))
