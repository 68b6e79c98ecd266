"""Message-passing primitives shared by the GNN zoo (single device).

Aggregation is a scatter over an edge index, on ``index_add_`` and
``scatter_reduce``, as the reference builds it on ``jax.ops.segment_sum``
/ ``segment_max``.  JAX drops a segment id outside ``[0, n)`` (negative
ones too) where torch would raise, so every scatter here drops exactly
those entries first; and a gather by an edge index wraps a negative id
once and clamps into ``[0, n-1]``, as JAX's indexing does, passing no
gradient back from a clamped id (:func:`take`).

The explicit-SPMD variants (``*_spmd``, the reference's "shard_map"
profile) aggregate this rank's shard of the edges locally and combine
the ranks of the mesh axes ``axes`` with the collectives of
``sharding.comm`` (the mesh is the one :func:`~repro_torch.sharding.comm.
mesh_scope` set).  They take the collective path whenever ``axes`` is
set, one rank included; with no axes they are the plain aggregations.

Gradient convention, as inside ``shard_map``: the all-reduce transposes
to an all-reduce, so a cotangent that crosses one of these aggregations
is summed over the ranks, and the ``pmean`` of the per-rank parameter
gradients afterwards (``sharding.gnn_spmd``) is the global gradient.
"""

from __future__ import annotations

import torch

from repro_torch.sharding.comm import pmax, psum

# a config's ``compute_dtype`` (float64 for runs against a float64 truth)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 with JAX's index semantics: a negative id
    counts from the end once, then the id clamps into ``[0, n-1]``; and,
    as XLA's scatter drops what lies out of bounds, an id still outside
    ``[0, n)`` after the wrap passes no gradient back."""
    n = x.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    rows = x[idx.clamp(0, max(n, 1) - 1)]
    if not x.requires_grad:
        return rows
    return torch.where(inside.view((-1,) + (1,) * (x.dim() - 1)), rows,
                       rows.detach())


def _spare(seg: torch.Tensor, n: int) -> torch.Tensor:
    """``seg`` as int64, an entry whose segment lies outside ``[0, n)``
    sent to a spare segment ``n`` that the result leaves out (no
    selection whose length depends on the values)."""
    seg = seg.long()
    return torch.where((seg >= 0) & (seg < n), seg, n)


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, _spare(seg, n), x)[:n]


def _segment_extreme(x, seg, n, reduce: str, fill) -> torch.Tensor:
    out = torch.full((n + 1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    index = _spare(seg, n).view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return out.scatter_reduce(0, index, x, reduce, include_self=True)[:n]


def _lowest(dtype: torch.dtype):
    return (-torch.inf if dtype.is_floating_point
            else torch.iinfo(dtype).min)


def segment_max(x, seg, n):
    """Empty segments hold the identity: ``-inf`` (the dtype's least
    integer for integers), as ``jax.ops.segment_max``'s."""
    return _segment_extreme(x, seg, n, "amax", _lowest(x.dtype))


def segment_min(x, seg, n):
    top = (torch.inf if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).max)
    return _segment_extreme(x, seg, n, "amin", top)


def segment_mean(x, seg, n):
    s = segment_sum(x, seg, n)
    cnt = segment_sum(torch.ones((x.shape[0], 1), dtype=x.dtype,
                                 device=x.device), seg, n)
    return s / torch.clamp(cnt, min=1.0)


def segment_std(x, seg, n, eps: float = 1e-5):
    mu = segment_mean(x, seg, n)
    var = segment_mean(x * x, seg, n) - mu * mu
    return torch.sqrt(torch.clamp(var, min=0.0) + eps)


def segment_softmax_norm(scores, seg, n):
    """Edge-softmax: normalize scores within each destination segment."""
    smax = segment_max(scores, seg, n)
    ex = torch.exp(scores - take(smax, seg))
    denom = segment_sum(ex, seg, n)
    return ex / torch.clamp(take(denom, seg), min=1e-9)


def degrees(seg, n, dtype=torch.float32):
    return segment_sum(torch.ones(seg.shape[0], dtype=dtype,
                                  device=seg.device), seg, n)


# --------------------------------------------------------------------------
# Explicit-SPMD variants: the local aggregation of this rank's edges, then
# the ranks of ``axes`` combined (the group of those mesh axes: its size is
# the shard count).  With no axes each is the plain aggregation.
# --------------------------------------------------------------------------


def segment_sum_spmd(x, seg, n, axes):
    """Local scatter-add over this shard's edges + cross-shard psum."""
    if not axes:
        return segment_sum(x, seg, n)
    return psum(segment_sum(x, seg, n), axes)


def segment_max_spmd(x, seg, n, axes):
    """Cross-shard segment max, expressed through a masked psum so the
    backward pass uses the same collective transpose as the sum
    aggregators.  Empty segments: local counts guard the -inf identity
    with a -3.0e38 sentinel; globally empty segments restore -inf so
    downstream ``nan_to_num`` treats both paths identically.  Cross-shard
    value ties share the gradient equally."""
    if not axes:
        return segment_max(x, seg, n)
    local = segment_max(x, seg, n)
    cnt_l = segment_sum(torch.ones(seg.shape[0], dtype=local.dtype,
                                   device=local.device), seg, n)
    while cnt_l.dim() < local.dim():
        cnt_l = cnt_l[..., None]
    local_f = torch.where(cnt_l > 0, local,
                          torch.tensor(-3.0e38, dtype=local.dtype,
                                       device=local.device))
    m = pmax(local_f, axes)
    mask = ((local_f.detach() == m) & (cnt_l > 0)).to(local.dtype)
    ties = psum(mask, axes)
    out = psum(local_f * mask, axes) / torch.clamp(ties, min=1.0)
    cnt_g = psum(torch.clamp(cnt_l, max=1.0), axes)
    return torch.where(cnt_g > 0, out, -torch.inf)


def segment_min_spmd(x, seg, n, axes):
    if not axes:
        return segment_min(x, seg, n)
    return -segment_max_spmd(-x, seg, n, axes)


def segment_mean_spmd(x, seg, n, axes):
    s = segment_sum_spmd(x, seg, n, axes)
    cnt = segment_sum_spmd(torch.ones((x.shape[0], 1), dtype=x.dtype,
                                      device=x.device), seg, n, axes)
    return s / torch.clamp(cnt, min=1.0)


def segment_std_spmd(x, seg, n, axes, eps: float = 1e-5):
    mu = segment_mean_spmd(x, seg, n, axes)
    mu2 = segment_mean_spmd(x * x, seg, n, axes)
    return torch.sqrt(torch.clamp(mu2 - mu * mu, min=0.0) + eps)


def degrees_spmd(seg, n, axes, dtype=torch.float32):
    local = degrees(seg, n, dtype)
    return psum(local, axes) if axes else local
