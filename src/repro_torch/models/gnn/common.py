"""Message-passing primitives shared by the GNN zoo (single device).

Aggregation is a scatter over an edge index, on ``index_add_`` and
``scatter_reduce``, as the reference builds it on ``jax.ops.segment_sum``
/ ``segment_max``.  JAX drops a segment id outside ``[0, n)`` (negative
ones too) where torch would raise, so every scatter here drops exactly
those entries first; and a gather by an edge index wraps a negative id
once and clamps into ``[0, n-1]``, as JAX's indexing does, passing no
gradient back from a clamped id (:func:`take`).  The explicit-SPMD
variants (``*_spmd``) come with the sharding slice.
"""

from __future__ import annotations

import torch


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
    if not x.requires_grad or bool(inside.all()):
        return rows
    return torch.where(inside.view((-1,) + (1,) * (x.dim() - 1)), rows,
                       rows.detach())


def _kept(x: torch.Tensor, seg: torch.Tensor, n: int):
    """The entries whose segment lies in ``[0, n)``, and their segments as
    int64."""
    seg = seg.long()
    keep = (seg >= 0) & (seg < n)
    if bool(keep.all()):
        return x, seg
    return x[keep], seg[keep]


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    x, seg = _kept(x, seg, n)
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, seg, x)


def _segment_extreme(x, seg, n, reduce: str, fill) -> torch.Tensor:
    x, seg = _kept(x, seg, n)
    out = torch.full((n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    index = seg.view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return out.scatter_reduce(0, index, x, reduce, include_self=True)


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
