"""Shared neural-net layers of the port (what DLRM and GCN use).

Conventions, as in the reference's ``models/layers.py``:
  - weights are ``[in, out]`` and applied as ``x @ w`` (so carrying a
    reference weight across is a copy);
  - master dtype float32;
  - initializers draw from an explicit ``torch.Generator``.

RMSNorm, RoPE, grouped-query attention and SwiGLU come with the LM slice.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn


def dense_init(in_dim: int, out_dim: int, scale: float | None = None, *,
               generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
    """``N(0, 1) · scale`` of shape ``[in, out]``, scale ``1/sqrt(in)`` by
    default."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    if w.device.type != "meta":
        w.normal_(generator=generator).mul_(scale)
    return w


def mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
        biases: Sequence[torch.Tensor] | None = None,
        act: Callable = torch.relu, final_act: bool = False) -> torch.Tensor:
    n = len(weights)
    for i, w in enumerate(weights):
        x = x @ w.to(x.dtype)
        if biases is not None:
            x = x + biases[i].to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


class MLP(nn.Module):
    """A stack of ``[in, out]`` layers: ``w`` (and ``b``) as parameter
    lists, so the state dict's names are ``w.i`` / ``b.i``, the reference
    pytree's ``{"w": [...], "b": [...]}``."""

    def __init__(self, dims: Sequence[int], with_bias: bool = True, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.w = nn.ParameterList()
        self.b = nn.ParameterList() if with_bias else None
        for i in range(len(dims) - 1):
            self.w.append(nn.Parameter(dense_init(
                dims[i], dims[i + 1], generator=generator, device=device)))
            if with_bias:
                self.b.append(nn.Parameter(torch.zeros(
                    dims[i + 1], dtype=torch.float32, device=device)))


def mlp_init(dims: Sequence[int], with_bias: bool = True, *,
             generator: torch.Generator | None = None, device=None) -> MLP:
    return MLP(dims, with_bias, generator=generator, device=device)


def mlp_apply(params: MLP, x, act: Callable = torch.relu,
              final_act: bool = False):
    return mlp(x, list(params.w),
               None if params.b is None else list(params.b), act=act,
               final_act=final_act)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore: int = -1) -> torch.Tensor:
    """Mean CE over non-ignored positions; logits [..., V], labels int
    [...]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.long().clamp(min=0)[..., None])[..., 0]
    nll = lse - ll
    mask = (labels != ignore).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
