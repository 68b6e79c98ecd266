"""GCN (Kipf & Welling, arXiv:1609.02907) — symmetric-normalized SpMM stack.

Ã·X·W realized as edge-gather → weighted segment-sum with per-edge
1/sqrt(d_i d_j) coefficients (self-loops included).  gcn-cora config:
2 layers, hidden 16, node classification.  The aggregation is plain torch
(``index_add_``), as the reference's is ``jax.ops.segment_sum`` outside
any Pallas kernel; with ``spmd_axes`` the edges are this rank's shard and
the sums combine over those mesh axes (``common.*_spmd``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.models.gnn.common import (DTYPES, degrees_spmd,
                                           segment_sum_spmd, take)
from repro_torch.models.layers import cross_entropy_loss, dense_init


@dataclass(frozen=True)
class GCNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int
    compute_dtype: str = "float32"
    # explicit-SPMD aggregation (edges sharded across these mesh axes)
    spmd_axes: tuple = ()

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]


class GCN(nn.Module):
    """``w``: one ``[in, out]`` weight a layer (state dict ``w.i``, the
    reference pytree's ``{"w": [...]}``), drawn from ``generator``."""

    def __init__(self, cfg: GCNConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dims = ([cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
                + [cfg.n_classes])
        self.w = nn.ParameterList(
            nn.Parameter(dense_init(dims[i], dims[i + 1], generator=generator,
                                    device=device))
            for i in range(cfg.n_layers))

    def forward(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        dtype = cfg.dtype
        ax = cfg.spmd_axes
        x = batch["x"].to(dtype)
        src, dst = batch["edge_src"], batch["edge_dst"]
        n = x.shape[0]
        # symmetric norm with implicit self loops
        deg = degrees_spmd(dst, n, ax) + 1.0
        inv = torch.rsqrt(deg)
        coef = (take(inv, src) * take(inv, dst))[:, None].to(dtype)
        self_coef = (inv * inv)[:, None].to(dtype)
        last = len(self.w) - 1
        for i, w in enumerate(self.w):
            h = x @ w.to(dtype)
            msg = take(h, src) * coef
            agg = segment_sum_spmd(msg, dst, n, ax) + h * self_coef
            x = torch.relu(agg) if i < last else agg
        return x


def loss_fn(model: GCN, batch: dict) -> torch.Tensor:
    logits = model(batch)
    labels = batch["labels"]
    mask = batch.get("train_mask")
    if mask is not None:
        labels = torch.where(mask, labels, -1)
    return cross_entropy_loss(logits, labels)
