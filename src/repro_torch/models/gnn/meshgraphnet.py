"""MeshGraphNet (arXiv:2010.03409) — encode-process-decode mesh simulator.

15 message-passing layers; per layer an edge MLP m_e = MLP([h_u, h_v, e])
updates edge features (residual) and a node MLP over [h_v, Σ_e m_e] updates
node features (residual); sum aggregation (``index_add_``, over this
rank's edge shard and the ``spmd_axes`` ranks with ``spmd_axes``); 2-layer
MLPs with LayerNorm.  Output: per-node dynamics regression (MSE).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.models.gnn.common import (DTYPES, segment_sum_spmd,
                                           take)
from repro_torch.models.layers import layernorm, mlp_apply, mlp_init


@dataclass(frozen=True)
class MGNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_node_in: int
    d_edge_in: int
    d_out: int
    mlp_layers: int = 2
    compute_dtype: str = "float32"
    spmd_axes: tuple = ()

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]


class MLPLN(nn.Module):
    """A ReLU MLP, then LayerNorm (eps 1e-5): ``mlp.w.j`` / ``mlp.b.j``,
    ``ln_g``, ``ln_b``."""

    def __init__(self, dims, *, generator, device):
        super().__init__()
        self.mlp = mlp_init(dims, generator=generator, device=device)
        self.ln_g = nn.Parameter(torch.ones(dims[-1], dtype=torch.float32,
                                            device=device))
        self.ln_b = nn.Parameter(torch.zeros(dims[-1], dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(mlp_apply(self.mlp, x, act=torch.relu), self.ln_g,
                         self.ln_b)


class _Block(nn.Module):
    def __init__(self, h: int, hid: list, *, generator, device):
        super().__init__()
        self.edge = MLPLN([3 * h] + hid, generator=generator, device=device)
        self.node = MLPLN([2 * h] + hid, generator=generator, device=device)


class MeshGraphNet(nn.Module):
    """State dict ``node_enc``, ``edge_enc`` (each ``mlp``, ``ln_g``,
    ``ln_b``), ``decoder`` (an MLP) and ``blocks.{i}.edge`` /
    ``blocks.{i}.node``: the reference pytree's layout.  Weights from
    ``generator``."""

    def __init__(self, cfg: MGNConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.d_hidden
        hid = [h] * cfg.mlp_layers
        kw = dict(generator=generator, device=device)
        self.node_enc = MLPLN([cfg.d_node_in] + hid, **kw)
        self.edge_enc = MLPLN([cfg.d_edge_in] + hid, **kw)
        self.decoder = mlp_init(hid + [cfg.d_out], **kw)
        self.blocks = nn.ModuleList(_Block(h, hid, **kw)
                                    for _ in range(cfg.n_layers))

    def forward(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        dtype = cfg.dtype
        x = batch["x"].to(dtype)
        e = batch["edge_attr"].to(dtype)
        src, dst = batch["edge_src"], batch["edge_dst"]
        n = x.shape[0]
        h = self.node_enc(x)
        he = self.edge_enc(e)
        for blk in self.blocks:
            he = he + blk.edge(torch.cat([take(h, src), take(h, dst), he],
                                         dim=-1))
            agg = segment_sum_spmd(he, dst, n, cfg.spmd_axes)
            h = h + blk.node(torch.cat([h, agg], dim=-1))
        return mlp_apply(self.decoder, h)


def loss_fn(model: MeshGraphNet, batch: dict) -> torch.Tensor:
    pred = model(batch)
    tgt = batch["targets"].to(pred.dtype)
    return torch.mean((pred - tgt) ** 2)
