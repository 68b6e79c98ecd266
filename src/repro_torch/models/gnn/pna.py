"""PNA — Principal Neighbourhood Aggregation (arXiv:2004.05718).

4 parallel aggregators (mean/max/min/std) × 3 degree scalers (identity /
amplification / attenuation) → 12-fold concatenated message, post-MLP per
layer.  Config pna: 4 layers, hidden 75.  The aggregation is plain torch
(``index_add_``, ``scatter_reduce``), as the reference's is
``jax.ops.segment_*`` outside any Pallas kernel; with ``spmd_axes`` the
edges are this rank's shard and the aggregators combine over those mesh
axes (``common.*_spmd``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.models.gnn.common import (DTYPES, degrees_spmd,
                                           segment_max_spmd,
                                           segment_mean_spmd,
                                           segment_min_spmd,
                                           segment_std_spmd, take)
from repro_torch.models.layers import cross_entropy_loss, mlp_apply, mlp_init


@dataclass(frozen=True)
class PNAConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int
    delta: float = 2.5  # mean log-degree normalizer (dataset statistic)
    compute_dtype: str = "float32"
    spmd_axes: tuple = ()

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]


N_AGG = 4
N_SCALE = 3


class _Layer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, *, generator, device):
        super().__init__()
        self.pre = mlp_init([2 * d_in, d_hidden], generator=generator,
                            device=device)
        self.post = mlp_init([d_in + N_AGG * N_SCALE * d_hidden, d_hidden,
                              d_hidden], generator=generator, device=device)


class PNA(nn.Module):
    """State dict ``layers.{i}.pre`` / ``layers.{i}.post`` and ``head``
    (each an MLP's ``w.j`` / ``b.j``): the reference pytree's ``{"layers":
    [{"pre", "post"}], "head"}``.  Weights from ``generator``."""

    def __init__(self, cfg: PNAConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
        self.layers = nn.ModuleList(
            _Layer(d, cfg.d_hidden, generator=generator, device=device)
            for d in dims)
        self.head = mlp_init([cfg.d_hidden, cfg.n_classes],
                             generator=generator, device=device)

    def forward(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        dtype = cfg.dtype
        ax = cfg.spmd_axes
        x = batch["x"].to(dtype)
        src, dst = batch["edge_src"], batch["edge_dst"]
        n = x.shape[0]
        deg = degrees_spmd(dst, n, ax)
        logd = torch.log(deg + 1.0)
        amp = (logd / cfg.delta)[:, None].to(dtype)
        # a node of degree 0 gets delta / 1e-2
        att = (cfg.delta / torch.clamp(logd, min=1e-2))[:, None].to(dtype)
        for layer in self.layers:
            msg_in = torch.cat([take(x, src), take(x, dst)], dim=-1)
            m = torch.relu(mlp_apply(layer.pre, msg_in))
            aggs = [segment_mean_spmd(m, dst, n, ax),
                    segment_max_spmd(m, dst, n, ax),
                    segment_min_spmd(m, dst, n, ax),
                    segment_std_spmd(m, dst, n, ax)]
            scaled = []
            for a in aggs:
                # an empty segment's max / min is -inf / +inf
                a = torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)
                scaled += [a, a * amp, a * att]
            h = torch.cat([x] + scaled, dim=-1)
            x = torch.relu(mlp_apply(layer.post, h))
        return mlp_apply(self.head, x)


def loss_fn(model: PNA, batch: dict) -> torch.Tensor:
    logits = model(batch)
    labels = batch["labels"]
    mask = batch.get("train_mask")
    if mask is not None:
        labels = torch.where(mask, labels, -1)
    return cross_entropy_loss(logits, labels)
