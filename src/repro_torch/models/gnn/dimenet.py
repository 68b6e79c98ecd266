"""DimeNet (arXiv:2003.03123) — directional message passing over triplets.

Messages live on edges and are updated from all incoming edges k→j of
each edge j→i, modulated by an angular basis of the angle ∠(kj, ji) and a
radial basis of the distances.  Radial basis: sin(nπ d/c)/d with a smooth
cutoff envelope; angular basis: a Chebyshev cos(lθ) family of the
published rank (n_spherical × n_radial outer product), as the reference
simplifies it.  Bilinear interaction W[n_bilinear] as the paper's einsum
(``bilinear``).

Batch layout: z [N] atom types, pos [N, 3], edge_src/dst [E], t_kj/t_ji
[T] (edge ids), batch_seg [N] molecule id, targets [B].  Output: per-
molecule energy (MSE).

Explicit SPMD, as the reference's: with ``spmd_axes`` (v1) the triplet
arrays are this rank's shard and the triplet sum combines over those mesh
axes; with ``edge_sharded`` too (v2, :func:`forward_edge_sharded`) the
edge arrays are sharded as well and each block exchanges its edge
messages with one all-gather.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.gnn.common import (DTYPES, segment_sum,
                                           segment_sum_spmd, take)
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init
from repro_torch.sharding.comm import all_gather_tiled, psum


@dataclass(frozen=True)
class DimeNetConfig:
    name: str
    n_blocks: int
    d_hidden: int
    n_bilinear: int
    n_spherical: int
    n_radial: int
    n_atom_types: int = 16
    cutoff: float = 5.0
    compute_dtype: str = "float32"
    # triplet arrays sharded across these axes (edge/node arrays replicated)
    spmd_axes: tuple = ()
    # v2: edge arrays sharded too; edge-message MLPs run on the local shard
    # and messages are exchanged with one all_gather per block instead of
    # every rank recomputing the full [E, H] update
    edge_sharded: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]


class _Block(nn.Module):
    def __init__(self, cfg: DimeNetConfig, *, generator, device):
        super().__init__()
        h = cfg.d_hidden
        self.w_src = nn.Parameter(dense_init(h, h, generator=generator,
                                             device=device))
        self.w_sbf = nn.Parameter(dense_init(
            cfg.n_spherical * cfg.n_radial, cfg.n_bilinear,
            generator=generator, device=device))
        self.w_bil = nn.Parameter(dense_init(
            cfg.n_bilinear * h, h, 1.0 / math.sqrt(h), generator=generator,
            device=device).reshape(cfg.n_bilinear, h, h))
        self.update = mlp_init([h, h, h], generator=generator, device=device)


class DimeNet(nn.Module):
    """State dict ``embed_z`` [n_atom_types, H], ``rbf_w`` [R, H],
    ``edge_embed`` (an MLP), ``blocks.{i}.{w_src, w_sbf, w_bil, update}``
    and ``out_blocks.{i}`` (MLPs H-H-1): the reference pytree's layout.
    Weights from ``generator``."""

    def __init__(self, cfg: DimeNetConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.d_hidden
        kw = dict(generator=generator, device=device)
        self.embed_z = nn.Parameter(dense_init(cfg.n_atom_types, h, 0.1,
                                               **kw))
        self.rbf_w = nn.Parameter(dense_init(cfg.n_radial, h, **kw))
        self.edge_embed = mlp_init([3 * h, h], **kw)
        self.blocks = nn.ModuleList(_Block(cfg, **kw)
                                    for _ in range(cfg.n_blocks))
        self.out_blocks = nn.ModuleList(mlp_init([h, h, 1], **kw)
                                        for _ in range(cfg.n_blocks))

    def forward(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        if cfg.spmd_axes and cfg.edge_sharded:
            return forward_edge_sharded(self, batch)
        dtype = cfg.dtype
        z, pos = batch["z"], batch["pos"].to(dtype)
        src, dst = batch["edge_src"], batch["edge_dst"]
        t_kj, t_ji = batch["t_kj"], batch["t_ji"]
        n = pos.shape[0]
        e = src.shape[0]
        vec = take(pos, dst) - take(pos, src)
        d = torch.sqrt(torch.clamp(torch.sum(vec * vec, -1), min=1e-12))
        rbf = _rbf(d, cfg).to(dtype)  # [E, R]

        # angle at shared vertex j between edges (k->j) and (j->i)
        v1 = -take(vec, t_kj)
        v2 = take(vec, t_ji)
        cosang = torch.sum(v1 * v2, -1) / torch.clamp(
            torch.linalg.vector_norm(v1, dim=-1)
            * torch.linalg.vector_norm(v2, dim=-1), min=1e-9)
        angle = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
        sbf = _sbf(angle, take(d, t_kj), cfg).to(dtype)  # [T, S*R]

        hz = take(self.embed_z.to(dtype), z)
        rbf_h = rbf @ self.rbf_w.to(dtype)
        m = mlp_apply(self.edge_embed, torch.cat(
            [take(hz, src), take(hz, dst), rbf_h], dim=-1))
        m = F.silu(m)  # [E, H]

        n_graphs = batch["targets"].shape[0]
        per_graph = torch.zeros((n_graphs,), dtype=dtype, device=pos.device)
        seg = batch.get("batch_seg")
        if seg is None:
            seg = torch.zeros((n,), dtype=torch.int32, device=pos.device)

        for blk, out in zip(self.blocks, self.out_blocks):
            # directional message: for each triplet, source message m[t_kj]
            msrc = take(F.silu(m @ blk.w_src.to(dtype)), t_kj)  # [T, H]
            a = sbf @ blk.w_sbf.to(dtype)  # [T, B]
            inter = _bilinear_remat(a, blk.w_bil.to(dtype), msrc)
            # the sum over incoming triplets
            agg = segment_sum_spmd(inter, t_ji, e, cfg.spmd_axes)
            m = m + F.silu(mlp_apply(blk.update, m + agg))
            # output block: per-node then per-molecule energy contribution
            node_e = segment_sum(m, dst, n)
            per_graph = per_graph + segment_sum(
                mlp_apply(out, node_e)[:, 0], seg, n_graphs)
        return per_graph


def forward_edge_sharded(model: DimeNet, batch: dict) -> torch.Tensor:
    """Explicit-SPMD v2: local edge shard + local triplets.

    Batch (this rank's): edge_src/edge_dst [E_l] the local edge range;
    t_kj [T_l] GLOBAL edge ids (sources may be remote); t_ji [T_l] LOCAL
    edge ids (triplets co-partitioned with their target edge: a
    data-pipeline guarantee, ``sharding.gnn_spmd.edge_shard_triplets``);
    z/pos/batch_seg replicated.

    Per block: edge-message MLP on [E_l, H]; one tiled all-gather
    rebuilds [E, H] for the t_kj gathers; node sums psum.  The all-gather
    is differentiable (its backward a reduce-scatter), so gradients stay
    exact."""
    cfg = model.cfg
    axes = cfg.spmd_axes
    dtype = cfg.dtype
    z, pos = batch["z"], batch["pos"].to(dtype)
    src, dst = batch["edge_src"], batch["edge_dst"]
    t_kj, t_ji = batch["t_kj"], batch["t_ji"]
    n = pos.shape[0]
    e_l = src.shape[0]

    vec_l = take(pos, dst) - take(pos, src)  # [E_l, 3]
    d_l = torch.sqrt(torch.clamp(torch.sum(vec_l * vec_l, -1), min=1e-12))
    rbf_l = _rbf(d_l, cfg).to(dtype)

    # one gather of edge geometry for the triplet angle computation
    vec_full = all_gather_tiled(vec_l, axes)  # [E, 3]
    d_full = all_gather_tiled(d_l, axes)
    v1 = -take(vec_full, t_kj)
    v2 = take(vec_l, t_ji)
    cosang = torch.sum(v1 * v2, -1) / torch.clamp(
        torch.linalg.vector_norm(v1, dim=-1)
        * torch.linalg.vector_norm(v2, dim=-1), min=1e-9)
    angle = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    sbf = _sbf(angle, take(d_full, t_kj), cfg).to(dtype)  # [T_l, S*R]

    hz = take(model.embed_z.to(dtype), z)
    rbf_h = rbf_l @ model.rbf_w.to(dtype)
    m = mlp_apply(model.edge_embed, torch.cat(
        [take(hz, src), take(hz, dst), rbf_h], dim=-1))
    m = F.silu(m)  # [E_l, H]

    n_graphs = batch["targets"].shape[0]
    per_graph = torch.zeros((n_graphs,), dtype=dtype, device=pos.device)
    seg = batch.get("batch_seg")
    if seg is None:
        seg = torch.zeros((n,), dtype=torch.int32, device=pos.device)

    for blk, out in zip(model.blocks, model.out_blocks):
        msrc_l = F.silu(m @ blk.w_src.to(dtype))  # [E_l, H]
        msrc_full = all_gather_tiled(msrc_l, axes)  # [E, H]
        a = sbf @ blk.w_sbf.to(dtype)  # [T_l, B]
        inter = _bilinear_remat(a, blk.w_bil.to(dtype),
                                take(msrc_full, t_kj))
        agg = segment_sum(inter, t_ji, e_l)  # purely local (co-partitioned)
        m = m + F.silu(mlp_apply(blk.update, m + agg))
        node_e = psum(segment_sum(m, dst, n), axes)
        per_graph = per_graph + segment_sum(
            mlp_apply(out, node_e)[:, 0], seg, n_graphs)
    return per_graph


def _bilinear_remat(a, w, msrc):
    """:func:`bilinear`, recomputed in the backward pass, so autograd
    keeps its inputs and not its [T, B·H] outer product: six of those are
    33 GB at minibatch_lg in float32, 66 GB in float64 (more than the
    card holds).  It draws no random numbers: no RNG state kept."""
    return checkpoint(bilinear, a, w, msrc, use_reentrant=False,
                      preserve_rng_state=False)


def _rbf(d: torch.Tensor, cfg: DimeNetConfig) -> torch.Tensor:
    """Spherical-Bessel-flavored radial basis with smooth cutoff envelope."""
    n = torch.arange(1, cfg.n_radial + 1, dtype=torch.float32,
                     device=d.device)
    dn = torch.clamp(d[:, None], min=1e-6)
    u = dn / cfg.cutoff
    env = torch.where(u < 1.0, (1.0 - u) ** 2 * (1.0 + 2.0 * u), 0.0)
    return env * torch.sin(n[None, :] * math.pi * u) / dn


def _sbf(angle: torch.Tensor, d_kj: torch.Tensor,
         cfg: DimeNetConfig) -> torch.Tensor:
    """Angular × radial basis on triplets: cos(lθ) ⊗ rbf(d_kj)."""
    l = torch.arange(cfg.n_spherical, dtype=torch.float32,
                     device=angle.device)
    ang = torch.cos(l[None, :] * angle[:, None])  # [T, S]
    rad = _rbf(d_kj, cfg)  # [T, R]
    return (ang[:, :, None] * rad[:, None, :]).reshape(
        angle.shape[0], cfg.n_spherical * cfg.n_radial)


def bilinear(a: torch.Tensor, w: torch.Tensor,
             msrc: torch.Tensor) -> torch.Tensor:
    """The interaction block's ``einsum("tb,bhg,th->tg", a, w, msrc)``:
    a [T, B], w [B, H, G], msrc [T, H] -> [T, G], contracted in this
    order: the outer product ``a ⊗ msrc`` [T, B·H], then one GEMM against
    ``w`` [B·H, G].  Autograd keeps the [T, B·H] product for ``w``'s
    gradient (5.5 GB at ``minibatch_lg``'s 1,351,680 triplets) unless the
    caller recomputes it (``forward``)."""
    t, (nb, h, g) = a.shape[0], w.shape
    outer = (a[:, :, None] * msrc[:, None, :]).reshape(t, nb * h)
    return outer @ w.reshape(nb * h, g)


def loss_fn(model: DimeNet, batch: dict) -> torch.Tensor:
    pred = model(batch)
    tgt = batch["targets"].to(pred.dtype)
    return torch.mean((pred - tgt) ** 2)
