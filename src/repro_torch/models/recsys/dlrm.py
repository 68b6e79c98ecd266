"""DLRM (arXiv:1906.00091) — RM-2 shape: 26 sparse + 13 dense features.

The embedding bags are the hand-written ``segment_gather`` kernel (the
fixed-hotness form: ``-1`` pads, an id ``≥ V`` reads row ``V-1``) with its
gradient, :class:`repro_torch.kernels.ops.EmbeddingBagSum`: one launch per
table, the system's hot loop at serving time.  Dot-product feature
interaction (upper triangle) + bottom/top MLPs, BCE loss.

``retrieval_score`` implements the retrieval_cand shape: one user query
scored against N candidate item embeddings as a single GEMV.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.kernels.ops import embedding_bag_sum
from repro_torch.models.layers import mlp_apply, mlp_init

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


@dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int
    n_sparse: int
    embed_dim: int
    bot_mlp: tuple[int, ...]
    top_mlp: tuple[int, ...]
    vocab_sizes: tuple[int, ...]  # one per sparse field
    hotness: int = 8  # multi-hot lookups per field (RM-2 style)
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2


class DLRM(nn.Module):
    """``tables`` (one ``[V, D]`` float32 table a sparse field), ``bot`` and
    ``top`` MLPs: the state dict's names are the reference pytree's
    (``tables.i``, ``bot.w.i``, ``bot.b.i``, ``top.w.i``, ``top.b.i``).
    Tables draw ``N(0, 1/V)``, then the two MLPs, from ``generator``; on the
    ``meta`` device nothing is drawn."""

    def __init__(self, cfg: DLRMConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.tables = nn.ParameterList()
        for v in cfg.vocab_sizes:
            t = torch.empty((v, cfg.embed_dim), dtype=torch.float32,
                            device=device)
            if t.device.type != "meta":
                t.normal_(generator=generator).mul_(1.0 / math.sqrt(v))
            self.tables.append(nn.Parameter(t))
        kw = dict(generator=generator, device=device)
        self.bot = mlp_init([cfg.n_dense, *cfg.bot_mlp], **kw)
        self.top = mlp_init([cfg.n_interact + cfg.bot_mlp[-1], *cfg.top_mlp],
                            **kw)

    def forward(self, batch: dict, emb: torch.Tensor | None = None
                ) -> torch.Tensor:
        """Logits ``[B]`` of ``dense [B, n_dense]``, ``sparse int32 [B, F,
        K]`` (``-1`` padded)."""
        dtype = self.cfg.dtype
        dense = batch["dense"].to(dtype)
        z_bot = mlp_apply(self.bot, dense, final_act=True)  # [B, D]
        if emb is None:  # (the sharded step passes its own bags)
            emb = embed_bags(self.tables, batch["sparse"], dtype)  # [B, F, D]
        feats = torch.cat([z_bot[:, None, :], emb], dim=1)  # [B, F+1, D]
        inter = torch.bmm(feats, feats.transpose(1, 2))  # [B, F+1, F+1]
        f = feats.shape[1]
        iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
        z_int = inter[:, iu, ju]  # [B, n_interact]
        top_in = torch.cat([z_bot, z_int], dim=-1)
        logit = mlp_apply(self.top, top_in)  # [B, 1]
        return logit[:, 0]


def embed_bags(tables, sparse_idx: torch.Tensor, dtype) -> torch.Tensor:
    """sparse_idx int32 [B, F, K] (−1 padded) -> [B, F, D] summed bags.
    The ids are laid out field-major once, so each field's ``[B, K]`` is a
    contiguous int32 block, as the kernel takes it."""
    by_field = sparse_idx.to(torch.int32).permute(1, 0, 2).contiguous()
    outs = [embedding_bag_sum(table.to(dtype), by_field[f])
            for f, table in enumerate(tables)]
    return torch.stack(outs, dim=1)  # [B, F, D]


def loss_fn(model: DLRM, batch: dict,
            emb: torch.Tensor | None = None) -> torch.Tensor:
    """Mean numerically stable BCE-with-logits."""
    logit = model(batch, emb).float()
    y = batch["labels"].float()
    loss = torch.clamp(logit, min=0) - logit * y \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    return torch.mean(loss)


def retrieval_score(model: DLRM, batch: dict,
                    emb: torch.Tensor | None = None) -> torch.Tensor:
    """Score 1 query against N candidates: [N] logits via one GEMV.

    batch: dense [1, n_dense], sparse [1, F, K], cand [N, D] (item tower
    embeddings).  Two-tower style: user vector = bottom-MLP output combined
    with the mean sparse embedding, scored by dot product.
    """
    dtype = model.cfg.dtype
    z_bot = mlp_apply(model.bot, batch["dense"].to(dtype), final_act=True)
    if emb is None:
        emb = embed_bags(model.tables, batch["sparse"], dtype)  # [1, F, D]
    user = z_bot + torch.mean(emb, dim=1)  # [1, D]
    return batch["cand"].to(dtype) @ user[0]  # [N]
