"""DLRM's explicit-SPMD step: embedding tables row-sharded over ``model``,
the batch over the data-parallel axes (``param_specs`` / ``batch_specs``'s
recsys rules).

Each rank holds its own rows of every sharded table (a contiguous block,
``model`` rank ``m`` rows ``[m·R, (m+1)·R)``), the whole of the small
tables and of the MLPs, and its own rows of the batch.  A sharded table's
bag is looked up on the rank's rows only: an id outside them becomes
padding (``-1``, which the ``segment_gather`` kernel skips), an id past the
table's end stays with the last rank, whose kernel clamps it to the last
row, as the reference clamps.  The partial bags are summed over ``model``
(one all-reduce a table), whose backward hands each rank its own
cotangent unchanged, since every ``model`` rank runs the rest of the
forward on the same bags.  The loss and every gradient are then averaged
over the data-parallel axes and AdamW updates each rank's shards.  The
clipping norm (and, with ``grad_compress``, a sharded table's scale) is
the whole model's: the sharded tables' squares are summed over ``model``
(``adamw_update(shards=...)``), so every ``model`` rank scales the
replicated MLPs and small tables alike, as the reference's global clip
does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.autograd import embedding_bag_sum
from repro_torch.launch.mesh import dp_axes
from repro_torch.sharding.comm import mesh_scope, pmean_
from repro_torch.train.optimizer import OptConfig, adamw_update


class _SumOverRanks(torch.autograd.Function):
    """The sum over ``group``; the cotangent passes back unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sharded_tables(specs: dict, n_tables: int) -> list[bool]:
    """Which tables ``specs`` row-shards over ``model``."""
    return [specs[f"tables.{i}"][:1] == ("model",) for i in range(n_tables)]


def embed_bags_sharded(tables, sparse_idx: torch.Tensor, dtype,
                       sharded: list[bool], mesh) -> torch.Tensor:
    """:func:`repro_torch.models.recsys.dlrm.embed_bags` over this rank's
    table shards: ``[B_local, F, D]``, the same bags on every ``model``
    rank."""
    by_field = sparse_idx.to(torch.int32).permute(1, 0, 2).contiguous()
    m = mesh.get_local_rank("model")
    last = m == mesh.size(list(mesh.mesh_dim_names).index("model")) - 1
    group = mesh.get_group("model")
    outs = []
    for f, table in enumerate(tables):
        idx = by_field[f]
        if not sharded[f]:
            outs.append(embedding_bag_sum(table.to(dtype), idx))
            continue
        lo = m * table.shape[0]
        inside = idx >= lo
        if not last:
            inside &= idx < lo + table.shape[0]
        local = torch.where(inside, idx - lo, -1).to(torch.int32)
        part = embedding_bag_sum(table.to(dtype), local)
        outs.append(_SumOverRanks.apply(part, group))
    return torch.stack(outs, dim=1)


def make_sharded_step(model, mesh, specs: dict, kind: str,
                      opt_cfg: OptConfig | None = None):
    """The cell's step on this rank's shards: ``kind`` ``"train"`` gives
    ``step(model, opt_state, batch) -> (model, opt_state, metrics)``,
    ``"serve"`` ``step(model, batch) -> logits [B_local]``,
    ``"retrieval"`` ``step(model, batch) -> scores`` of this rank's
    candidates."""
    from repro_torch.models.recsys import dlrm
    from repro_torch.train.trainstep import value_and_grad

    sharded = sharded_tables(specs, len(model.tables))
    dp = dp_axes(mesh)
    names = {f"tables.{i}" for i, s in enumerate(sharded) if s}

    def bags(m, batch):
        return embed_bags_sharded(m.tables, batch["sparse"], m.cfg.dtype,
                                  sharded, mesh)

    if kind == "train":
        def loss(m, batch):
            return dlrm.loss_fn(m, batch, bags(m, batch))

        def train(m, opt_state, batch):
            with mesh_scope(mesh):
                lv, grads = value_and_grad(loss, m, batch)
                pmean_([lv, *grads.values()], dp)
            _, opt_state, gn = adamw_update(dict(m.named_parameters()),
                                            grads, opt_state, opt_cfg,
                                            shards=(mesh.get_group("model"),
                                                    names))
            return m, opt_state, {"loss": lv, "grad_norm": gn,
                                  "step": opt_state.step}

        return train

    @torch.no_grad()
    def serve(m, batch):
        if kind == "retrieval":
            return dlrm.retrieval_score(m, batch, bags(m, batch))
        return m(batch, bags(m, batch))

    return serve
