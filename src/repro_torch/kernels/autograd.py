"""The embedding bag with its gradient: ``segment_gather``'s user in the
model zoo.

The reference's DLRM looks its bags up with ``jnp.take`` of the clipped
ids and a masked sum (``repro/models/recsys/dlrm.py:57``), the contract of
the fixed-hotness ``segment_gather`` kernel, and takes its gradient as
XLA's transpose of that: a dense scatter-add into a zero table.  Here the
forward is :func:`repro_torch.kernels.ops.segment_gather_fixed` (the CUDA
kernel on a card, its plain version on the CPU; one launch per table) and
the backward is plain torch, since the reference's gradient is no Pallas
kernel:

``d_table = zeros_like(table).index_add_(0, clamp(idx, max=V-1), d_out
rows)`` (dense, as JAX's is), padding's rows sent to a spare row ``V``
that the gradient leaves out (so no selection of the ids whose length
depends on their values), and with weights that need
a gradient ``d_w[s, k] = <table[idx[s, k]], d_out[s]>`` for ``idx >= 0``
(0 for padding).  Only ``idx`` (and the weights) are saved, never the
gathered rows.  On a card ``index_add_`` sums with float atomics, in an
order that changes from run to run, and a hot row (zipf-drawn ids put
about a fifth of a table's ids on one row) serializes them.
"""

from __future__ import annotations

import torch


class EmbeddingBagSum(torch.autograd.Function):
    """``out[s] = Σ_k w[s, k] · table[idx[s, k]]`` over ``idx int32 [S, K]``
    (``< 0``: padding; ``≥ V``: row ``V-1``), differentiable in ``table``
    and ``weights``."""

    @staticmethod
    def forward(ctx, table, idx, weights=None):
        ctx.save_for_backward(idx, weights,
                              table if weights is not None else None)
        ctx.v = table.shape[0]
        from repro_torch.kernels import ops  # (ops exports this class)

        return ops.segment_gather_fixed(table, idx, weights)

    @staticmethod
    def backward(ctx, d_out):
        idx, weights, table = ctx.saved_tensors
        keep = idx >= 0
        rows = idx.long().clamp(max=ctx.v - 1)
        d_table = d_w = None
        if ctx.needs_input_grad[0]:
            src = d_out[:, None, :]
            if weights is not None:
                src = src * weights.to(d_out.dtype)[:, :, None]
            src = src.expand(*idx.shape, d_out.shape[1])
            # rows [0, V) and a spare row V for padding, left out
            d_table = torch.zeros((ctx.v + 1, d_out.shape[1]),
                                  dtype=d_out.dtype, device=d_out.device)
            d_table.index_add_(0, torch.where(keep, rows, ctx.v).reshape(-1),
                               src.reshape(-1, d_out.shape[1]))
            d_table = d_table[:ctx.v]
        if weights is not None and ctx.needs_input_grad[2]:
            dots = torch.einsum("skd,sd->sk", table[rows.clamp(min=0)].to(
                d_out.dtype), d_out)
            d_w = torch.where(keep, dots, 0).to(weights.dtype)
        return d_table, None, d_w


def embedding_bag_sum(table: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """:class:`EmbeddingBagSum` applied: the fixed-hotness embedding bag
    with its gradient."""
    return EmbeddingBagSum.apply(table, idx, weights)
