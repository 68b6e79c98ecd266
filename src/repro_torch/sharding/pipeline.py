"""GPipe-style pipeline parallelism over the ``pod`` axis.

The layer stack is split into S = pod-axis-size stages: stage ``s`` runs
the layer modules ``[s·L/S, (s+1)·L/S)``, the split that the reference's
``P("pod")`` on its stacked layer dimension gives.  Microbatches stream
through the stages; activations move stage→stage with a differentiable
``ppermute`` each tick (M + S − 1 ticks total, the classic GPipe bubble),
whose backward sends the cotangents back a stage, so autograd runs the
reverse pipeline.

This is the dense-LM path (MoE layers keep EP over ``model`` instead of
PP, as in the reference).

Every rank holds the whole module (the same weights) and uses its stage's
layers; the loss is the same on every stage.  As inside ``shard_map``,
the final ``psum`` transposes to a ``psum``, so each stage's gradients
are S times its own contribution and their mean over the stages is the
dense gradient (:func:`make_pipeline_train_step` takes it).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models.transformer import (LMConfig, _rope, embed_tokens,
                                            logits_of, run_layers)
from repro_torch.sharding.comm import (axis_group, mesh_scope, pmean_,
                                       ppermute_next, psum)
from repro_torch.sharding.specs import mesh_dims


class _Anchor(torch.autograd.Function):
    """``x`` as it is; its backward gives zero cotangents to ``others``
    too.  Every rank's loss then leads back to every activation it sent,
    so every rank runs each transposed send (a collective with its
    neighbours) in the backward, as ``shard_map``'s SPMD transpose does,
    also where its own loss does not depend on what came back (stage 0
    never reads its buffer)."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.likes = [(o.shape, o.dtype, o.device) for o in others]
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.likes))


def stage_layers(model, stage: int, n_stages: int) -> list:
    """The layer modules of ``stage``."""
    layers = list(model.dense_layers)
    per = len(layers) // n_stages
    return layers[stage * per:(stage + 1) * per]


def pipelined_loss(model, batch: dict, cfg: LMConfig, *, n_stages: int,
                   n_microbatches: int, axis: str = "pod") -> torch.Tensor:
    """SPMD GPipe loss of the dense LM ``model`` on this rank's stage of
    the mesh axis ``axis`` (run under ``sharding.comm.mesh_scope``).

    batch: the full per-pod batch {"tokens","labels"} [B, T]; B split into
    microbatches here.  Stage 0 embeds microbatch i at tick i (indices
    clipped to the last); the other stages take the buffer the previous
    stage sent.  The last stage adds the loss of the microbatch that has
    just finished; the sum over the stages divided by M is returned on
    every stage."""
    if len(model.dense_layers) % n_stages or model.moe_layers:
        raise ValueError(f"{cfg.name}: {len(model.dense_layers)} dense "
                         f"layers do not split into {n_stages} stages")
    stage = torch.distributed.get_rank(axis_group(axis))
    layers = stage_layers(model, stage, n_stages)
    tokens, labels = batch["tokens"], batch["labels"]
    b, t = tokens.shape
    m = n_microbatches
    mb = b // m
    tok_mb = tokens.reshape(m, mb, t)
    lab_mb = labels.reshape(m, mb, t)
    device = model.embed.device

    sin, cos = _rope(torch.arange(t, dtype=torch.int32, device=device), cfg)
    n_ticks = m + n_stages - 1
    buf = torch.zeros((mb, t, cfg.d_model), dtype=cfg.dtype, device=device)
    loss_acc = torch.zeros((), dtype=torch.float32, device=device)
    sent = []
    for i in range(n_ticks):
        if stage == 0:  # ingests microbatch i (clipped)
            x = embed_tokens(model, tok_mb[min(i, m - 1)], cfg)
        else:
            x = buf
        y, _ = run_layers(x, layers, cfg, sin, cos)
        # last stage: the loss of the microbatch that has just completed
        if stage == n_stages - 1 and i >= n_stages - 1:
            loss_acc = loss_acc + cross_entropy_loss(
                logits_of(model, y, cfg), lab_mb[i - (n_stages - 1)])
        # ship activations to the next stage
        buf = ppermute_next(y, axis)
        sent.append(buf)
    # every stage returns the same loss: only the last stage contributed
    return psum(_Anchor.apply(loss_acc, *sent), axis) / m


def make_pipeline_train_step(model, cfg: LMConfig, opt_cfg, mesh,
                             n_microbatches: int = 4, axis: str = "pod"):
    """``step(model, opt_state, batch)``: the pipelined loss and its
    backward on this rank's stage, the gradients' mean over the stages
    (the dense gradient), then AdamW with the data-parallel mean over
    ``data`` when the mesh has it (``adamw_update(group=...)``), in place
    on every rank's whole module.  Returns ``(model, opt_state, {"loss",
    "grad_norm"})``."""
    from repro_torch.train.optimizer import adamw_update

    n_stages = mesh_dims(mesh)[axis]
    params = dict(model.named_parameters())

    def step(p, opt_state, batch):
        if p is not model:
            raise ValueError("a train step trains the model it was built for")
        with mesh_scope(mesh):
            loss = pipelined_loss(model, batch, cfg, n_stages=n_stages,
                                  n_microbatches=n_microbatches, axis=axis)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            grads = dict(zip(params, grads))
            pmean_(grads.values(), axis)
            group = (axis_group("data") if "data" in mesh.mesh_dim_names
                     else None)
        _, opt_state, gn = adamw_update(params, grads, opt_state, opt_cfg,
                                        group=group)
        return model, opt_state, {"loss": loss.detach(), "grad_norm": gn}

    return step
