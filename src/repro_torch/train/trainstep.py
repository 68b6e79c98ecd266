"""Train and eval steps: loss and gradients by autograd + AdamW (+
microbatch gradient accumulation in a loop, the reference's
``lax.scan``) around a family loss function."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch.train.optimizer import OptConfig, adamw_update


def named_params(model) -> dict[str, torch.Tensor]:
    """A module's parameters by name (a dict of tensors is its own)."""
    if isinstance(model, nn.Module):
        return dict(model.named_parameters())
    return dict(model)


def batch_to(batch: dict, device) -> dict:
    """Each array or tensor of ``batch`` as a tensor on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else torch.as_tensor(v)
                ).to(device)
            for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, model, batch: dict):
    """``(loss, grads)`` of ``loss_fn(model, batch)``: the loss detached,
    the gradients by parameter name."""
    params = named_params(model)
    loss = loss_fn(model, batch)
    # a parameter off the loss's path gets zeros, as jax.grad gives it
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


def make_train_step(
    loss_fn: Callable,  # (model, batch) -> scalar
    model,  # the nn.Module (or dict of leaf tensors) the step trains
    opt_cfg: OptConfig,
    microbatches: int = 1,
    group=None,
):
    """Returns step(model, opt_state, batch) -> (model, opt_state, metrics),
    updating ``model``'s parameters in place.  The batch (numpy or tensors)
    moves to the parameters' device first.

    ``microbatches > 1``: the batch's leading dim is split and float32
    gradients are accumulated over the pieces, then divided by their
    number (as is the loss).
    """
    device = next(iter(named_params(model).values())).device

    def step(params, opt_state, batch):
        if params is not model:
            raise ValueError("a train step trains the model it was built for")
        batch = batch_to(batch, device)
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, model, batch)
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=device)
                     for k, p in named_params(model).items()}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(microbatches):
                one = {k: x.reshape((microbatches, x.shape[0] // microbatches)
                                    + tuple(x.shape[1:]))[i]
                       for k, x in batch.items()}
                l, g = value_and_grad(loss_fn, model, one)
                for k, gk in g.items():
                    grads[k] += gk
                loss = loss + l
            grads = {k: g / microbatches for k, g in grads.items()}
            loss = loss / microbatches
        _, opt_state, gnorm = adamw_update(named_params(model), grads,
                                           opt_state, opt_cfg, group=group)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "step": opt_state.step}
        return model, opt_state, metrics

    return step


def make_eval_step(loss_fn: Callable, model):
    device = next(iter(named_params(model).values())).device

    @torch.no_grad()
    def step(params, batch):
        if params is not model:
            raise ValueError("an eval step evaluates the model it was built "
                             "for")
        return loss_fn(model, batch_to(batch, device))

    return step
