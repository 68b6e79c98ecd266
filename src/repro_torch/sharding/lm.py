"""The LM's DP+TP step on DTensors.

The reference shards its jitted train step with ``in_shardings`` from
``param_specs`` / ``opt_state_specs`` / ``batch_specs`` and lets GSPMD
partition the global computation.  Here the module's parameters, the
AdamW moments and the batch become DTensors placed by the same specs
(:func:`shard_module`, :func:`shard_opt_state`, :func:`shard_batch`), and
the port's own train step runs on them: each op's DTensor sharding rule
partitions it, and a plain tensor the model makes on the way (a mask, the
RoPE angles, the learning rate) counts as replicated
(``implicit_replication``).  The step computes the global loss and
gradients, so the data-parallel mean is part of it; the parameters and
moments are updated in place, each rank its own slices.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from repro_torch.sharding.specs import (batch_specs, distribute,
                                        opt_state_specs, param_specs)
from repro_torch.train.optimizer import AdamWState, OptConfig
from repro_torch.train.trainstep import make_train_step


def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    setattr(mod, leaf, nn.Parameter(value, requires_grad=True))


def shard_module(model: nn.Module, mesh) -> dict:
    """Replace each parameter of the LM ``model`` by a DTensor placed by
    its :func:`param_specs` spec (every rank holds the same full weights);
    returns the specs."""
    specs = param_specs(model, "lm", mesh)
    for name, p in list(model.named_parameters()):
        _set_param(model, name, distribute(p.detach(), mesh, specs[name]))
    return specs


def shard_opt_state(state: AdamWState, specs: dict, mesh) -> AdamWState:
    """The optimizer state with each moment placed by its parameter's
    spec (:func:`opt_state_specs`); the step stays a plain tensor."""
    ospec = opt_state_specs(specs, state)

    def tree(t, sp):
        return None if t is None else {k: distribute(v, mesh, sp[k])
                                       for k, v in t.items()}

    return AdamWState(state.step, tree(state.mu, ospec.mu),
                      tree(state.nu, ospec.nu), tree(state.err, ospec.err))


def shard_batch(batch: dict, mesh) -> dict:
    """A train cell's ``tokens`` / ``labels`` placed by
    :func:`batch_specs`."""
    specs = batch_specs("lm", "train", batch, mesh)
    return {k: distribute(torch.as_tensor(v), mesh, specs[k])
            for k, v in batch.items()}


def make_dp_tp_train_step(loss_fn: Callable, model: nn.Module,
                          opt_cfg: OptConfig):
    """``step(model, opt_state, batch)`` of :func:`make_train_step` on a
    model sharded by :func:`shard_module`, a state by
    :func:`shard_opt_state` and a batch by :func:`shard_batch`."""
    from torch.distributed.tensor.experimental import implicit_replication

    inner = make_train_step(loss_fn, model, opt_cfg)

    def step(params, opt_state, batch):
        with implicit_replication():
            return inner(params, opt_state, batch)

    return step
