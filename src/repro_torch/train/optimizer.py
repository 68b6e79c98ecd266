"""Hand-rolled AdamW + LR schedules + gradient clipping + int8 gradient
compression with error feedback, term for term the reference's in
float32 (no ``torch.optim``).

Trees are dicts of named tensors (a module's ``named_parameters()``); the
optimizer state holds one float32 tensor a parameter for each moment.  The
update runs under ``torch.no_grad`` and writes the parameters, moments and
residuals in place (the reference returns new arrays): at DLRM RM-2's
size a functional copy would add 14.7 GB of transient device memory.
Every row of every table is updated at every step (weight decay and both
moments' decay), as in the reference: no sparse or lazy Adam.

Compression: gradients can be quantized to int8 with a per-leaf scale and
an error-feedback residual carried in the optimizer state
(``grad_compress=True``).  The data-parallel mean (the reference's
``axis_name``) is an all-reduce over a process group, after the
compression, as the reference's ``pmean``.  A tree whose leaves are split
over the ranks of a group (explicit-SPMD row shards, ``shards``) is
clipped by the whole tree's norm and compressed with each whole leaf's
scale: those leaves' squares and absmax are reduced over the group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: dict[str, torch.Tensor]  # first moment, named like the params
    nu: dict[str, torch.Tensor]  # second moment
    err: dict[str, torch.Tensor] | None  # error-feedback residual or None


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # "cosine" | "linear" | "const"
    grad_compress: bool = False


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a float32 scalar on ``step``'s
    device)."""
    s = step.to(torch.float32)
    warm = torch.clamp((s + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "const":
        decay = 1.0
    else:
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps),
                           0.0, 1.0)
        if cfg.schedule == "linear":
            decay = 1.0 - frac
        else:  # cosine
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def adamw_init(params: dict[str, torch.Tensor], cfg: OptConfig) -> AdamWState:
    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    device = next(iter(params.values())).device if params else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros(), nu=zeros(),
                      err=zeros() if cfg.grad_compress else None)


def global_norm(tree: dict[str, torch.Tensor], shards=None) -> torch.Tensor:
    """The tree's L2 norm.  With ``shards = (group, names)`` each leaf of
    ``names`` holds this rank's part of a leaf split over ``group``: their
    squares are summed over the group, so every rank reads the norm of
    the whole tree."""
    def sq(keys):
        return sum(torch.sum(tree[k].float() ** 2) for k in keys)

    if shards is None:
        return torch.sqrt(sq(tree))
    import torch.distributed as dist

    group, names = shards
    dev = next(iter(tree.values())).device
    split = sq([k for k in tree if k in names]) + torch.zeros(
        (), dtype=torch.float32, device=dev)
    dist.all_reduce(split, group=group)
    return torch.sqrt(sq([k for k in tree if k not in names]) + split)


def compress_int8(g: torch.Tensor, err: torch.Tensor, group=None):
    """Quantize g+err to int8 with per-leaf absmax scale; return
    (quantized float value, new residual).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does.  With ``group`` (the leaf split over its
    ranks) the absmax is the whole leaf's."""
    t = g.float() + err
    top = torch.max(torch.abs(t))
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(top, min=1e-12) / 127.0
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, t - deq


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: AdamWState,
                 cfg: OptConfig, group=None, shards=None):
    """One AdamW step, in place: returns ``(params, new_state,
    grad_norm)``, ``params`` and the state's moment dicts being the same
    objects, updated.  With ``group`` (a process group: the reference's
    ``axis_name``) the gradients are averaged over its ranks after the
    compression, before the clipping.  With ``shards = (group, names)``
    the leaves of ``names`` are this rank's rows of leaves split over that
    group: the compression's scale and the clipping norm are the whole
    leaves' (:func:`global_norm`)."""
    s_group, s_names = shards if shards is not None else (None, ())
    if cfg.grad_compress:
        pairs = {k: compress_int8(g, state.err[k],
                                  s_group if k in s_names else None)
                 for k, g in grads.items()}
        grads = {k: pr[0] for k, pr in pairs.items()}
        for k, pr in pairs.items():
            state.err[k].copy_(pr[1])
    if group is not None:
        import torch.distributed as dist

        n = dist.get_world_size(group)
        grads = {k: g.clone() for k, g in grads.items()}
        for g in grads.values():
            dist.all_reduce(g, group=group)
            g.div_(n)
    # clip by global norm
    gn = global_norm(grads, shards)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)

    step = state.step + 1
    b1, b2 = cfg.betas
    lr = lr_at(cfg, state.step)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = state.mu[k], state.nu[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, AdamWState(step, state.mu, state.nu, state.err), gn
