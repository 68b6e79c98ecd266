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
``axis_name``) comes with the sharding slice.
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


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tree.values()))


def compress_int8(g: torch.Tensor, err: torch.Tensor):
    """Quantize g+err to int8 with per-leaf absmax scale; return
    (quantized float value, new residual).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    t = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(t)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, t - deq


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: AdamWState,
                 cfg: OptConfig, group=None):
    """One AdamW step, in place: returns ``(params, new_state,
    grad_norm)``, ``params`` and the state's moment dicts being the same
    objects, updated.  ``group`` (the reference's ``axis_name``: a
    data-parallel mean after compression) is not ported yet."""
    if group is not None:
        raise NotImplementedError(
            "the data-parallel gradient mean comes with the sharding slice")
    if cfg.grad_compress:
        pairs = {k: compress_int8(g, state.err[k]) for k, g in grads.items()}
        grads = {k: pr[0] for k, pr in pairs.items()}
        for k, pr in pairs.items():
            state.err[k].copy_(pr[1])
    # clip by global norm
    gn = global_norm(grads)
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
