"""Mixture-of-Experts block of the port: top-k routing with
capacity-bounded dispatch, as the reference's ``models/moe.py``.

Each token's ``k`` expert assignments are sorted by expert (a stable sort
of the token-major list), ranked within their expert and bounded by the
capacity ``C = max(1, ceil(T·k/E · capacity_factor))``; each expert runs
its three products on a ``[C, d]`` buffer, the stacked experts as one
batched product (``torch.bmm``).  Tokens past an expert's capacity are
dropped, and the Switch auxiliary loss keeps the router near uniform.

Every step is deterministic, so two runs (and a recompute under
``torch.utils.checkpoint``) give the same bits: the dispatch and the
combine move rows only by permutations and by gathers and scatters whose
indices are unique, and the combine sums each token's ``k`` products one
by one.  No ``index_add_`` and no atomics.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.models.layers import dense_init, swiglu


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_dense_layers: int = 0


def capacity(tokens: int, mcfg: MoEConfig) -> int:
    """Slots an expert has for ``tokens`` tokens (the reference's ``cap``)."""
    return max(1, int(math.ceil(tokens * mcfg.top_k / mcfg.n_experts
                                * mcfg.capacity_factor)))


class SharedExperts(nn.Module):
    """The ``n_shared`` always-on experts as one SwiGLU of width
    ``n_shared · d_ff_expert``."""

    def __init__(self, d_model: int, d_ff: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.w_gate = nn.Parameter(dense_init(d_model, d_ff, **kw))
        self.w_up = nn.Parameter(dense_init(d_model, d_ff, **kw))
        self.w_down = nn.Parameter(dense_init(d_ff, d_model, **kw))


def _expert_init(shape, fan_in: int, generator, device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if w.device.type != "meta":
        w.normal_(generator=generator).mul_(1.0 / math.sqrt(fan_in))
    return w


class MoE(nn.Module):
    """``router [d, E]`` (``dense_init`` at scale 0.02), the stacked
    experts ``w_gate`` / ``w_up [E, d, ff]`` and ``w_down [E, ff, d]``
    (normal over √fan-in), one ``Parameter`` each since every expert takes
    part in one product, and ``shared`` with ``n_shared > 0``."""

    def __init__(self, d_model: int, mcfg: MoEConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        e, ff = mcfg.n_experts, mcfg.d_ff_expert
        kw = dict(generator=generator, device=device)
        self.router = nn.Parameter(dense_init(d_model, e, scale=0.02, **kw))
        self.w_gate = nn.Parameter(_expert_init((e, d_model, ff), d_model,
                                                generator, device))
        self.w_up = nn.Parameter(_expert_init((e, d_model, ff), d_model,
                                              generator, device))
        self.w_down = nn.Parameter(_expert_init((e, ff, d_model), ff,
                                                generator, device))
        if mcfg.n_shared:
            self.shared = SharedExperts(d_model, mcfg.n_shared * ff, **kw)


def route(x: torch.Tensor, router: torch.Tensor, mcfg: MoEConfig):
    """The router's float32 probabilities ``[T, E]``, each token's top-k
    experts ``[T, k]`` (ties to the lower index, as ``jax.lax.top_k``: a
    stable descending sort) and their renormalized weights."""
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :mcfg.top_k], top_i[:, :mcfg.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_i, top_p


def moe_apply(moe: MoE, x: torch.Tensor, mcfg: MoEConfig):
    """x [T, d] -> (y [T, d] in x's dtype, aux loss float32 scalar).

    The assignments, token-major (token t's k experts at t·k .. t·k+k-1,
    best first), are sorted by expert with a stable sort; an assignment's
    rank is its place among its expert's.  Assignments of rank < C are
    kept.  **Overflow**: the reference scatters every assignment into its
    ``[E, C, d]`` buffer, a dropped one as a zero row at the clipped rank
    C - 1, and its scatter on the CPU applies the updates in order, so the
    last zero overwrites the kept row there: an expert whose count exceeds
    C keeps only C - 1 tokens, and the token of rank C - 1 gets a zero
    output from it and no gradient through it.  This reproduces that CPU
    result explicitly: slot C - 1 of such an expert stays empty.

    **Combine**: each token's k products, weighted, are brought back by
    the inverse permutation, in ascending expert order (the order in which
    the reference's scatter-add meets them), and summed one by one in the
    compute dtype starting from zero.  The shared experts come last.

    On DTensors (the DP+TP step, experts sharded over ``model``) the
    routed part runs per rank (:func:`_moe_sharded`)."""
    from torch.distributed.tensor import DTensor

    if isinstance(moe.w_gate, DTensor):
        y, aux = _moe_sharded(moe, x, mcfg)
    else:
        y, aux = _routed(x, moe.router, moe.w_gate, moe.w_up, moe.w_down,
                         mcfg, 0)
    if mcfg.n_shared:
        sp = moe.shared
        y = y + swiglu(x, sp.w_gate, sp.w_up, sp.w_down)
    return y, aux


def _moe_sharded(moe: MoE, x, mcfg: MoEConfig):
    """The routed experts on DTensors, with ``local_map``: DTensor has no
    rule for the dispatch's sort and scatter.  Every rank takes the whole
    token set (``x`` and the router replicated: the capacity and the
    ranks within an expert are global, as the plain step's) and its own
    ``model`` shard of the experts (gathered over the other axes), routes
    all tokens and runs its experts only (:func:`_routed` with an expert
    offset).  ``y`` is then a partial sum over ``model``, as is the aux
    loss, which only ``model`` rank 0 contributes (the gradients of ``x``
    and the router are partial over ``model`` too); both are then summed
    over ``model`` and replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = moe.w_gate.device_mesh
    names = list(mesh.mesh_dim_names)
    if "model" not in names:
        raise ValueError(f"a sharded MoE needs a 'model' mesh axis, got "
                         f"{names}")
    m = names.index("model")
    rep = [Replicate()] * mesh.ndim
    experts = [Shard(0) if i == m else Replicate() for i in range(mesh.ndim)]
    partial = [Partial() if i == m else Replicate() for i in range(mesh.ndim)]

    def local(x, router, w_gate, w_up, w_down):
        rank = mesh.get_local_rank("model")
        y, aux = _routed(x, router, w_gate, w_up, w_down, mcfg,
                         rank * w_gate.shape[0])
        return y, aux if rank == 0 else torch.zeros_like(aux)

    y, aux = local_map(
        local, out_placements=(partial, partial),
        in_placements=(rep, rep, experts, experts, experts),
        in_grad_placements=(partial, partial, experts, experts, experts),
        device_mesh=mesh, redistribute_inputs=True)(
            x, moe.router, moe.w_gate, moe.w_up, moe.w_down)
    # the sums over model, replicated (laid out as a token-flattened x
    # they could land as a strided shard, which DTensor's reshape back to
    # [B, S, d] mislays)
    return y.redistribute(mesh, rep), aux.redistribute(mesh, rep)


def _routed(x, router, w_gate, w_up, w_down, mcfg: MoEConfig, e0: int):
    """The routed experts' output and the aux loss (see
    :func:`moe_apply`), for experts ``e0 .. e0 + len(w_gate) - 1``: the
    routing and every rank within an expert are those of all ``E``
    experts; an assignment to another expert reads a zero row."""
    t, d = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    el = w_gate.shape[0]
    a = t * k
    cap = capacity(t, mcfg)
    dev = x.device

    probs, top_i, top_p = route(x, router, mcfg)

    # Switch aux loss: w · E · Σ_e f_e · p_e (f_e: the share of tokens
    # whose top-k holds e, from the integer counts)
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    experts = torch.arange(e, device=dev)
    estart = torch.searchsorted(se, experts)
    count = torch.searchsorted(se, experts, right=True) - estart
    fe = count.float() / t
    me = probs.mean(dim=0)
    aux = mcfg.router_aux_weight * e * torch.sum(fe * me)

    # dispatch: an expert over capacity keeps C - 1 (see moe_apply)
    rank = torch.arange(a, device=dev) - estart[se]
    room = torch.where(count > cap, cap - 1, cap)
    keep = rank < room[se]
    if el != e:
        keep = keep & (se >= e0) & (se < e0 + el)
    # each kept assignment's slot (e - e0)·C + rank; a dropped one (or one
    # of another rank's experts) gets a slot of its own past the buffer,
    # so every scatter index is unique
    dest = torch.where(keep, (se - e0) * cap + rank,
                       el * cap + torch.arange(a, device=dev))
    # the rows of the sorted assignments: each token repeated k times (its
    # gradient a sum over the k), then permuted
    xs = x[:, None].expand(t, k, d).reshape(a, d)[order]
    buf = x.new_zeros((el * cap + a, d)).index_put((dest,), xs)
    buf = buf[:el * cap].view(el, cap, d)

    dt = x.dtype
    h = torch.bmm(buf, w_gate.to(dt))
    h = torch.nn.functional.silu(h) * torch.bmm(buf, w_up.to(dt))
    h = torch.bmm(h, w_down.to(dt))

    # combine: h back to the sorted assignments (a dropped one reads a
    # zero row of its own), weighted, then to each token in ascending
    # expert order (a stable sort of the sorted list by token), summed
    # one at a time from zero
    h = torch.cat([h.view(el * cap, d), h.new_zeros((a, d))])
    sw = top_p.reshape(-1)[order]
    gathered = h[dest] * sw[:, None].to(dt)
    by_token = torch.argsort(order // k, stable=True)
    per_token = gathered[by_token].view(t, k, d)
    y = x.new_zeros((t, d))
    for j in range(k):
        y = y + per_token[:, j]
    return y, aux
