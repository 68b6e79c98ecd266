"""Shared neural-net layers of the port (DLRM, GCN and the LMs).

Conventions, as in the reference's ``models/layers.py``:
  - weights are ``[in, out]`` and applied as ``x @ w`` (so carrying a
    reference weight across is a copy);
  - master dtype float32, cast to the compute dtype where used;
  - initializers draw from an explicit ``torch.Generator``;
  - activations may carry sharding hints via ``shard_hint``, which acts on
    a DTensor only.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn


def shard_hint(x: torch.Tensor, spec) -> torch.Tensor:
    """A DTensor ``x`` redistributed to ``spec``'s placements on its own
    mesh (``sharding.specs``); ``x`` as it is when ``spec`` is None, when
    ``x`` is a plain tensor (the reference's hint outside a mesh) or when
    ``spec`` names an axis the mesh lacks."""
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.specs import placements

    mesh = x.device_mesh
    for axis in spec:
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None and a not in mesh.mesh_dim_names:
                return x
    return x.redistribute(mesh, placements(tuple(spec), mesh))


def dense_init(in_dim: int, out_dim: int, scale: float | None = None, *,
               generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
    """``N(0, 1) · scale`` of shape ``[in, out]``, scale ``1/sqrt(in)`` by
    default."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    if w.device.type != "meta":
        w.normal_(generator=generator).mul_(scale)
    return w


def embed_init(vocab: int, dim: int, *,
               generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
    """``N(0, 1) · 0.02`` of shape ``[vocab, dim]``."""
    w = torch.empty((vocab, dim), dtype=torch.float32, device=device)
    if w.device.type != "meta":
        w.normal_(generator=generator).mul_(0.02)
    return w


# ------------------------------------------------------------------- norms
def _stats_dtype(dt: torch.dtype) -> torch.dtype:
    """Float32, or float64 for a float64 run (the reference has none)."""
    return torch.promote_types(dt, torch.float32)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Statistics in float32 (float64 for float64), the normalized value
    cast back to ``x``'s dtype, then times ``gamma`` in that dtype."""
    dt = x.dtype
    x32 = x.to(_stats_dtype(dt))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Statistics as :func:`rmsnorm`'s."""
    dt = x.dtype
    x32 = x.to(_stats_dtype(dt))
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * gamma.to(dt) + beta.to(dt)


# -------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 1e4) -> tuple[torch.Tensor, torch.Tensor]:
    """positions int [...]: returns (sin, cos) float32 with trailing dim
    head_dim/2; frequencies ``theta ** (-i / half)`` in float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Half-split rotation (not interleaved): x [..., H, D]; sin/cos
    broadcastable [..., 1, D/2], cast to ``x``'s dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin.to(x.dtype)
    cos = cos.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------- attention
def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0,
                  kv_len=None) -> torch.Tensor:
    """Grouped-query attention with a float32 softmax: q [B, S, Hq, D], k
    and v [B, T, Hkv, D].  The logits are computed in q's dtype, then
    cast to float32; masked logits are -1e30.

    ``q_offset``: absolute position of q[0] (decode: cache length).
    ``kv_len``: number of valid KV entries (decode with preallocated
    cache)."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k).float()
    logits = logits * (1.0 / math.sqrt(d))
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + q_offset
        kpos = torch.arange(t, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, -1e30)
    if kv_len is not None:
        valid = torch.arange(t, device=q.device) < kv_len
        logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, hq, d)


# ------------------------------------------------------------------- MLPs
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ w_gate.to(x.dtype)) * (
        x @ w_up.to(x.dtype))
    return h @ w_down.to(x.dtype)


def mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
        biases: Sequence[torch.Tensor] | None = None,
        act: Callable = torch.relu, final_act: bool = False) -> torch.Tensor:
    n = len(weights)
    for i, w in enumerate(weights):
        x = x @ w.to(x.dtype)
        if biases is not None:
            x = x + biases[i].to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


class MLP(nn.Module):
    """A stack of ``[in, out]`` layers: ``w`` (and ``b``) as parameter
    lists, so the state dict's names are ``w.i`` / ``b.i``, the reference
    pytree's ``{"w": [...], "b": [...]}``."""

    def __init__(self, dims: Sequence[int], with_bias: bool = True, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.w = nn.ParameterList()
        self.b = nn.ParameterList() if with_bias else None
        for i in range(len(dims) - 1):
            self.w.append(nn.Parameter(dense_init(
                dims[i], dims[i + 1], generator=generator, device=device)))
            if with_bias:
                self.b.append(nn.Parameter(torch.zeros(
                    dims[i + 1], dtype=torch.float32, device=device)))


def mlp_init(dims: Sequence[int], with_bias: bool = True, *,
             generator: torch.Generator | None = None, device=None) -> MLP:
    return MLP(dims, with_bias, generator=generator, device=device)


def mlp_apply(params: MLP, x, act: Callable = torch.relu,
              final_act: bool = False):
    return mlp(x, list(params.w),
               None if params.b is None else list(params.b), act=act,
               final_act=final_act)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore: int = -1) -> torch.Tensor:
    """Mean CE over non-ignored positions, in float32 (float64 for
    float64); logits [..., V], labels int [...]."""
    logits = logits.to(_stats_dtype(logits.dtype))
    # the label's logit keeps its last dimension until after the
    # subtraction: on vocabulary-sharded DTensor logits the gathered value
    # is a masked partial sum, which DTensor reduces only in that shape
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    ll = torch.gather(logits, -1, labels.long().clamp(min=0)[..., None])
    nll = (lse - ll)[..., 0]
    mask = (labels != ignore).to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
