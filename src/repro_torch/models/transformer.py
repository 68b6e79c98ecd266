"""Decoder-only LM of the port: dense GQA (Qwen2, Qwen3, Minitron), MLA
(DeepSeek-V2) and MoE layers (DeepSeek-V2, DBRX), a training forward with
full causal attention and a decode step against a preallocated KV cache;
MLA decodes in the *absorbed* form (the cache holds the compressed
``c_kv`` and the shared RoPE key, 576 values a token and layer at
DeepSeek-V2's widths).

``TransformerLM`` holds one module a layer (``dense_layers.{i}``, then
``moe_layers.{i}``), where the reference stacks each leaf over the layers
and scans them: a stacked ``Parameter`` would have autograd build a
gradient of the whole stack for every layer's slice.
``convert.params_from_jax`` splits the reference's stacks.  The layer
loop is a Python loop, so ``LMConfig.unroll_layers`` changes nothing
here.  ``act_spec`` / ``logits_spec`` (specs of ``sharding.specs``)
redistribute the activations and the logits where the reference places
its ``shard_hint``, on a model sharded with DTensors
(``sharding.lm``); on plain tensors they do nothing.

Numerics follow the reference's functions term for term: the attention
logits are bf16 products summed in float32 (``preferred_element_type``),
masked with the accumulation dtype's most negative value, and the softmax
is written out (max and sum in float32, ``exp`` in the accumulation
dtype); the embedding is cast to the compute dtype before it is gathered,
so a repeated token's gradient accumulates in that dtype.

MLA's full attention runs through the same ``_gqa`` (one KV head a query
head, the RoPE key broadcast over the heads); its absorbed decode keeps
the reference's own numerics (two logits products each rounded to the
compute dtype and added in it, a -1e30 mask, a float32 softmax).
``remat_policy="dots"`` saves the products without batch dimensions in
the forward and recomputes the rest of a layer in the backward (the
reference's ``dots_with_no_batch_dims_saveable``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (apply_rope, cross_entropy_loss,
                                       dense_init, embed_init, rmsnorm,
                                       rope_angles, shard_hint, swiglu)
from repro_torch.models.moe import MoE, MoEConfig, moe_apply


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    qkv_bias: bool = False
    attn: str = "gqa"  # "gqa" | "mla"
    # MLA geometry (DeepSeek-V2)
    q_lora: int = 0
    kv_lora: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    rope_theta: float = 1e4
    moe: MoEConfig | None = None
    remat: bool = True
    # remat policy: "full" (recompute each layer in the backward) or
    # "dots" (save the products without batch dimensions, recompute the
    # rest)
    remat_policy: str = "full"
    # keep attention logits in float32 (stable softmax) or in the compute
    # dtype (max and sum still in float32)
    attn_fp32_logits: bool = True
    compute_dtype: str = "bfloat16"
    # no effect in the port (the layer loop is a Python loop)
    unroll_layers: bool = False
    # sharding hints (specs over [batch, seq, model_dim] and the logits):
    # they place DTensor activations, and do nothing on plain tensors
    act_spec: Any = None
    logits_spec: Any = None

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def _counts(self) -> tuple[int, int]:
        """(total, active) parameters of the analytic count (for 6·N·D
        accounting): projections and the embedding and head, no norms or
        biases."""
        d, v = self.d_model, self.vocab
        if self.attn == "mla":
            qk = self.nope_head_dim + self.rope_head_dim
            attn = (d * self.q_lora + self.q_lora * self.n_heads * qk
                    + d * self.kv_lora + d * self.rope_head_dim
                    + self.kv_lora * self.n_heads * self.nope_head_dim
                    + self.kv_lora * self.n_heads * self.v_head_dim
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = d * self.n_heads * self.d_head * 2 \
                + d * self.n_kv_heads * self.d_head * 2
        if self.moe is None:
            n = self.n_layers * (attn + 3 * d * self.d_ff) + 2 * v * d
            return n, n
        m = self.moe
        ff_active = 3 * d * m.d_ff_expert * (m.top_k + m.n_shared)
        ff_total = 3 * d * m.d_ff_expert * (m.n_experts + m.n_shared) \
            + d * m.n_experts
        nd = m.first_dense_layers
        head = self.n_layers * attn + nd * 3 * d * self.d_ff + 2 * v * d
        return (head + (self.n_layers - nd) * ff_total,
                head + (self.n_layers - nd) * ff_active)

    def param_count(self) -> int:
        return self._counts()[0]

    def active_param_count(self) -> int:
        return self._counts()[1]


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------


class Attention(nn.Module):
    """``wq wk wv wo`` as ``[in, out]``, ``bq bk bv`` with ``qkv_bias``,
    ``q_norm k_norm`` (RMSNorm gains over a head) with ``qk_norm``."""

    def __init__(self, cfg: LMConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        kw = dict(generator=generator, device=device)
        self.wq = nn.Parameter(dense_init(d, hq * dh, **kw))
        self.wk = nn.Parameter(dense_init(d, hkv * dh, **kw))
        self.wv = nn.Parameter(dense_init(d, hkv * dh, **kw))
        self.wo = nn.Parameter(dense_init(hq * dh, d, **kw))
        if cfg.qkv_bias:
            for name, n in (("bq", hq * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
                setattr(self, name, nn.Parameter(torch.zeros(
                    n, dtype=torch.float32, device=device)))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(
                torch.ones(dh, dtype=torch.float32, device=device))
            self.k_norm = nn.Parameter(
                torch.ones(dh, dtype=torch.float32, device=device))


class SwiGLU(nn.Module):
    def __init__(self, cfg: LMConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.w_gate = nn.Parameter(dense_init(cfg.d_model, cfg.d_ff, **kw))
        self.w_up = nn.Parameter(dense_init(cfg.d_model, cfg.d_ff, **kw))
        self.w_down = nn.Parameter(dense_init(cfg.d_ff, cfg.d_model, **kw))


class MLAAttention(nn.Module):
    """Multi-head latent attention (DeepSeek-V2), all ``[in, out]``:
    ``w_dq [d, q_lora]``, ``q_ln``, ``w_uq [q_lora, H·(dn + dr)]``,
    ``w_dkv [d, kv_lora]``, ``kv_ln``, ``w_uk [kv_lora, H·dn]``, ``w_uv
    [kv_lora, H·dv]``, ``w_kr [d, dr]`` (the RoPE key shared by the heads)
    and ``wo [H·dv, d]``."""

    def __init__(self, cfg: LMConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qk = cfg.nope_head_dim + cfg.rope_head_dim
        kw = dict(generator=generator, device=device)

        def ones(n):
            return nn.Parameter(torch.ones(n, dtype=torch.float32,
                                           device=device))

        self.w_dq = nn.Parameter(dense_init(d, cfg.q_lora, **kw))
        self.q_ln = ones(cfg.q_lora)
        self.w_uq = nn.Parameter(dense_init(cfg.q_lora, h * qk, **kw))
        self.w_dkv = nn.Parameter(dense_init(d, cfg.kv_lora, **kw))
        self.kv_ln = ones(cfg.kv_lora)
        self.w_uk = nn.Parameter(dense_init(cfg.kv_lora,
                                            h * cfg.nope_head_dim, **kw))
        self.w_uv = nn.Parameter(dense_init(cfg.kv_lora,
                                            h * cfg.v_head_dim, **kw))
        self.w_kr = nn.Parameter(dense_init(d, cfg.rope_head_dim, **kw))
        self.wo = nn.Parameter(dense_init(h * cfg.v_head_dim, d, **kw))


class Layer(nn.Module):
    """``ln1``, ``ln2``, ``attn`` (GQA or MLA), then ``mlp`` (SwiGLU) or,
    with ``use_moe``, ``moe``."""

    def __init__(self, cfg: LMConfig, use_moe: bool = False, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ln1 = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device))
        self.ln2 = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device))
        self.attn = (MLAAttention if cfg.attn == "mla" else Attention)(
            cfg, **kw)
        if use_moe:
            self.moe = MoE(cfg.d_model, cfg.moe, **kw)
        else:
            self.mlp = SwiGLU(cfg, **kw)


class TransformerLM(nn.Module):
    """The LM: ``embed [V, d]``, ``dense_layers.{i}``, then (with ``moe``)
    ``moe_layers.{i}`` (``ln1``, ``ln2``, ``attn.*``, ``mlp.*`` or
    ``moe.*``), ``final_ln``, ``lm_head [d, V]`` (untied), float32 master
    weights drawn from ``generator``."""

    def __init__(self, cfg: LMConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.embed = nn.Parameter(embed_init(cfg.vocab, cfg.d_model, **kw))
        self.final_ln = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device))
        self.lm_head = nn.Parameter(dense_init(cfg.d_model, cfg.vocab, **kw))
        # with moe, the first first_dense_layers layers are dense
        nd = cfg.n_layers if cfg.moe is None else cfg.moe.first_dense_layers
        self.dense_layers = nn.ModuleList(
            Layer(cfg, **kw) for _ in range(nd))
        self.moe_layers = nn.ModuleList(
            Layer(cfg, use_moe=True, **kw) for _ in range(cfg.n_layers - nd))

    def layers(self) -> list[Layer]:
        """Every layer in order (the cache's layer index)."""
        return [*self.dense_layers, *self.moe_layers]

    def forward(self, tokens: torch.Tensor):
        return forward(self, tokens)


# --------------------------------------------------------------------------
# attention (training / prefill path)
# --------------------------------------------------------------------------


def _heads(t, n: int, dh: int):
    """``t [B, S, n·dh]`` as ``[B, S, n, dh]``.  A DTensor sharded on its
    last dimension over mesh dimensions whose size does not divide ``n``
    (12 heads over 16 ranks) is replicated over them first: DTensor splits
    a sharded dimension only evenly."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    b, s, _ = t.shape
    if isinstance(t, DTensor):
        last = Shard(t.ndim - 1)
        ways = math.prod(t.device_mesh.size(i)
                         for i, p in enumerate(t.placements) if p == last)
        if n % ways:
            t = t.redistribute(t.device_mesh, [
                Replicate() if p == last else p for p in t.placements])
    return t.reshape(b, s, n, dh)


def _merge_heads(out):
    """``out [B, S, H, D]`` as ``[B, S, H·D]``.  On a DTensor the merged
    tensor is redistributed to its own placements: a no-op forward, whose
    backward brings the cotangent (sharded on ``H·D`` by a row-parallel
    product) back to them before the merge's backward splits the heads,
    which DTensor refuses where the shards do not divide ``H``."""
    from torch.distributed.tensor import DTensor

    b, s = out.shape[:2]
    flat = out.reshape(b, s, -1)
    if isinstance(flat, DTensor):
        flat = flat.redistribute(flat.device_mesh, flat.placements)
    return flat


def _project(x, attn: Attention, cfg: LMConfig, sin, cos):
    """q [B, S, Hq, D], k and v [B, S, Hkv, D]: projections, biases,
    qk-norm, then RoPE on q and k."""
    b, s, _ = x.shape
    q = x @ attn.wq.to(x.dtype)
    k = x @ attn.wk.to(x.dtype)
    v = x @ attn.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + attn.bq.to(x.dtype)
        k = k + attn.bk.to(x.dtype)
        v = v + attn.bv.to(x.dtype)
    q = _heads(q, cfg.n_heads, cfg.d_head)
    k = _heads(k, cfg.n_kv_heads, cfg.d_head)
    v = _heads(v, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(q, attn.q_norm)
        k = rmsnorm(k, attn.k_norm)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _attention_full(x, attn, cfg: LMConfig, sin, cos):
    b, s, _ = x.shape
    if cfg.attn == "mla":
        return _mla_full(x, attn, cfg, sin, cos)
    q, k, v = _project(x, attn, cfg, sin, cos)
    out = _attend(q, k, v, fp32_logits=cfg.attn_fp32_logits)
    return _merge_heads(out) @ attn.wo.to(x.dtype)


def _attend(q, k, v, fp32_logits: bool = True, causal: bool = True,
            kv_len=None):
    """:func:`_gqa` (causal on the training path; the decode step passes
    ``causal=False`` and ``kv_len``).  On DTensors (the DP+TP step and
    the dry run's decode) it runs on each rank's own batch rows and heads
    (``local_map``): attention is independent across both, and DTensor
    has no rule for the batched product's fold of a batch dimension and a
    head dimension sharded over different mesh axes.  A placement other
    than the batch (dim 0) or the heads (dim 2, when the KV heads divide
    over it, so each rank's query heads find their KV heads) is
    replicated first."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return _gqa(q, k, v, causal=causal, kv_len=kv_len,
                    fp32_logits=fp32_logits)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    heads = math.prod(mesh.size(i) for i, p in enumerate(q.placements)
                      if p == Shard(2))
    keep = (Shard(0), Shard(2)) if k.shape[2] % heads == 0 else (Shard(0),)
    pl = [p if p in keep else Replicate() for p in q.placements]
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))

    def local(q, k, v):
        return _gqa(q, k, v, causal=causal, kv_len=kv_len,
                    fp32_logits=fp32_logits)

    return local_map(local, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=mesh)(q, k, v)


def _gqa(q, k, v, causal: bool = True, q_offset: int = 0, kv_len=None,
         fp32_logits: bool = True):
    """GQA with possibly different v head dim: q [B, S, Hq, Dqk], k [B, T,
    Hkv, Dqk], v [B, T, Hkv, Dv] -> [B, S, Hq, Dv].

    The logits are products of q's dtype summed in float32 (at least),
    then held in ``acc`` (float32, or q's dtype without
    ``fp32_logits``); masked entries get ``acc``'s most negative value.
    The softmax takes its max and sum in float32 and ``exp`` in ``acc``.
    The group of query heads sharing a KV head rides in the row dimension
    of one product a KV head (the reference's ``bhgst`` logits laid out as
    ``[B, Hkv, S, G, T]``), so no KV head is repeated."""
    b, s, hq, dqk = q.shape
    t, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    acc = torch.float32 if fp32_logits else q.dtype
    wide = torch.promote_types(q.dtype, torch.float32)
    qh = q.reshape(b, s, hkv, g, dqk).transpose(1, 2).reshape(
        b, hkv, s * g, dqk)
    kh = k.transpose(1, 2)  # [B, Hkv, T, D]
    logits = torch.matmul(qh.to(wide), kh.to(wide).transpose(-1, -2))
    logits = logits.to(acc).view(b, hkv, s, g, t)
    # the scale rounded to acc first, as the reference's jnp.asarray
    logits = logits * torch.tensor(1.0 / math.sqrt(dqk), dtype=acc)
    neg = torch.finfo(acc).min
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + q_offset
        kpos = torch.arange(t, device=q.device)[None, :]
        logits = torch.where((kpos <= qpos)[:, None, :], logits, neg)
    if kv_len is not None:
        logits = torch.where(torch.arange(t, device=q.device) < kv_len,
                             logits, neg)
    m = logits.to(wide).amax(dim=-1, keepdim=True)
    ex = torch.exp(logits - m.to(acc))
    del logits  # the softmax's peak holds two [.., S, T] tensors, not three
    denom = ex.to(wide).sum(dim=-1, keepdim=True)
    probs = (ex / denom.to(acc)).to(v.dtype)
    del ex
    out = torch.matmul(probs.view(b, hkv, s * g, t), v.transpose(1, 2))
    return out.view(b, hkv, s, g, dv).permute(0, 2, 1, 3, 4).reshape(
        b, s, hq, dv)


def _mla_queries(x, attn: MLAAttention, cfg: LMConfig, sin, cos):
    """q_nope [B, S, H, dn] and q_rope [B, S, H, dr] (RoPE applied)."""
    b, s, _ = x.shape
    dn = cfg.nope_head_dim
    cq = rmsnorm(x @ attn.w_dq.to(x.dtype), attn.q_ln)
    q = (cq @ attn.w_uq.to(x.dtype)).reshape(
        b, s, cfg.n_heads, dn + cfg.rope_head_dim)
    return q[..., :dn], apply_rope(q[..., dn:], sin, cos)


def _mla_latent(x, attn: MLAAttention, cfg: LMConfig, sin, cos):
    """The cache's two entries of ``x``: c_kv [B, S, kv_lora] (normed) and
    the shared RoPE key [B, S, dr]."""
    b, s, _ = x.shape
    ckv = rmsnorm(x @ attn.w_dkv.to(x.dtype), attn.kv_ln)
    kr = (x @ attn.w_kr.to(x.dtype)).reshape(b, s, 1, cfg.rope_head_dim)
    return ckv, apply_rope(kr, sin, cos).reshape(b, s, cfg.rope_head_dim)


def _mla_full(x, attn: MLAAttention, cfg: LMConfig, sin, cos):
    """MLA's training / prefill attention: keys and values expanded from
    c_kv a head, the RoPE key broadcast over the heads, then ``_gqa`` with
    one KV head a query head (scale 1/√(dn + dr))."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _mla_queries(x, attn, cfg, sin, cos)
    ckv, k_rope = _mla_latent(x, attn, cfg, sin, cos)
    k_nope = (ckv @ attn.w_uk.to(x.dtype)).reshape(b, s, h, dn)
    v = (ckv @ attn.w_uv.to(x.dtype)).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, dr)], dim=-1)
    out = _attend(q, k, v, fp32_logits=cfg.attn_fp32_logits)
    return out.reshape(b, s, h * dv) @ attn.wo.to(x.dtype)


# --------------------------------------------------------------------------
# forward / loss
# --------------------------------------------------------------------------


def _ffn(h, mlp: SwiGLU):
    return swiglu(h, mlp.w_gate, mlp.w_up, mlp.w_down)


def _tokens(h):
    """``h [B, S, d]`` as the MoE's ``[B·S, d]``.  A DTensor keeps only its
    batch sharding (the rest replicated, a partial sum reduced), and the
    flattened tensor is redistributed to its own placements: a no-op
    forward whose backward brings the cotangent back to them before the
    flatten's backward, which DTensor mislays for a token dimension
    sharded over two mesh axes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    b, s, d = h.shape
    if not isinstance(h, DTensor):
        return h.reshape(b * s, d)
    mesh = h.device_mesh
    h = h.redistribute(mesh, [p if p == Shard(0) else Replicate()
                              for p in h.placements])
    t = h.reshape(b * s, d)
    return t.redistribute(mesh, t.placements)


def _tokens_back(y, b: int, s: int):
    """The MoE's ``y [B·S, d]`` as ``[B, S, d]``.  A DTensor is replicated
    first: its token dimension may be sharded over two mesh axes (a
    partial sum reduce-scattered by the shared experts' product), which
    DTensor's reshape to ``[B, S, d]`` mislays."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(y, DTensor):
        y = y.redistribute(y.device_mesh, [Replicate()] * y.device_mesh.ndim)
    return y.reshape(b, s, y.shape[-1])


def _mix(h, layer: Layer, cfg: LMConfig):
    """The layer's feed-forward on h [B, S, d]: (y, aux), the MoE over the
    B·S tokens, or the SwiGLU with a float32 zero aux."""
    if hasattr(layer, "moe"):
        b, s, d = h.shape
        y, aux = moe_apply(layer.moe, _tokens(h), cfg.moe)
        return _tokens_back(y, b, s), aux
    return _ffn(h, layer.mlp), torch.zeros((), dtype=torch.float32,
                                           device=h.device)


def _layer_fwd(x, layer: Layer, cfg: LMConfig, sin, cos):
    x = x + shard_hint(_attention_full(rmsnorm(x, layer.ln1), layer.attn,
                                       cfg, sin, cos), cfg.act_spec)
    y, aux = _mix(rmsnorm(x, layer.ln2), layer, cfg)
    return x + shard_hint(y, cfg.act_spec), aux


def _embed(table, tokens):
    """``table[tokens]``.  A DTensor table (the DP+TP step) is gathered
    whole first (its gradient reduce-scattered back), then looked up with
    ``F.embedding``: the same values, where DTensor's rules for a gather
    from vocabulary shards (a masked partial sum) and for the indexing's
    ``index_put`` backward fail in some torch releases."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(table, DTensor):
        whole = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
        return torch.nn.functional.embedding(tokens, whole)
    return table[tokens]


def _rope(positions, cfg: LMConfig):
    """sin, cos [1, S, 1, D/2] at the RoPE width: ``rope_head_dim`` for
    MLA (only the RoPE part of a head rotates), ``d_head`` otherwise."""
    dim = cfg.rope_head_dim if cfg.attn == "mla" else cfg.d_head
    sin, cos = rope_angles(positions, dim, cfg.rope_theta)
    return sin[None, :, None, :], cos[None, :, None, :]


def embed_tokens(model: TransformerLM, tokens: torch.Tensor, cfg: LMConfig):
    """tokens int [B, S] -> their embeddings [B, S, D] in the compute
    dtype, placed by ``act_spec``."""
    # cast, then gather: a repeated token's gradient accumulates in the
    # compute dtype, as the reference's gather transposes
    return shard_hint(_embed(model.embed.to(cfg.dtype), tokens.long()),
                      cfg.act_spec)


# the products without batch dimensions, which ``remat_policy="dots"``
# saves (an ``x @ w`` of the layer reaches the dispatcher as one of them)
_DOTS = ("mm", "addmm")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if getattr(op, "_opname", None) in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


def run_layers(x, layers, cfg: LMConfig, sin, cos):
    """``layers`` in turn on ``x`` -> (x, the sum of their MoE aux losses,
    float32).  With ``cfg.remat`` and gradients enabled each layer is
    recomputed in the backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``; the MoE dispatch is deterministic, so
    the recompute routes as the first forward did); with
    ``remat_policy="dots"`` the products without batch dimensions are
    saved and only the rest is recomputed."""
    remat = cfg.remat and torch.is_grad_enabled()
    kw = {"context_fn": _dots_context} if cfg.remat_policy == "dots" else {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in layers:
        if remat:
            x, a = checkpoint(_layer_fwd, x, layer, cfg, sin, cos,
                              use_reentrant=False, **kw)
        else:
            x, a = _layer_fwd(x, layer, cfg, sin, cos)
        aux = aux + a
    return x, aux


def logits_of(model: TransformerLM, x, cfg: LMConfig):
    """The final norm and the LM head: logits [B, S, V] in ``x``'s dtype,
    placed by ``logits_spec``."""
    x = rmsnorm(x, model.final_ln)
    return shard_hint(x @ model.lm_head.to(x.dtype), cfg.logits_spec)


def forward(model: TransformerLM, tokens: torch.Tensor):
    """tokens int [B, S] -> (logits [B, S, V] in the compute dtype, aux
    loss: float32, the sum of the MoE layers' load-balance terms, zero
    without MoE)."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, cfg)
    sin, cos = _rope(torch.arange(tokens.shape[1], dtype=torch.int32,
                                  device=x.device), cfg)
    x, aux = run_layers(x, model.layers(), cfg, sin, cos)
    return logits_of(model, x, cfg), aux


def loss_fn(model: TransformerLM, batch: dict) -> torch.Tensor:
    logits, aux = forward(model, batch["tokens"])
    return cross_entropy_loss(logits, batch["labels"]) + aux


# --------------------------------------------------------------------------
# decode (serving) path
# --------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> dict:
    """Preallocated cache, layer-stacked as the reference's (the dense
    layers first, then the MoE layers), in the compute dtype: GQA's ``k``
    and ``v`` ``[L, B, max_len, Hkv, D]``; MLA's ``ckv [L, B, max_len,
    kv_lora]`` and ``krope [L, B, max_len, rope_head_dim]``; ``pos`` an
    int32 scalar (the next position to write)."""
    lead = (cfg.n_layers, batch, max_len)
    if cfg.attn == "mla":
        shapes = {"ckv": lead + (cfg.kv_lora,),
                  "krope": lead + (cfg.rope_head_dim,)}
    else:
        shapes = {n: lead + (cfg.n_kv_heads, cfg.d_head) for n in ("k", "v")}
    cache = {n: torch.zeros(sh, dtype=cfg.dtype, device=device)
             for n, sh in shapes.items()}
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def _write(cache_layer, new, pos: int):
    """Writes ``new [B, s, ...]`` into a layer's cache slice in place at
    ``pos``, clamped so that the ``s`` entries fit (as
    ``dynamic_update_slice`` clamps)."""
    s = new.shape[1]
    start = max(0, min(pos, cache_layer.shape[1] - s))
    cache_layer[:, start:start + s] = new


def _gqa_decode(x, attn: Attention, cfg: LMConfig, cache_k, cache_v,
                pos: int, sin, cos):
    """Writes the step's k and v into the layer's cache slices in place at
    ``pos`` (``_write``), then attends over the whole cache with the first
    ``pos + s`` entries valid and no causal mask."""
    b, s, _ = x.shape
    q, k, v = _project(x, attn, cfg, sin, cos)
    _write(cache_k, k, pos)
    _write(cache_v, v, pos)
    out = _attend(q, cache_k, cache_v, causal=False, kv_len=pos + s,
                  fp32_logits=cfg.attn_fp32_logits)
    return _merge_heads(out) @ attn.wo.to(x.dtype)


def _mla_decode(x, attn: MLAAttention, cfg: LMConfig, cache_ckv, cache_kr,
                pos: int, sin, cos):
    """Absorbed MLA decode: attention runs in the compressed c_kv space.
    The step's c_kv and RoPE key are written into the layer's cache in
    place at ``pos`` (``_write``); ``W_uk`` is absorbed into the query
    (``q_abs = q_nope · W_uk``) and ``W_uv`` applied after the context.
    As the reference: the logits ``q_abs·c_kv + q_rope·k_rope`` are two
    products each rounded to the compute dtype and added in it, then made
    float32 and divided by √(dn + dr); entries at ``pos + s`` and past are
    masked with -1e30 (no causal mask inside a chunk); the softmax is
    float32, its probabilities cast to the compute dtype."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    c = cfg.kv_lora
    q_nope, q_rope = _mla_queries(x, attn, cfg, sin, cos)
    ckv_new, kr_new = _mla_latent(x, attn, cfg, sin, cos)
    _write(cache_ckv, ckv_new, pos)
    _write(cache_kr, kr_new, pos)
    w_uk = attn.w_uk.to(x.dtype).reshape(c, h, dn)
    q_abs = torch.einsum("bshn,chn->bshc", q_nope, w_uk)
    logits = (torch.einsum("bshc,btc->bhst", q_abs, cache_ckv)
              + torch.einsum("bshr,btr->bhst", q_rope, cache_kr))
    logits = logits.float() / math.sqrt(dn + dr)
    t = cache_ckv.shape[1]
    valid = torch.arange(t, device=x.device) < pos + s
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    del logits
    ctx = torch.einsum("bhst,btc->bshc", probs, cache_ckv)
    w_uv = attn.w_uv.to(x.dtype).reshape(c, h, dv)
    ctx = torch.einsum("bshc,chv->bshv", ctx, w_uv)
    return ctx.reshape(b, s, h * dv) @ attn.wo.to(x.dtype)


@torch.no_grad()
def decode_step(model: TransformerLM, cache: dict, tokens: torch.Tensor):
    """One decode step: tokens [B, S_new] -> (logits [B, S_new, V],
    cache).  The cache is updated in place and returned (``pos`` advanced
    by ``S_new``): a functional copy would double a cache of tens of GB.
    A chunk of ``S_new > 1`` tokens attends to all of its own tokens, later
    ones included, as the reference's does (``causal=False``).  An MoE
    layer routes the step's B·S_new tokens together, so its capacity is
    that of B·S_new tokens, as the reference's."""
    cfg = model.cfg
    _, s = tokens.shape
    pos = int(cache["pos"])
    # no gradient here, so gather, then cast: the same values without a
    # copy of the whole table a step
    x = model.embed[tokens.long()].to(cfg.dtype)
    sin, cos = _rope(pos + torch.arange(s, dtype=torch.int32,
                                        device=x.device), cfg)
    mla = cfg.attn == "mla"
    attend, c1, c2 = ((_mla_decode, "ckv", "krope") if mla
                      else (_gqa_decode, "k", "v"))
    for i, layer in enumerate(model.layers()):
        x = x + attend(rmsnorm(x, layer.ln1), layer.attn, cfg, cache[c1][i],
                       cache[c2][i], pos, sin, cos)
        x = x + _mix(rmsnorm(x, layer.ln2), layer, cfg)[0]
    x = rmsnorm(x, model.final_ln)
    logits = x @ model.lm_head.to(x.dtype)
    cache["pos"] = cache["pos"] + s
    return logits, cache
