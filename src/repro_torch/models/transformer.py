"""Decoder-only LM of the port: the dense GQA stack (Qwen2, Qwen3,
Minitron), a training forward with full causal attention and a decode
step against a preallocated KV cache.

``TransformerLM`` holds one module a layer (``dense_layers.{i}``), where
the reference stacks each leaf over the layers and scans them: a stacked
``Parameter`` would have autograd build a gradient of the whole stack for
every layer's slice.  ``convert.params_from_jax`` splits the reference's
stacks.  The layer loop is a Python loop, so ``LMConfig.unroll_layers``
changes nothing here, and ``act_spec`` / ``logits_spec`` (sharding hints)
are kept in the config but have no effect until sharding is ported.

Numerics follow the reference's functions term for term: the attention
logits are bf16 products summed in float32 (``preferred_element_type``),
masked with the accumulation dtype's most negative value, and the softmax
is written out (max and sum in float32, ``exp`` in the accumulation
dtype); the embedding is cast to the compute dtype before it is gathered,
so a repeated token's gradient accumulates in that dtype.

MLA attention (DeepSeek-V2), MoE layers and ``remat_policy="dots"`` are
not ported yet: they raise ``NotImplementedError``.
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
                                       rope_angles, swiglu)


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
    attn: str = "gqa"  # "gqa" | "mla" (not ported)
    # MLA geometry (DeepSeek-V2)
    q_lora: int = 0
    kv_lora: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    rope_theta: float = 1e4
    moe: Any = None  # the reference's MoEConfig (not ported)
    remat: bool = True
    # remat policy: "full" (recompute each layer in the backward) or
    # "dots" (save matmul outputs; not ported)
    remat_policy: str = "full"
    # keep attention logits in float32 (stable softmax) or in the compute
    # dtype (max and sum still in float32)
    attn_fp32_logits: bool = True
    compute_dtype: str = "bfloat16"
    # no effect in the port (the layer loop is a Python loop)
    unroll_layers: bool = False
    # sharding hints of the reference; no effect in the port yet
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


def check_ported(cfg: LMConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not have yet,
    naming the ROADMAP item that brings it."""
    if cfg.attn == "mla":
        raise NotImplementedError(
            "MLA attention (DeepSeek-V2) is not ported yet: ROADMAP Queue 1 "
            "item 6.2 (MoE and MLA)")
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE layers are not ported yet: ROADMAP Queue 1 item 6.2 (MoE "
            "and MLA)")
    if cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' is not ported yet: it comes with sharding "
            "and the dry run, ROADMAP Queue 1 item 6.4")


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


class Layer(nn.Module):
    def __init__(self, cfg: LMConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.ln1 = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device))
        self.ln2 = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device))
        self.attn = Attention(cfg, device=device, generator=generator)
        self.mlp = SwiGLU(cfg, device=device, generator=generator)


class TransformerLM(nn.Module):
    """The dense LM: ``embed [V, d]``, ``dense_layers.{i}`` (``ln1``,
    ``ln2``, ``attn.*``, ``mlp.*``), ``final_ln``, ``lm_head [d, V]``
    (untied), float32 master weights drawn from ``generator``."""

    def __init__(self, cfg: LMConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.embed = nn.Parameter(embed_init(cfg.vocab, cfg.d_model, **kw))
        self.final_ln = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device))
        self.lm_head = nn.Parameter(dense_init(cfg.d_model, cfg.vocab, **kw))
        self.dense_layers = nn.ModuleList(
            Layer(cfg, **kw) for _ in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor):
        return forward(self, tokens)


# --------------------------------------------------------------------------
# attention (training / prefill path)
# --------------------------------------------------------------------------


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
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(q, attn.q_norm)
        k = rmsnorm(k, attn.k_norm)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _attention_full(x, attn: Attention, cfg: LMConfig, sin, cos):
    b, s, _ = x.shape
    q, k, v = _project(x, attn, cfg, sin, cos)
    out = _gqa(q, k, v, causal=True, fp32_logits=cfg.attn_fp32_logits)
    return out.reshape(b, s, -1) @ attn.wo.to(x.dtype)


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


# --------------------------------------------------------------------------
# forward / loss
# --------------------------------------------------------------------------


def _ffn(h, mlp: SwiGLU):
    return swiglu(h, mlp.w_gate, mlp.w_up, mlp.w_down)


def _layer_fwd(x, layer: Layer, cfg: LMConfig, sin, cos):
    x = x + _attention_full(rmsnorm(x, layer.ln1), layer.attn, cfg, sin, cos)
    return x + _ffn(rmsnorm(x, layer.ln2), layer.mlp)


def _rope(positions, cfg: LMConfig):
    sin, cos = rope_angles(positions, cfg.d_head, cfg.rope_theta)
    return sin[None, :, None, :], cos[None, :, None, :]


def forward(model: TransformerLM, tokens: torch.Tensor):
    """tokens int [B, S] -> (logits [B, S, V] in the compute dtype, aux
    loss: a float32 zero, as the dense reference's).  With ``cfg.remat``
    and gradients enabled each layer is recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)."""
    cfg = model.cfg
    _, s = tokens.shape
    # cast, then gather: a repeated token's gradient accumulates in the
    # compute dtype, as the reference's gather transposes
    x = model.embed.to(cfg.dtype)[tokens.long()]
    sin, cos = _rope(torch.arange(s, dtype=torch.int32, device=x.device),
                     cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.dense_layers:
        if remat:
            x = checkpoint(_layer_fwd, x, layer, cfg, sin, cos,
                           use_reentrant=False)
        else:
            x = _layer_fwd(x, layer, cfg, sin, cos)
    x = rmsnorm(x, model.final_ln)
    logits = x @ model.lm_head.to(x.dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(model: TransformerLM, batch: dict) -> torch.Tensor:
    logits, aux = forward(model, batch["tokens"])
    return cross_entropy_loss(logits, batch["labels"]) + aux


# --------------------------------------------------------------------------
# decode (serving) path
# --------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> dict:
    """Preallocated KV cache, layer-stacked as the reference's: ``k`` and
    ``v`` ``[L, B, max_len, Hkv, D]`` in the compute dtype, ``pos`` an
    int32 scalar (the next position to write)."""
    check_ported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _gqa_decode(x, attn: Attention, cfg: LMConfig, cache_k, cache_v,
                pos: int, sin, cos):
    """Writes the step's k and v into the layer's cache slices in place at
    ``pos`` (clamped so that the ``s`` new entries fit, as
    ``dynamic_update_slice`` clamps), then attends over the whole cache
    with the first ``pos + s`` entries valid and no causal mask."""
    b, s, _ = x.shape
    q, k, v = _project(x, attn, cfg, sin, cos)
    start = max(0, min(pos, cache_k.shape[1] - s))
    cache_k[:, start:start + s] = k
    cache_v[:, start:start + s] = v
    out = _gqa(q, cache_k, cache_v, causal=False, kv_len=pos + s,
               fp32_logits=cfg.attn_fp32_logits)
    return out.reshape(b, s, -1) @ attn.wo.to(x.dtype)


@torch.no_grad()
def decode_step(model: TransformerLM, cache: dict, tokens: torch.Tensor):
    """One decode step: tokens [B, S_new] -> (logits [B, S_new, V],
    cache).  The cache is updated in place and returned (``pos`` advanced
    by ``S_new``): a functional copy would double a cache of tens of GB.
    A chunk of ``S_new > 1`` tokens attends to all of its own tokens, later
    ones included, as the reference's does (``causal=False``)."""
    cfg = model.cfg
    _, s = tokens.shape
    pos = int(cache["pos"])
    # no gradient here, so gather, then cast: the same values without a
    # copy of the whole table a step
    x = model.embed[tokens.long()].to(cfg.dtype)
    sin, cos = _rope(pos + torch.arange(s, dtype=torch.int32,
                                        device=x.device), cfg)
    for i, layer in enumerate(model.dense_layers):
        x = x + _gqa_decode(rmsnorm(x, layer.ln1), layer.attn, cfg,
                            cache["k"][i], cache["v"][i], pos, sin, cos)
        x = x + _ffn(rmsnorm(x, layer.ln2), layer.mlp)
    x = rmsnorm(x, model.final_ln)
    logits = x @ model.lm_head.to(x.dtype)
    cache["pos"] = cache["pos"] + s
    return logits, cache
