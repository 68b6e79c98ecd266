"""Analytic MODEL_FLOPS per (arch × cell) — the 'useful work' numerator for
the roofline's MODEL_FLOPS / HLO_FLOPS ratio.

Conventions: train = 6·N_active·tokens (fwd 2 + bwd 4) plus attention
quadratic terms; prefill = forward only (2·N·tokens + attention);
decode = 2·N_active·new_tokens + per-layer KV-cache reads (the dominant
attention term at long context); GNN/recsys from per-op counts × 3 for
training (bwd ≈ 2× fwd).  The reference's formulas, term for term, on the
port's configs; the engine has none (its cells are not FLOP-bound).
"""

from __future__ import annotations

from repro_torch.configs import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, get_arch
from repro_torch.configs.common import sampled_block_dims


def _lm_flops(cfg, cell: str) -> float:
    s = LM_SHAPES[cell]
    n_act = cfg.active_param_count()
    bsz, seq = s["batch"], s["seq"]
    L, H, dh = cfg.n_layers, cfg.n_heads, cfg.d_head
    if cfg.attn == "mla":
        qk_dim = cfg.nope_head_dim + cfg.rope_head_dim
        attn_per_tok_train = 2 * L * H * (qk_dim + cfg.v_head_dim) * seq / 2
    else:
        attn_per_tok_train = 2 * L * H * dh * 2 * seq / 2  # causal half
    if s["kind"] == "train":
        tokens = bsz * seq
        return 6.0 * n_act * tokens + 3 * 2 * attn_per_tok_train * tokens
    if s["kind"] == "prefill":
        tokens = bsz * seq
        return 2.0 * n_act * tokens + 2 * attn_per_tok_train * tokens
    # decode: 1 token per sequence against a `seq`-long cache
    t = seq
    if cfg.attn == "mla":
        per_tok_attn = 2 * L * H * t * (2 * cfg.kv_lora + cfg.rope_head_dim)
    else:
        per_tok_attn = 2 * L * cfg.n_heads * t * dh * 2
    return bsz * (2.0 * n_act + per_tok_attn)


def _gnn_dims(cell: str) -> tuple[int, int, int]:
    s = GNN_SHAPES[cell]
    if s["regime"] == "sampled":
        n, e = sampled_block_dims(s["batch_nodes"], s["fanout"])
        return n, e, s["d_feat"]
    if s["regime"] == "batched":
        return s["n_per"] * s["batch"], s["e_per"] * s["batch"], s["d_feat"]
    return s["n"], s["e"], s["d_feat"]


def _gnn_flops(arch: str, cfg, cell: str) -> float:
    n, e, d_feat = _gnn_dims(cell)
    if arch == "gcn-cora":
        h = cfg.d_hidden
        dims = [d_feat] + [h] * (cfg.n_layers - 1) + [cfg.n_classes]
        fwd = sum(2.0 * n * dims[i] * dims[i + 1] + 2.0 * e * dims[i + 1]
                  for i in range(cfg.n_layers))
        return 3 * fwd
    if arch == "pna":
        h = cfg.d_hidden
        d_in = d_feat
        fwd = 0.0
        for _ in range(cfg.n_layers):
            fwd += 2.0 * e * (2 * d_in) * h  # pre-MLP on edges
            fwd += 4 * 2.0 * e * h  # 4 aggregators
            fwd += 2.0 * n * (d_in + 12 * h) * h + 2.0 * n * h * h  # post
            d_in = h
        fwd += 2.0 * n * h * cfg.n_classes
        return 3 * fwd
    if arch == "meshgraphnet":
        h = cfg.d_hidden
        fwd = 2.0 * n * d_feat * h + 2.0 * e * cfg.d_edge_in * h
        for _ in range(cfg.n_layers):
            fwd += 2.0 * e * (3 * h) * h + 2.0 * e * h * h  # edge MLP
            fwd += 2.0 * n * (2 * h) * h + 2.0 * n * h * h  # node MLP
            fwd += 2.0 * e * h  # aggregate
        fwd += 2.0 * n * h * cfg.d_out
        return 3 * fwd
    # dimenet
    h, b = cfg.d_hidden, cfg.n_bilinear
    t = 8 * e
    sr = cfg.n_spherical * cfg.n_radial
    fwd = 2.0 * e * (3 * h) * h
    for _ in range(cfg.n_blocks):
        fwd += 2.0 * e * h * h  # w_src
        fwd += 2.0 * t * sr * b  # sbf proj
        fwd += 2.0 * t * b * h * h  # bilinear einsum tb,bhg,th->tg
        fwd += 2.0 * t * h  # segment sum
        fwd += 2 * 2.0 * e * h * h  # update MLP
        fwd += 2.0 * n * h * h + 2.0 * n * h  # out block
    return 3 * fwd


def _recsys_flops(cfg, cell: str) -> float:
    s = RECSYS_SHAPES[cell]
    b = s["batch"]
    bot = [cfg.n_dense, *cfg.bot_mlp]
    top_in = cfg.n_interact + cfg.bot_mlp[-1]
    top = [top_in, *cfg.top_mlp]
    mlps = sum(2.0 * b * a * bb for a, bb in zip(bot, bot[1:]))
    mlps += sum(2.0 * b * a * bb for a, bb in zip(top, top[1:]))
    f = cfg.n_sparse + 1
    inter = 2.0 * b * f * f * cfg.embed_dim
    gather = b * cfg.n_sparse * cfg.hotness * cfg.embed_dim  # sum-reduce
    fwd = mlps + inter + gather
    if s["kind"] == "train":
        return 3 * fwd
    if s["kind"] == "retrieval":
        return 2.0 * s["n_candidates"] * cfg.embed_dim + mlps / b
    return fwd


def model_flops(arch_name: str, cell: str) -> float:
    arch = get_arch(arch_name)
    cfg = arch.config_for(cell) if arch.cell_config else arch.config
    if arch.family == "lm":
        return _lm_flops(cfg, cell)
    if arch.family == "gnn":
        return _gnn_flops(arch_name, cfg, cell)
    if arch.family == "recsys":
        return _recsys_flops(cfg, cell)
    raise ValueError(arch.family)
