"""The LM family's shared ArchDef (dense, MLA and MoE configurations)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.common import LM_SHAPES, ArchDef, Cell, lm_input_specs
from repro_torch.models import transformer
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def lm_archdef(cfg: LMConfig, notes: str = "") -> ArchDef:
    cells = {name: Cell(name, meta["kind"], dict(meta))
             for name, meta in LM_SHAPES.items()}

    def smoke():
        small_moe = None
        if cfg.moe is not None:
            small_moe = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                                  n_shared=min(1, cfg.moe.n_shared),
                                  first_dense_layers=min(
                                      1, cfg.moe.first_dense_layers))
        small = dataclasses.replace(
            cfg, n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2 if cfg.attn == "gqa" else 4,
            d_head=16, d_ff=128, vocab=256, moe=small_moe,
            q_lora=32, kv_lora=16, rope_head_dim=8, nope_head_dim=16,
            v_head_dim=16, remat=False)
        rng = np.random.default_rng(0)
        batch = {
            "tokens": rng.integers(0, 256, (2, 16)).astype(np.int32),
            "labels": rng.integers(0, 256, (2, 16)).astype(np.int32),
        }
        return small, {k: torch.from_numpy(v) for k, v in batch.items()}

    return ArchDef(
        name=cfg.name,
        family="lm",
        config=cfg,
        cells=cells,
        input_specs=lambda cell_name: lm_input_specs(cfg, cell_name),
        smoke=smoke,
        loss_fn=transformer.loss_fn,
        notes=notes,
        model=transformer.TransformerLM,
    )
