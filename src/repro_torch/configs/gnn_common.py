"""The GNN family's shared ArchDef and smoke-batch synthesis."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.common import (GNN_SHAPES, ArchDef, Cell,
                                        gnn_input_specs)


def synth_graph_batch(cfg, n: int, e: int, seed: int = 0) -> dict:
    """Small real batch in the node-classification layout (smoke tests /
    examples), the reference's draws in its order."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    batch = {
        "edge_src": src, "edge_dst": dst,
        "x": rng.normal(size=(n, cfg.d_feat)).astype(np.float32),
        "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32),
        "train_mask": rng.random(n) < 0.5,
    }
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def gnn_archdef(arch_name: str, cfg, loss_fn, small_cfg, notes="") -> ArchDef:
    cells = {name: Cell(name, meta["kind"], dict(meta))
             for name, meta in GNN_SHAPES.items()}

    def specs(cell_name: str):
        return gnn_input_specs(cfg, cell_name)

    def smoke():
        batch = synth_graph_batch(small_cfg, n=40, e=120)
        return small_cfg, batch

    def cell_config(cell_name: str):
        """Input width follows the shape cell (d_feat differs per dataset)."""
        s = GNN_SHAPES[cell_name]
        return dataclasses.replace(cfg, d_feat=s.get("d_feat", 16))

    return ArchDef(name=arch_name, family="gnn", config=cfg, cells=cells,
                   input_specs=specs, smoke=smoke, loss_fn=loss_fn,
                   notes=notes, cell_config=cell_config)
