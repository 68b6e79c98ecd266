"""The GNN family's shared ArchDef, batch layouts and smoke-batch synthesis.

Each GNN's config module owns its batch layout (a ``GraphLayout``): the
fields beyond the edge lists, how they are drawn, and which config field
a cell's input width sets.  Node classification (GCN, PNA) is here."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.common import (GNN_SHAPES, ArchDef, Cell,
                                        GraphDims, gnn_cell_dims,
                                        gnn_input_specs, sds)

# the smoke batch's sizes, the reference's: 40 nodes, 120 edges, 4 graphs
# and min(4e, 512) triplets
SMOKE_DIMS = GraphDims(n=40, e=120, n_graphs=4, t=min(4 * 120, 512))


@dataclasses.dataclass(frozen=True)
class GraphLayout:
    """A GNN's batch beyond its edge lists: ``fields(cfg, dims)`` gives
    each field as a ``meta`` tensor, ``draw(rng, cfg, dims)`` draws them
    as numpy arrays after the edges, in the reference's order, and
    ``width`` names the config field that a cell's input width sets (None
    where nodes carry no raw features)."""
    fields: Callable[[object, GraphDims], dict]
    draw: Callable[[np.random.Generator, object, GraphDims], dict]
    width: str | None


def _node_class_fields(cfg, dims: GraphDims) -> dict:
    return {"x": sds((dims.n, dims.d_feat), torch.float32),
            "labels": sds((dims.n,)),
            "train_mask": sds((dims.n,), torch.bool)}


def _node_class_draw(rng, cfg, dims: GraphDims) -> dict:
    return {"x": rng.normal(size=(dims.n, cfg.d_feat)).astype(np.float32),
            "labels": rng.integers(0, cfg.n_classes, dims.n).astype(
                np.int32),
            "train_mask": rng.random(dims.n) < 0.5}


# node classification (GCN, PNA): features, a class and a mask a node
NODE_CLASS = GraphLayout(_node_class_fields, _node_class_draw, "d_feat")


def synth_graph_batch(layout: GraphLayout, cfg, dims: GraphDims,
                      seed: int = 0) -> dict:
    """A real batch in ``layout`` at ``dims`` (smoke tests, examples, and
    the cells at their shapes): the edge lists, then the layout's fields,
    the reference's draws in its order."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, dims.n, dims.e).astype(np.int32)
    dst = rng.integers(0, dims.n, dims.e).astype(np.int32)
    batch = {"edge_src": src, "edge_dst": dst,
             **layout.draw(rng, cfg, dims)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def cell_batch(arch: ArchDef, cell_name: str, seed: int) -> tuple:
    """``(cfg, batch)``: the arch's config at ``cell_name`` and a real
    batch at the cell's sizes (``input_specs``' shapes), on the host."""
    cfg = arch.config_for(cell_name)
    return cfg, synth_graph_batch(arch.layout, cfg,
                                  gnn_cell_dims(cell_name), seed)


def gnn_archdef(arch_name: str, cfg, loss_fn, small_cfg, *, model,
                layout: GraphLayout, notes="") -> ArchDef:
    cells = {name: Cell(name, meta["kind"], dict(meta))
             for name, meta in GNN_SHAPES.items()}

    def specs(cell_name: str):
        return gnn_input_specs(layout, cfg, cell_name)

    def smoke():
        return small_cfg, synth_graph_batch(layout, small_cfg, SMOKE_DIMS)

    def cell_config(cell_name: str):
        """Input width follows the shape cell (d_feat differs per dataset)."""
        if layout.width is None:
            return cfg
        d_feat = GNN_SHAPES[cell_name].get("d_feat", 16)
        return dataclasses.replace(cfg, **{layout.width: d_feat})

    return ArchDef(name=arch_name, family="gnn", config=cfg, cells=cells,
                   input_specs=specs, smoke=smoke, loss_fn=loss_fn,
                   notes=notes, cell_config=cell_config, model=model,
                   layout=layout)
