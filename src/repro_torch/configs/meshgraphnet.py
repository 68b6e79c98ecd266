"""meshgraphnet [arXiv:2010.03409]: 15 message-passing layers, hidden 128,
sum aggregation, 2-layer MLPs with LayerNorm; dynamics regression."""

import dataclasses

import numpy as np
import torch

from repro_torch.configs.common import sds
from repro_torch.configs.gnn_common import GraphLayout, gnn_archdef
from repro_torch.models.gnn import meshgraphnet as mgn

CONFIG = mgn.MGNConfig(
    name="meshgraphnet", n_layers=15, d_hidden=128, d_node_in=1433,
    d_edge_in=4, d_out=3, mlp_layers=2)

SMALL = dataclasses.replace(CONFIG, n_layers=3, d_hidden=16, d_node_in=12)


def _mesh_fields(cfg, dims):
    return {"x": sds((dims.n, dims.d_feat), torch.float32),
            "edge_attr": sds((dims.e, 4), torch.float32),
            "targets": sds((dims.n, 3), torch.float32)}


def _mesh_draw(rng, cfg, dims):
    return {"x": rng.normal(size=(dims.n, cfg.d_node_in)).astype(np.float32),
            "edge_attr": rng.normal(size=(dims.e, cfg.d_edge_in)).astype(
                np.float32),
            "targets": rng.normal(size=(dims.n, cfg.d_out)).astype(
                np.float32)}


# a mesh: node features, 4 edge features, a 3-vector target a node
MESH = GraphLayout(_mesh_fields, _mesh_draw, "d_node_in")

ARCH = gnn_archdef("meshgraphnet", CONFIG, mgn.loss_fn, SMALL,
                   model=mgn.MeshGraphNet, layout=MESH,
                   notes="encode-process-decode mesh GNN [arXiv:2010.03409]; "
                         "d_node_in follows the active shape cell")
