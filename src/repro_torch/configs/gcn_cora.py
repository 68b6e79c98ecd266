"""gcn-cora [arXiv:1609.02907]: 2 layers, hidden 16, mean/sym-norm aggregate.

d_feat/n_classes follow the active shape cell (cora defaults here)."""

import dataclasses

from repro_torch.configs.gnn_common import NODE_CLASS, gnn_archdef
from repro_torch.models.gnn import gcn

CONFIG = gcn.GCNConfig(
    name="gcn-cora", n_layers=2, d_hidden=16, d_feat=1433, n_classes=7)

SMALL = dataclasses.replace(CONFIG, d_feat=12, n_classes=4)

ARCH = gnn_archdef("gcn-cora", CONFIG, gcn.loss_fn, SMALL,
                   model=gcn.GCN, layout=NODE_CLASS,
                   notes="2-layer sym-norm GCN [arXiv:1609.02907]")
