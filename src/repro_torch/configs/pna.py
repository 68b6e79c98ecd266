"""pna [arXiv:2004.05718]: 4 layers, hidden 75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation."""

import dataclasses

from repro_torch.configs.gnn_common import NODE_CLASS, gnn_archdef
from repro_torch.models.gnn import pna

CONFIG = pna.PNAConfig(
    name="pna", n_layers=4, d_hidden=75, d_feat=1433, n_classes=16)

SMALL = dataclasses.replace(CONFIG, d_hidden=16, d_feat=12, n_classes=4)

ARCH = gnn_archdef("pna", CONFIG, pna.loss_fn, SMALL,
                   model=pna.PNA, layout=NODE_CLASS,
                   notes="multi-aggregator (4 agg × 3 scalers) "
                         "[arXiv:2004.05718]")
