"""dimenet [arXiv:2003.03123]: 6 interaction blocks, hidden 128, 8 bilinear,
7 spherical × 6 radial basis functions; molecular energy regression."""

import dataclasses

import numpy as np
import torch

from repro_torch.configs.common import sds
from repro_torch.configs.gnn_common import GraphLayout, gnn_archdef
from repro_torch.models.gnn import dimenet

CONFIG = dimenet.DimeNetConfig(
    name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
    n_radial=6)

SMALL = dataclasses.replace(CONFIG, n_blocks=2, d_hidden=16, n_bilinear=2,
                            n_spherical=3, n_radial=2)


def _molecule_fields(cfg, dims):
    return {"z": sds((dims.n,)),
            "pos": sds((dims.n, 3), torch.float32),
            "t_kj": sds((dims.t,)),
            "t_ji": sds((dims.t,)),
            "batch_seg": sds((dims.n,)),
            "targets": sds((dims.n_graphs,), torch.float32)}


def _molecule_draw(rng, cfg, dims):
    return {"z": rng.integers(0, cfg.n_atom_types, dims.n).astype(np.int32),
            "pos": rng.normal(size=(dims.n, 3)).astype(np.float32),
            "t_kj": rng.integers(0, dims.e, dims.t).astype(np.int32),
            "t_ji": rng.integers(0, dims.e, dims.t).astype(np.int32),
            "batch_seg": rng.integers(0, dims.n_graphs, dims.n).astype(
                np.int32),
            "targets": rng.normal(size=(dims.n_graphs,)).astype(np.float32)}


# molecules: atom types, positions, triplets of edges (k->j, j->i), a
# molecule id a node and an energy a molecule; no raw feature width
MOLECULE = GraphLayout(_molecule_fields, _molecule_draw, None)

ARCH = gnn_archdef("dimenet", CONFIG, dimenet.loss_fn, SMALL,
                   model=dimenet.DimeNet, layout=MOLECULE,
                   notes="triplet directional message passing "
                         "[arXiv:2003.03123]; angular basis uses cos(lθ) "
                         "family of the published rank")
