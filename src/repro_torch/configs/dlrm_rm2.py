"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse features, embed_dim 64,
bottom MLP 13-512-256-64, top MLP 512-256-1, dot interaction.

Vocab sizes: Criteo-like mixed magnitudes (the paper's RM-2 uses production
tables; these sum to ~19M rows)."""

import dataclasses

import numpy as np
import torch

from repro_torch.configs.common import (RECSYS_SHAPES, ArchDef, Cell,
                                        recsys_input_specs)
from repro_torch.models.recsys import dlrm

VOCABS = (10_000_000, 4_000_000, 2_000_000, 1_500_000, 800_000, 400_000,
          200_000, 100_000, 50_000, 20_000, 10_000, 10_000, 5_000, 5_000,
          2_000, 2_000, 1_000, 1_000, 500, 500, 200, 200, 100, 100, 50, 50)

CONFIG = dlrm.DLRMConfig(
    name="dlrm-rm2",
    n_dense=13,
    n_sparse=26,
    embed_dim=64,
    bot_mlp=(512, 256, 64),
    top_mlp=(512, 256, 1),
    vocab_sizes=VOCABS,
    hotness=8,
)

SMALL = dataclasses.replace(
    CONFIG, vocab_sizes=tuple([64] * 26), bot_mlp=(32, 16), top_mlp=(32, 1),
    embed_dim=16, hotness=3)


def _smoke():
    rng = np.random.default_rng(0)
    b = 8
    batch = {
        "dense": rng.normal(size=(b, SMALL.n_dense)).astype(np.float32),
        "sparse": rng.integers(-1, 64, (b, SMALL.n_sparse, SMALL.hotness)
                               ).astype(np.int32),
        "labels": rng.integers(0, 2, b).astype(np.float32),
    }
    return SMALL, {k: torch.from_numpy(v) for k, v in batch.items()}


ARCH = ArchDef(
    name="dlrm-rm2",
    family="recsys",
    config=CONFIG,
    cells={name: Cell(name, meta["kind"], dict(meta))
           for name, meta in RECSYS_SHAPES.items()},
    input_specs=lambda cell: recsys_input_specs(CONFIG, cell),
    smoke=_smoke,
    loss_fn=dlrm.loss_fn,
    model=dlrm.DLRM,
    notes="EmbeddingBag = the fixed-hotness segment_gather kernel with its "
          "gradient; retrieval_cand scores 1M candidates with one GEMV",
)
