"""Deterministic, resumable synthetic data pipelines per family.

Every stream is *stateless in step*: ``batch_at(step)`` derives the batch
from (seed, step) alone, so resuming after preemption is exact — restore the
step counter and the stream continues byte-identically (no iterator state
in checkpoints).  Batches are numpy arrays, the reference's batch for
batch; the train step moves a batch to the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.models.gnn.sampler import pad_block, sample_blocks


@dataclass(frozen=True)
class TokenStream:
    """Synthetic LM token stream with a Zipf unigram + local structure
    (repeated n-grams) so the loss has learnable signal."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        base = rng.zipf(1.3, size=(self.batch, self.seq + 1)) % self.vocab
        # inject copy structure: second half repeats the first half shifted
        half = (self.seq + 1) // 2
        base[:, half:half * 2] = base[:, :half]
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}


@dataclass(frozen=True)
class RecsysStream:
    n_dense: int
    n_sparse: int
    hotness: int
    vocab_sizes: tuple[int, ...]
    batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        dense = rng.normal(size=(self.batch, self.n_dense)).astype(np.float32)
        sparse = np.zeros((self.batch, self.n_sparse, self.hotness), np.int32)
        for f, v in enumerate(self.vocab_sizes):
            sparse[:, f, :] = rng.zipf(1.2, size=(self.batch,
                                                  self.hotness)) % v
        # some pad slots
        pad = rng.random((self.batch, self.n_sparse, self.hotness)) < 0.1
        sparse[pad] = -1
        # clickable signal: label correlates with dense[0]
        labels = (dense[:, 0] + 0.3 * rng.normal(size=self.batch) > 0)
        return {"dense": dense, "sparse": sparse,
                "labels": labels.astype(np.float32)}


class SampledGraphStream:
    """Layered-fanout neighbor sampling over a synthetic power-law graph."""

    def __init__(self, n_nodes: int, avg_degree: int, d_feat: int,
                 n_classes: int, batch_nodes: int, fanout, seed: int = 0):
        rng = np.random.default_rng(seed)
        m = n_nodes * avg_degree
        src = rng.zipf(1.4, size=m) % n_nodes
        dst = rng.integers(0, n_nodes, m)
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=n_nodes), out=self.indptr[1:])
        self.nbr = dst.astype(np.int32)
        self.features = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
        self.labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
        self.n_nodes = n_nodes
        self.batch_nodes = batch_nodes
        self.fanout = list(fanout)
        self.seed = seed
        from repro_torch.configs.common import sampled_block_dims

        self.pad_n, self.pad_e = sampled_block_dims(batch_nodes, fanout)
        self.pad_n += batch_nodes  # slack for duplicate-free local ids

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        seeds = rng.choice(self.n_nodes, self.batch_nodes, replace=False)
        blk = sample_blocks(self.indptr, self.nbr, seeds, self.fanout, rng)
        p = pad_block(blk, self.pad_n, self.pad_e)
        feats = self.features[p["nodes"]]
        labels = self.labels[p["nodes"]]
        mask = np.zeros(self.pad_n, bool)
        mask[: blk["seed_count"]] = True
        return {"x": feats, "edge_src": p["edge_src"],
                "edge_dst": p["edge_dst"], "labels": labels,
                "train_mask": mask}
