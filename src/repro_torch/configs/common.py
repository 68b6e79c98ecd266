"""Architecture registry plumbing.

Each config module defines an ``ArchDef``: the exact published
configuration, its assigned input-shape cells, input specs as ``meta``
tensors (shapes and dtypes, no storage: the reference's
``ShapeDtypeStruct``s), and a reduced smoke configuration + real batch for
CPU tests.  Only the recsys and GNN input specs are ported; the LM
family's come with its slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Cell:
    name: str
    kind: str  # "train" | "prefill" | "decode" | "serve" | "retrieval"
    meta: dict = field(default_factory=dict)


@dataclass
class ArchDef:
    name: str
    family: str  # "gnn" | "recsys"
    config: Any
    cells: dict[str, Cell]
    # (cell_name) -> batch dict of meta tensors
    input_specs: Callable[[str], dict]
    # () -> (small_cfg, small_batch_of_real_tensors)
    smoke: Callable[[], tuple[Any, dict]]
    loss_fn: Callable | None = None  # (model, batch) -> scalar
    notes: str = ""
    # per-cell config override (e.g. GNN d_feat follows the shape cell)
    cell_config: Callable[[str], Any] | None = None

    def config_for(self, cell_name: str):
        if self.cell_config is not None:
            return self.cell_config(cell_name)
        return self.config

    def abstract_params(self, build: Callable):
        """The model ``build(config, device=...)`` makes, on the ``meta``
        device: every parameter's shape and dtype, no storage, no draws."""
        return build(self.config, device="meta")


def sds(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# shared shape tables (from the assignment)
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

GNN_SHAPES = {
    "full_graph_sm": dict(n=2708, e=10556, d_feat=1433, kind="train",
                          regime="full"),
    "minibatch_lg": dict(n_full=232965, e_full=114615892, batch_nodes=1024,
                         fanout=(15, 10), d_feat=602, kind="train",
                         regime="sampled"),
    "ogb_products": dict(n=2449029, e=61859140, d_feat=100, kind="train",
                         regime="full"),
    "molecule": dict(n_per=30, e_per=64, batch=128, d_feat=16, kind="train",
                     regime="batched"),
}

RECSYS_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1000000, kind="retrieval"),
}


def sampled_block_dims(batch_nodes: int, fanout) -> tuple[int, int]:
    """(n_sub, e_sub) for a padded layered-fanout block."""
    n = batch_nodes
    layer = batch_nodes
    e = 0
    for f in fanout:
        layer = layer * f
        n += layer
        e += layer
    return n, e


def gnn_input_specs(cfg, cell_name: str) -> dict:
    """Node-classification layout (gcn)."""
    s = GNN_SHAPES[cell_name]
    if s["regime"] == "sampled":
        n, e = sampled_block_dims(s["batch_nodes"], s["fanout"])
        d_feat = s["d_feat"]
    elif s["regime"] == "batched":
        n = s["n_per"] * s["batch"]
        e = s["e_per"] * s["batch"]
        d_feat = s["d_feat"]
    else:
        n, e, d_feat = s["n"], s["e"], s["d_feat"]
    return {"edge_src": sds((e,)), "edge_dst": sds((e,)),
            "x": sds((n, d_feat), torch.float32), "labels": sds((n,)),
            "train_mask": sds((n,), torch.bool)}


def recsys_input_specs(cfg, cell_name: str) -> dict:
    s = RECSYS_SHAPES[cell_name]
    b = s["batch"]
    base = {
        "dense": sds((b, cfg.n_dense), torch.float32),
        "sparse": sds((b, cfg.n_sparse, cfg.hotness)),
    }
    if s["kind"] == "train":
        base["labels"] = sds((b,), torch.float32)
    if s["kind"] == "retrieval":
        base["cand"] = sds((s["n_candidates"], cfg.embed_dim), torch.float32)
    return base
