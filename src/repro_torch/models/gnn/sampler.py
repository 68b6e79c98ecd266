"""Neighbor sampler for sampled-training GNN shapes (minibatch_lg).

Real layered fanout sampling (GraphSAGE-style) over a CSR graph:
``sample_blocks`` draws, for each seed, up to fanout[0] neighbors, then for
each of those up to fanout[1], etc., emitting a padded subgraph in the
models' common batch layout (edge_src/edge_dst into a compact local id
space).  Deterministic given the numpy Generator.

Padding: missing neighbors repeat the source node with a self-edge, keeping
shapes static for jit while preserving aggregation semantics under mean/sum
with self-loops — the standard padded-sampler trick.
"""

from __future__ import annotations

import numpy as np


def sample_blocks(
    indptr: np.ndarray,
    nbr: np.ndarray,
    seeds: np.ndarray,
    fanouts: list[int],
    rng: np.random.Generator,
):
    """Returns dict(nodes, edge_src, edge_dst, seed_count) with LOCAL ids.

    nodes[0:len(seeds)] are the seeds; edges point child -> parent
    (aggregation flows toward the seeds).
    """
    nodes = list(map(int, seeds))
    local: dict[int, int] = {int(v): i for i, v in enumerate(seeds)}
    frontier = list(range(len(seeds)))
    src_l: list[int] = []
    dst_l: list[int] = []
    for fan in fanouts:
        next_frontier: list[int] = []
        for li in frontier:
            v = nodes[li]
            s, e = int(indptr[v]), int(indptr[v + 1])
            deg = e - s
            if deg == 0:
                chosen = np.full(fan, v)  # self-padding
            elif deg <= fan:
                chosen = np.concatenate(
                    [nbr[s:e], np.full(fan - deg, v)])
            else:
                chosen = nbr[s + rng.choice(deg, size=fan, replace=False)]
            for w in chosen:
                w = int(w)
                wi = local.get(w)
                if wi is None:
                    wi = len(nodes)
                    local[w] = wi
                    nodes.append(w)
                src_l.append(wi)
                dst_l.append(li)
                next_frontier.append(wi)
        frontier = next_frontier
    return {
        "nodes": np.asarray(nodes, dtype=np.int64),
        "edge_src": np.asarray(src_l, dtype=np.int32),
        "edge_dst": np.asarray(dst_l, dtype=np.int32),
        "seed_count": len(seeds),
    }


def pad_block(block: dict, n_nodes: int, n_edges: int) -> dict:
    """Pad a sampled block to static (n_nodes, n_edges) for jit."""
    nodes = block["nodes"]
    src, dst = block["edge_src"], block["edge_dst"]
    out_nodes = np.zeros(n_nodes, dtype=np.int64)
    out_nodes[: len(nodes)] = nodes[:n_nodes]
    out_src = np.zeros(n_edges, dtype=np.int32)
    out_dst = np.zeros(n_edges, dtype=np.int32)
    m = min(len(src), n_edges)
    out_src[:m] = src[:m]
    out_dst[:m] = dst[:m]
    # padded edges become self-loops on node 0 (harmless under masking)
    return {"nodes": out_nodes, "edge_src": out_src, "edge_dst": out_dst,
            "seed_count": block["seed_count"], "n_real_nodes": len(nodes),
            "n_real_edges": len(src)}
