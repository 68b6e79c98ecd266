"""Explicit-SPMD GNN training step (the reference's "shard_map" profile).

Each rank of the mesh runs the model with:

  - edge (or triplet) arrays sharded across ALL mesh axes: each rank takes
    its contiguous shard, in the mesh's row-major rank order,
  - node arrays and parameters replicated,
  - local segment reductions + psum/pmax (the models' ``spmd_axes`` path,
    ``models/gnn/common.py``),
  - the mean of the loss and of the gradients over every mesh axis, then
    the replicated AdamW,

which is the standard production layout for full-graph GNN training.

Edge padding: the sharded axis must divide by the shard count; pads use
out-of-range segment ids (dropped by ``segment_sum``) so they are
mathematically invisible.  DimeNet's edge-sharded form (v2) also needs its
triplets co-partitioned with their target edge
(:func:`edge_shard_triplets`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sharding.comm import axis_group, mesh_scope, pmean_
from repro_torch.sharding.specs import mesh_dims
from repro_torch.train.optimizer import OptConfig, adamw_update

SHARDED_FIELDS = {
    "gcn-cora": ("edge_src", "edge_dst"),
    "pna": ("edge_src", "edge_dst"),
    "meshgraphnet": ("edge_src", "edge_dst", "edge_attr"),
    "dimenet": ("t_kj", "t_ji"),
}
# pad value per field kind: segment targets pad out-of-range; gather sources
# pad 0 (their messages land in dropped segments)
_PAD_SEGMENT = {"edge_dst", "t_ji"}


def mesh_axes(mesh) -> tuple[str, ...]:
    names = mesh_dims(mesh)
    return tuple(a for a in ("pod", "data", "model") if a in names)


def n_shards_of(mesh) -> int:
    dims = mesh_dims(mesh)
    out = 1
    for a in mesh_axes(mesh):
        out *= dims[a]
    return out


def pad_gnn_batch_abstract(arch_name: str, batch_abs: dict, n_shards: int,
                           n_drop_segment: int) -> dict:
    """Pad the sharded edge/triplet axes up to a multiple of n_shards
    (``meta`` tensors: shapes and dtypes)."""
    out = dict(batch_abs)
    for f in SHARDED_FIELDS[arch_name]:
        x = out[f]
        e = x.shape[0]
        pad = (-e) % n_shards
        if pad:
            out[f] = torch.empty((e + pad,) + tuple(x.shape[1:]),
                                 dtype=x.dtype, device="meta")
    return out


def pad_gnn_batch(arch_name: str, batch: dict, n_shards: int,
                  n_drop_segment: int) -> dict:
    """The batch with its sharded fields padded to a multiple of
    ``n_shards``: segment targets with ``n_drop_segment``, gather sources
    with 0.  Tensors in, tensors out (numpy arrays are taken as tensors)."""
    out = dict(batch)
    for f in SHARDED_FIELDS[arch_name]:
        x = torch.as_tensor(out[f])
        pad = (-x.shape[0]) % n_shards
        if pad:
            fill = n_drop_segment if f in _PAD_SEGMENT else 0
            x = torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                         dtype=x.dtype, device=x.device)])
        out[f] = x
    return out


def edge_shard_triplets(batch: dict, n_shards: int) -> dict:
    """DimeNet v2's batch: the edges padded to a multiple of ``n_shards``
    (sources with 0, targets with the node count, dropped), and each
    shard's triplets (those whose target edge ``t_ji`` it holds) in a
    block of the same length for every shard, ``t_kj`` as global edge ids
    and ``t_ji`` as ids local to the shard; pad triplets take source 0
    and the dropped local id ``E / n_shards``."""
    b = {k: np.asarray(v) for k, v in batch.items()}
    e = b["edge_src"].shape[0]
    e_pad = -(-e // n_shards) * n_shards
    n = b["pos"].shape[0]
    e_l = e_pad // n_shards
    t_kj, t_ji = b["t_kj"], b["t_ji"]
    shard_of = t_ji // e_l
    t_pad = max(int(np.bincount(shard_of, minlength=n_shards).max()), 1)
    tkj = np.zeros((n_shards, t_pad), np.int32)
    tji = np.full((n_shards, t_pad), e_l, np.int32)
    for s in range(n_shards):
        sel = shard_of == s
        k = int(sel.sum())
        tkj[s, :k] = t_kj[sel]
        tji[s, :k] = t_ji[sel] - s * e_l
    out = dict(b)
    out["edge_src"] = np.pad(b["edge_src"], (0, e_pad - e))
    out["edge_dst"] = np.pad(b["edge_dst"], (0, e_pad - e),
                             constant_values=n)
    out["t_kj"], out["t_ji"] = tkj.reshape(-1), tji.reshape(-1)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def sharded_fields(arch_name: str, edge_sharded: bool = False) -> set:
    out = set(SHARDED_FIELDS[arch_name])
    if edge_sharded:  # dimenet v2: edge arrays sharded too
        out |= {"edge_src", "edge_dst"}
    return out


def local_shard(batch: dict, fields: set, index: int,
                n_shards: int) -> dict:
    """This shard's contiguous block of each of ``fields``; the rest as
    it is."""
    out = dict(batch)
    for f in fields:
        x = batch[f]
        rows = x.shape[0] // n_shards
        out[f] = x[index * rows:(index + 1) * rows]
    return out


def spmd_value_and_grad(loss_fn, model, batch: dict, mesh,
                        fields: set) -> tuple:
    """``(loss, grads)`` of ``loss_fn(model, shard)`` on this rank's shard
    of ``fields`` of the whole ``batch``, each averaged over every mesh
    axis: the global loss and gradients, the same on every rank."""
    from repro_torch.train.trainstep import value_and_grad

    axes = mesh_axes(mesh)
    with mesh_scope(mesh):
        index = torch.distributed.get_rank(axis_group(axes))
        local = local_shard(batch, fields, index, n_shards_of(mesh))
        loss, grads = value_and_grad(loss_fn, model, local)
        pmean_([loss, *grads.values()], axes)
    return loss, grads


def make_spmd_train_step(arch_name: str, model, cfg, opt_cfg: OptConfig,
                         mesh, edge_sharded: bool = False):
    """``(step, cfg)``: ``cfg`` with ``spmd_axes`` (every mesh axis) and
    ``edge_sharded`` set, which ``model`` takes too, and
    ``step(model, opt_state, batch)`` for a batch padded by
    :func:`pad_gnn_batch` (or arranged by :func:`edge_shard_triplets`)
    that every rank holds whole.  Each rank takes its shard of the
    sharded fields, runs the loss and its backward, averages the loss and
    the gradients over the mesh and runs the replicated AdamW in place; it
    returns ``(model, opt_state, {"loss", "grad_norm", "step"})``."""
    from repro_torch.configs import get_arch
    from repro_torch.train.trainstep import batch_to

    kw = {"edge_sharded": True} if edge_sharded else {}
    cfg = dataclasses.replace(cfg, spmd_axes=mesh_axes(mesh), **kw)
    model.cfg = cfg
    loss_fn = get_arch(arch_name).loss_fn
    fields = sharded_fields(arch_name, edge_sharded)
    device = next(model.parameters()).device

    def step(params, opt_state, batch):
        if params is not model:
            raise ValueError("a train step trains the model it was built for")
        loss, grads = spmd_value_and_grad(loss_fn, model,
                                          batch_to(batch, device), mesh,
                                          fields)
        _, opt_state, gn = adamw_update(dict(model.named_parameters()),
                                        grads, opt_state, opt_cfg)
        return model, opt_state, {"loss": loss, "grad_norm": gn,
                                  "step": opt_state.step}

    return step, cfg
