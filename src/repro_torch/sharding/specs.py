"""Sharding rules: parameter / optimizer / batch specs per family, the
reference's rules leaf for leaf.

A *spec* is a tuple with one entry a dimension, the content of JAX's
``PartitionSpec``: ``None`` (not sharded), an axis name, or a tuple of
axis names (sharded over their product, the first major).  ``()``
replicates.  :func:`placements` turns a spec into DTensor placements on a
``DeviceMesh`` and :func:`distribute` places a tensor by it.

LM rules (Megatron-style TP + ZeRO-/FSDP-style data sharding):
  - column-parallel projections (wq/wk/wv/w_gate/w_up/w_uq/w_uk/w_uv):
    output dim → ``model``, input dim → ``data`` (ZeRO)
  - row-parallel projections (wo/w_down): input dim → ``model``, output →
    ``data``
  - MoE expert stacks: expert dim → ``model`` (expert parallelism), token
    dims ZeRO-sharded over ``data``
  - embed: vocab → ``model``;  lm_head: d → ``data``, vocab → ``model``
  - norms / small biases: replicated
Optimizer moments inherit the parameter spec (fully-sharded optimizer).

The reference stacks an LM's layers (``[L, ...]`` leaves whose spec leads
with ``None``); the port holds a module a layer (``dense_layers.{i}.*``,
``moe_layers.{i}.*``, the names of ``convert._STACKED``), so a layer's
spec is the reference's stacked spec without its first entry: the rule is
applied to the leaf's shape with a leading layer dimension put back, and
that entry dropped.

GNN rules: parameters replicated (they are tiny); edge arrays sharded over
every mesh axis; node tensors replicated (small graphs) or feature-sharded.

DLRM rules: embedding tables row-sharded over ``model`` when the vocab is
large & divisible (small tables replicated: the standard mixed placement);
MLPs replicated; batch over data axes.

All rules degrade to replication when a dimension is not divisible by the
assigned axis size: the fallback keeps every (arch × mesh) cell placeable.

A mesh here is a ``DeviceMesh`` or any object with ``axis_names`` (or
``mesh_dim_names``) and ``shape`` (a mapping from names to sizes, or a
tuple in the names' order).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

from repro_torch.convert import _STACKED

Spec = tuple


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``): where a restored leaf
    goes (``Checkpointer.restore(..., shardings=...)``)."""
    mesh: Any
    spec: Spec = ()


def mesh_dims(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    names = tuple(getattr(mesh, "mesh_dim_names", None)
                  or getattr(mesh, "axis_names"))
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    dims = mesh_dims(mesh)
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= dims[a]
        return out
    return dims[axis]


def _fits(shape, spec, mesh) -> bool:
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None:
            continue
        if dim % _axis_size(mesh, axis):
            return False
    return True


def _guard(shape, spec, mesh) -> Spec:
    """Use spec if divisible, else progressively drop axes (replicate)."""
    if _fits(shape, spec, mesh):
        return tuple(spec)
    # drop axes one by one from the rightmost constrained dim
    axes = list(tuple(spec))
    for i in reversed(range(len(axes))):
        if axes[i] is not None:
            trial = (*axes[:i], None, *axes[i + 1:])
            if _fits(shape, trial, mesh):
                return trial
            axes[i] = None
    return ()


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

_REPLICATED_NAMES = {"ln1", "ln2", "final_ln", "q_ln", "kv_ln", "q_norm",
                     "k_norm", "bq", "bk", "bv", "ln_g", "ln_b"}
_COL_NAMES = {"wq", "wk", "wv", "w_gate", "w_up", "w_uq", "w_uk", "w_uv"}
_ROW_NAMES = {"wo", "w_down"}
_STACKS = tuple(p.rstrip(".") for p in _STACKED)


def _lm_leaf_spec(path: tuple[str, ...], shape, mesh, dp, zero: bool) -> Spec:
    """The reference's rule on its (stacked) path and shape."""
    name = path[-1]
    stacked = len(path) > 1 and path[0] in _STACKS
    in_moe = "moe" in path and "shared" not in path
    zdp = dp if zero else None

    if name in _REPLICATED_NAMES or len(shape) <= 1 + (1 if stacked else 0):
        return ()
    if name == "embed":
        return _guard(shape, ("model", None), mesh)
    if name == "lm_head":
        return _guard(shape, (zdp, "model"), mesh)
    if name == "router":
        return _guard(shape, (None, zdp, None)[: len(shape)], mesh)

    lead = (None,) if stacked else ()
    if in_moe and name in _COL_NAMES:  # [L, E, d, ff]
        return _guard(shape, (*lead, "model", zdp, None), mesh)
    if in_moe and name in _ROW_NAMES:  # [L, E, ff, d]
        return _guard(shape, (*lead, "model", None, zdp), mesh)
    if name in _COL_NAMES:  # [L, d_in, d_out]
        return _guard(shape, (*lead, zdp, "model"), mesh)
    if name in _ROW_NAMES:  # [L, d_in, d_out] row-parallel
        return _guard(shape, (*lead, "model", zdp), mesh)
    if name in ("w_dq", "w_dkv", "w_kr"):  # small down-projections
        return _guard(shape, (*lead, zdp, None), mesh)
    return ()


def _port_lm_spec(name: str, shape, mesh, dp, zero: bool) -> Spec:
    """A port leaf's spec: a layer's leaf (``dense_layers.{i}.*``) takes
    the reference's spec for its stack with the layer entry dropped."""
    path = tuple(name.split("."))
    if len(path) > 2 and path[0] in _STACKS and path[1].isdigit():
        spec = _lm_leaf_spec((path[0],) + path[2:], (1,) + tuple(shape),
                             mesh, dp, zero)
        return spec[1:]
    return _lm_leaf_spec(path, tuple(shape), mesh, dp, zero)


def _shapes(named) -> dict[str, tuple]:
    """Name -> shape of a module's parameters or of a mapping of tensors
    (or shapes)."""
    if hasattr(named, "named_parameters"):
        named = dict(named.named_parameters())
    return {k: tuple(v.shape) if hasattr(v, "shape") else tuple(v)
            for k, v in named.items()}


def param_specs(named, family: str, mesh, *, zero: bool = True) -> dict:
    """Parameter name -> spec for a module (or a mapping of names to
    tensors or shapes) of ``family``."""
    dp = "data"  # ZeRO axis; pod stays pure DP (gradients all-reduced)
    out = {}
    for name, shape in _shapes(named).items():
        if family == "lm":
            out[name] = _port_lm_spec(name, shape, mesh, dp, zero)
        elif family == "recsys":
            path = name.split(".")
            if "tables" in path and len(shape) == 2 and shape[0] >= 4096:
                out[name] = _guard(shape, ("model", None), mesh)
            else:
                out[name] = ()
        else:  # gnn & default: replicate
            out[name] = ()
    return out


def opt_state_specs(param_spec_tree: dict, opt_state) -> Any:
    """AdamW moments inherit their parameter's spec; step scalar replicated."""
    from repro_torch.train.optimizer import AdamWState

    return AdamWState(
        step=(),
        mu=param_spec_tree,
        nu=param_spec_tree,
        err=param_spec_tree if opt_state.err is not None else None,
    )


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def batch_specs(arch_family: str, cell_kind: str, batch, mesh,
                seq_shard: bool = False) -> dict:
    """Spec of each leaf of one cell's batch (a dict of tensors or shapes,
    possibly nested, as a decode cell's ``cache``), shaped like it."""
    names = tuple(mesh_dims(mesh))
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    every = tuple(a for a in ("pod", "data", "model") if a in names)

    def leaf(name: str, shape) -> Spec:
        if arch_family == "lm":
            if name in ("tokens", "labels"):
                spec = (dp, "model") if (seq_shard and len(shape) == 2
                                         and shape[1] > 1) else (dp,)
                return _guard(shape, spec, mesh)
            if name in ("k", "v"):  # [L, B, T, H, Dh]
                if shape[1] == 1:  # batch-1 long-context: sequence-shard
                    return _guard(shape, (None, None, every, None, None),
                                  mesh)
                return _guard(shape, (None, dp, "model", None, None), mesh)
            if name in ("ckv", "krope"):  # [L, B, T, C]
                if shape[1] == 1:
                    return _guard(shape, (None, None, every, None), mesh)
                return _guard(shape, (None, dp, "model", None), mesh)
            return ()
        if arch_family == "gnn":
            if name in ("edge_src", "edge_dst", "t_kj", "t_ji"):
                return _guard(shape, (every,), mesh)
            if name == "edge_attr":
                return _guard(shape, (every, None), mesh)
            if name in ("x",) and len(shape) == 2:
                return _guard(shape, (None, "model"), mesh)
            return ()
        if arch_family == "recsys":
            if name == "cand":
                return _guard(shape, (every, None), mesh)
            if name in ("dense", "sparse", "labels"):
                return _guard(shape, (dp,), mesh)
            return ()
        return ()

    def walk(tree):
        return {k: walk(v) if isinstance(v, Mapping)
                else leaf(k, tuple(v.shape) if hasattr(v, "shape")
                          else tuple(v))
                for k, v in tree.items()}

    return walk(batch)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(d)`` for the tensor dimension ``d`` its name shards, else
    ``Replicate()``.  A dimension sharded over several axes lists them
    major first, and DTensor splits it over those mesh dimensions in the
    mesh's order, so their mesh order must be the spec's (``("pod",
    "data")`` is)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        dims = [names.index(a)
                for a in (axis if isinstance(axis, tuple) else (axis,))]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axis} are not in the "
                             f"mesh's order {names}")
        for k in dims:
            out[k] = Shard(d)
    return out


def distribute(t, mesh, spec: Spec):
    """``t`` (the same full tensor on every rank) as a DTensor placed by
    ``spec``, each rank keeping its own slice."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def full(t):
    """A DTensor's full value on every rank (a collective); a plain tensor
    as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t
