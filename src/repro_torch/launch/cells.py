"""Cell builders: (arch × shape × mesh) → an eager step + its abstract
arguments + their placements.  Shared by the dry run, the roofline
analyzer and the perf harness.

``build_cell`` returns ``{"step", "args", "family", "cfg"}`` and how the
arguments are placed on the mesh:

- ``args``: ``meta`` tensors of the cell's global shapes (a module built
  on ``meta`` for the parameters, an ``AdamWState`` of ``meta`` moments,
  the batch, a decode cell's cache), the reference's abstract arguments
  leaf for leaf;
- ``specs``: a spec tree a argument (``sharding.specs``: the reference's
  ``in_shardings``), or ``None`` for an argument every rank holds whole;
- ``place``: ``"dtensor"`` (the step runs on DTensors placed by
  ``specs``: the LM's DP+TP step), ``"local"`` (the step takes each
  rank's local shard of ``specs`` and moves data itself: DLRM's sharded
  tables, the GNN baseline's sharded batch, the engine) or ``None``
  (every argument whole: the GNN's explicit-SPMD profiles, which shard
  inside the step);
- ``consts``: 0-d integer leaves the step reads as Python values (a
  decode cache's ``pos``), by name.

``step`` builds its inner train step on its first call, from the module
it is given (a train step keeps its module's device).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import get_arch
from repro_torch.sharding.specs import (batch_specs, opt_state_specs,
                                        param_specs, placements)
from repro_torch.train.optimizer import OptConfig, adamw_init


def _dp(mesh):
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def _lm_cell(arch, cell_name: str, mesh, opt_cfg: OptConfig,
             lm_depth, profile: str) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.common import lm_input_specs
    from repro_torch.models import transformer
    from repro_torch.sharding.lm import make_dp_tp_train_step

    cfg = arch.config_for(cell_name)
    cell = arch.cells[cell_name]
    dp = _dp(mesh)
    # profile grammar: <act_mode>[+bf16logits][+dots][+noremat]
    parts = profile.split("+")
    act_specs = {
        "baseline": (dp, None, "model"),
        "act_replicated": (dp, None, None),
        "act_seq": (dp, "model", None),
    }
    cfg = dataclasses.replace(
        cfg, act_spec=act_specs[parts[0]], logits_spec=(dp, None, "model"),
        attn_fp32_logits="bf16logits" not in parts,
        remat="noremat" not in parts,
        remat_policy="dots" if "dots" in parts else "full")
    if lm_depth is not None:
        nd, nm = lm_depth
        moe = cfg.moe
        if moe is not None:
            moe = dataclasses.replace(moe, first_dense_layers=nd)
        cfg = dataclasses.replace(cfg, n_layers=nd + nm, moe=moe,
                                  unroll_layers=True)
    batch_abs = lm_input_specs(cfg, cell_name)
    model = transformer.TransformerLM(cfg, device="meta")
    pspecs = param_specs(model, "lm", mesh)
    out = {"family": "lm", "cfg": cfg, "place": "dtensor"}

    if cell.kind == "train":
        opt_abs = adamw_init(dict(model.named_parameters()), opt_cfg)

        def train(m, opt_state, batch):
            return make_dp_tp_train_step(transformer.loss_fn, m, opt_cfg)(
                m, opt_state, batch)

        return {**out, "step": train, "args": (model, opt_abs, batch_abs),
                "specs": (pspecs, opt_state_specs(pspecs, opt_abs),
                          batch_specs("lm", "train", batch_abs, mesh))}
    if cell.kind == "prefill":
        @torch.no_grad()
        def prefill(m, batch):
            with implicit_replication():
                return transformer.forward(m, batch["tokens"])[0]

        return {**out, "step": prefill, "args": (model, batch_abs),
                "specs": (pspecs,
                          batch_specs("lm", "prefill", batch_abs, mesh))}
    cache_abs = batch_abs.pop("cache")

    def decode(m, cache, batch):
        with implicit_replication():
            return transformer.decode_step(m, cache, batch["tokens"])

    return {**out, "step": decode, "args": (model, cache_abs, batch_abs),
            "specs": (pspecs, batch_specs("lm", "decode", cache_abs, mesh),
                      batch_specs("lm", "decode", batch_abs, mesh)),
            # the cache is full but for the step's own token
            "consts": {"pos": cache_abs["k" if "k" in cache_abs
                                        else "ckv"].shape[2] - 1}}


def _gathered(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard ``t`` of ``spec``, gathered whole on every rank
    (an all-gather a sharded dimension)."""
    if not spec or all(a is None for a in spec):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, placements(tuple(spec), mesh),
                              run_check=False).full_tensor()


def _gnn_cell(arch, arch_name: str, cell_name: str, mesh,
              opt_cfg: OptConfig, profile: str) -> dict:
    from repro_torch.train.trainstep import make_train_step

    cfg = arch.config_for(cell_name)
    batch_abs = arch.input_specs(cell_name)
    if profile in ("shard_map", "shard_map_v2"):
        from repro_torch.sharding.gnn_spmd import (make_spmd_train_step,
                                                   mesh_axes, n_shards_of,
                                                   pad_gnn_batch_abstract)

        ns = n_shards_of(mesh)
        n_seg = batch_abs["edge_src"].shape[0] if arch_name == "dimenet" \
            else (batch_abs["x"].shape[0] if "x" in batch_abs
                  else batch_abs["pos"].shape[0])
        v2 = profile == "shard_map_v2"
        batch_abs = pad_gnn_batch_abstract(arch_name, batch_abs, ns, n_seg)
        if v2:
            # edge arrays must also divide the shard count
            for f in ("edge_src", "edge_dst"):
                x = batch_abs[f]
                pad = (-x.shape[0]) % ns
                if pad:
                    batch_abs[f] = torch.empty((x.shape[0] + pad,),
                                               dtype=x.dtype, device="meta")
        kw = {"edge_sharded": True} if v2 else {}
        cfg2 = dataclasses.replace(cfg, spmd_axes=mesh_axes(mesh), **kw)
        model = arch.model(cfg2, device="meta")
        opt_abs = adamw_init(dict(model.named_parameters()), opt_cfg)

        def spmd(m, opt_state, batch):
            step, _ = make_spmd_train_step(arch_name, m, cfg, opt_cfg, mesh,
                                           edge_sharded=v2)
            return step(m, opt_state, batch)

        return {"step": spmd, "args": (model, opt_abs, batch_abs),
                "specs": None, "place": None, "family": "gnn", "cfg": cfg2}
    # baseline: the batch sharded by batch_specs (edges over every axis,
    # features over model), parameters replicated; DTensor has no rule for
    # the edge scatter, so the step gathers the batch whole on every rank
    # and runs the replicated step
    model = arch.model(cfg, device="meta")
    opt_abs = adamw_init(dict(model.named_parameters()), opt_cfg)
    bspecs = batch_specs("gnn", "train", batch_abs, mesh)

    def baseline(m, opt_state, batch):
        whole = {k: _gathered(v, bspecs[k], mesh) for k, v in batch.items()}
        return make_train_step(arch.loss_fn, m, opt_cfg)(m, opt_state, whole)

    return {"step": baseline, "args": (model, opt_abs, batch_abs),
            "specs": (None, None, bspecs), "place": "local",
            "family": "gnn", "cfg": cfg}


def _recsys_cell(arch, cell_name: str, mesh, opt_cfg: OptConfig) -> dict:
    from repro_torch.sharding.recsys import make_sharded_step

    cfg = arch.config_for(cell_name)
    cell = arch.cells[cell_name]
    batch_abs = arch.input_specs(cell_name)
    model = arch.model(cfg, device="meta")
    pspecs = param_specs(model, "recsys", mesh)
    bspecs = batch_specs("recsys", cell.kind, batch_abs, mesh)
    out = {"family": "recsys", "cfg": cfg, "place": "local"}
    if cell.kind == "train":
        opt_abs = adamw_init(dict(model.named_parameters()), opt_cfg)
        step = make_sharded_step(model, mesh, pspecs, "train", opt_cfg)
        return {**out, "step": step, "args": (model, opt_abs, batch_abs),
                "specs": (pspecs, opt_state_specs(pspecs, opt_abs), bspecs)}
    step = make_sharded_step(model, mesh, pspecs, cell.kind)
    return {**out, "step": step, "args": (model, batch_abs),
            "specs": (pspecs, bspecs)}


def build_cell(arch_name: str, cell_name: str, mesh,
               opt_cfg: OptConfig | None = None,
               lm_depth: tuple[int, int] | None = None,
               profile: str = "baseline") -> dict[str, Any]:
    """The cell's step and abstract arguments on ``mesh`` (see the
    module's docstring).

    ``lm_depth=(n_dense_layers, n_moe_layers)``: a depth override, which
    the dry run and the perf harness trace at and extrapolate from.

    ``profile``: sharding/optimization profile (the reference's knobs):
      LM:  "baseline"       activations model-sharded between blocks
           "act_replicated" Megatron-style: activations replicated across
                            `model`, one all-reduce per row-parallel matmul
           "act_seq"        sequence-parallel flavor: activations sharded on
                            the sequence dim between blocks
           each optionally ``+bf16logits``, ``+dots``, ``+noremat``
      GNN: "baseline"       the batch sharded, gathered whole by the step
           "shard_map"      explicit SPMD: local segment_sum + psum
           "shard_map_v2"   DimeNet's edge-sharded form
    """
    arch = get_arch(arch_name)
    opt_cfg = opt_cfg or OptConfig()
    if arch.family == "engine":
        from repro_torch.core.distributed import engine_cell

        step, args = engine_cell(mesh, arch.config,
                                 arch.cells[cell_name].meta)
        return {"step": step, "args": args, "specs": None, "place": None,
                "family": "engine", "cfg": arch.config}
    if arch.family == "lm":
        return _lm_cell(arch, cell_name, mesh, opt_cfg, lm_depth, profile)
    if arch.family == "gnn":
        return _gnn_cell(arch, arch_name, cell_name, mesh, opt_cfg, profile)
    return _recsys_cell(arch, cell_name, mesh, opt_cfg)
