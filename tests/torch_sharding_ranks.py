"""The rank program of ``test_torch_sharding.py``'s one 4-rank gloo world.

It imports no JAX and nothing of ``repro``: the parent test computes the
reference's single-device results in its own process and hands every
rank the same inputs (weights as numpy arrays, batches); each rank runs
every multi-rank case of the port and returns numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

AGG_AXES = ("data", "model")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _model(arch, cfg, state: dict):
    from repro_torch.launch.train import model_for

    model = model_for(arch, cfg, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def placement_order(device: str) -> dict:
    """A dimension sharded over ``("pod", "data")``: the local block of
    ``arange(8)`` on each rank."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding.specs import distribute

    mesh = init_device_mesh(device, (2, 2), mesh_dim_names=("pod", "data"))
    dt = distribute(torch.arange(8, dtype=torch.float32), mesh,
                    (("pod", "data"),))
    return {"pod_data_local": _np(dt.to_local())}


def aggregations(rank: int, mesh, case: dict) -> dict:
    """Each ``*_spmd`` aggregation on this rank's quarter of the edges:
    its output, and the gradient of ``sum(out · w)`` (finite entries)
    with respect to this rank's ``x``."""
    from repro_torch.models.gnn import common
    from repro_torch.sharding.comm import mesh_scope

    x = torch.from_numpy(case["x"])
    seg = torch.from_numpy(case["seg"])
    w = torch.from_numpy(case["w"])
    n, per = case["n"], x.shape[0] // 4
    xl = x[rank * per:(rank + 1) * per].clone().requires_grad_(True)
    sl = seg[rank * per:(rank + 1) * per]
    out = {}
    with mesh_scope(mesh):
        for op in ("sum", "mean", "max", "min", "std"):
            fn = getattr(common, f"segment_{op}_spmd")
            y = fn(xl, sl, n, AGG_AXES)
            loss = torch.sum(torch.where(torch.isfinite(y), y, 0.0) * w)
            (g,) = torch.autograd.grad(loss, [xl])
            out[f"agg_{op}"] = _np(y)
            out[f"agg_{op}_grad"] = _np(g)
        out["agg_degrees"] = _np(common.degrees_spmd(sl, n, AGG_AXES))
    return out


def gnn_steps(mesh, inputs: dict, mesh_1d) -> dict:
    """The four GNNs' SPMD gradients and one SPMD AdamW step over the
    (2, 2) mesh, and DimeNet v2 (edge-sharded) over 4 shards."""
    from repro_torch.configs import get_arch
    from repro_torch.sharding import gnn_spmd
    from repro_torch.train.optimizer import OptConfig, adamw_init

    opt_cfg = OptConfig(**inputs["gnn_opt"])
    out = {}
    for name, case in inputs["gnn"].items():
        v2 = name == "dimenet-v2"
        arch = get_arch("dimenet" if v2 else name)
        cfg, batch = arch.smoke()
        model = _model(arch, cfg, case["params"])
        if v2:
            pb = gnn_spmd.edge_shard_triplets(batch, 4)
            step, _ = gnn_spmd.make_spmd_train_step(
                "dimenet", model, cfg, opt_cfg, mesh_1d, edge_sharded=True)
            fields = gnn_spmd.sharded_fields("dimenet", True)
            on = mesh_1d
        else:
            pb = gnn_spmd.pad_gnn_batch(name, batch, 4, case["n_seg"])
            step, _ = gnn_spmd.make_spmd_train_step(name, model, cfg,
                                                    opt_cfg, mesh)
            fields = gnn_spmd.sharded_fields(name)
            on = mesh
        loss, grads = gnn_spmd.spmd_value_and_grad(arch.loss_fn, model, pb,
                                                   on, fields)
        out[f"{name}/loss"] = float(loss)
        out[f"{name}/grads"] = {k: _np(g) for k, g in grads.items()}
        opt = adamw_init(dict(model.named_parameters()), opt_cfg)
        _, opt, metrics = step(model, opt, pb)
        out[f"{name}/step_loss"] = float(metrics["loss"])
        out[f"{name}/step"] = int(metrics["step"])
        out[f"{name}/params"] = {k: _np(p)
                                 for k, p in model.named_parameters()}
    return out


def lm_dp_tp(mesh, inputs: dict) -> dict:
    """The DP+TP step of ``qwen3-8b``'s smoke config in float32 on DTensor
    parameters, moments and batch: its loss and gradients (the full
    tensors), the loss under the sharding hints, then one AdamW step."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.models.layers import cross_entropy_loss
    from repro_torch.sharding import lm
    from repro_torch.sharding.specs import full
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainstep import value_and_grad

    case = inputs["dp_tp"]
    arch = get_arch("qwen3-8b")
    cfg, batch = arch.smoke()
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = _model(arch, cfg, case["params"])
    opt_cfg = OptConfig(**case["opt"])
    specs = lm.shard_module(model, mesh)
    opt = lm.shard_opt_state(adamw_init(
        {k: full(p) for k, p in model.named_parameters()}, opt_cfg), specs,
        mesh)
    step = lm.make_dp_tp_train_step(transformer.loss_fn, model, opt_cfg)
    sbatch = lm.shard_batch(batch, mesh)
    # the hints redistribute the activations and the logits (batch over
    # data, the rest replicated) and leave the loss as it is
    hinted = dataclasses.replace(cfg, act_spec=("data", None, None),
                                 logits_spec=("data", None, None))
    with implicit_replication():
        plain_loss, grads = value_and_grad(transformer.loss_fn, model,
                                           sbatch)
        model.cfg = hinted
        with torch.no_grad():
            logits, _ = transformer.forward(model, sbatch["tokens"])
        model.cfg = cfg
        hinted_loss = cross_entropy_loss(logits, sbatch["labels"])
    grads = {k: _np(full(g)) for k, g in grads.items()}
    _, opt, metrics = step(model, opt, sbatch)
    placed = {k: [str(p) for p in t.placements]
              for k, t in model.named_parameters()}
    return {"dp_tp/loss": float(full(metrics["loss"])),
            "dp_tp/grad_norm": float(full(metrics["grad_norm"])),
            "dp_tp/grads": grads,
            "dp_tp/plain_loss": float(full(plain_loss)),
            "dp_tp/hinted_loss": float(full(hinted_loss)),
            "dp_tp/logits_placements": [str(p) for p in logits.placements],
            "dp_tp/params": {k: _np(full(p))
                             for k, p in model.named_parameters()},
            "dp_tp/placements": placed,
            "dp_tp/local_shapes": {k: tuple(p.to_local().shape)
                                   for k, p in model.named_parameters()}}


def moe_dp_tp(mesh, inputs: dict) -> dict:
    """The DP+TP step of ``deepseek-v2-236b``'s smoke config (MLA, one
    dense and one MoE layer, 4 experts top-2) in float32: the experts
    sharded over ``model`` by the specs, the routed part per rank
    (``moe._moe_sharded``); its gradients (the full tensors) and one AdamW
    step's loss, gradient norm and parameters."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.sharding import lm
    from repro_torch.sharding.specs import full
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainstep import value_and_grad

    case = inputs["moe"]
    arch = get_arch("deepseek-v2-236b")
    cfg, batch = arch.smoke()
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = _model(arch, cfg, case["params"])
    opt_cfg = OptConfig(**case["opt"])
    specs = lm.shard_module(model, mesh)
    opt = lm.shard_opt_state(adamw_init(
        {k: full(p) for k, p in model.named_parameters()}, opt_cfg), specs,
        mesh)
    step = lm.make_dp_tp_train_step(transformer.loss_fn, model, opt_cfg)
    sbatch = lm.shard_batch(batch, mesh)
    with implicit_replication():
        _, grads = value_and_grad(transformer.loss_fn, model, sbatch)
    grads = {k: _np(full(g)) for k, g in grads.items()}
    _, opt, metrics = step(model, opt, sbatch)
    return {"moe/loss": float(full(metrics["loss"])),
            "moe/grad_norm": float(full(metrics["grad_norm"])),
            "moe/grads": grads,
            "moe/params": {k: _np(full(p))
                           for k, p in model.named_parameters()},
            "moe/expert_placements": [
                str(p) for p in model.moe_layers[0].moe.w_gate.placements]}


def dlrm_config():
    """DLRM's smoke widths with four fields, two of whose tables (8192 and
    4096 rows) the recsys specs row-shard over a 2-wide ``model`` axis."""
    from repro_torch.configs.dlrm_rm2 import SMALL

    return dataclasses.replace(SMALL, n_sparse=4,
                               vocab_sizes=(8192, 64, 4096, 100))


def dlrm_sharded(mesh, inputs: dict) -> dict:
    """DLRM's explicit-SPMD steps (``sharding.recsys``) over ``(data 2,
    model 2)``: this rank's serve logits and retrieval scores, the train
    loss's gradients (after the data-parallel mean; a sharded table's
    gathered over ``model``), and two AdamW steps' losses, gradient norms
    and parameters (whole tables)."""
    import torch.distributed as dist
    from torch import nn

    from repro_torch.models.recsys import dlrm
    from repro_torch.sharding.comm import mesh_scope, pmean_
    from repro_torch.sharding.recsys import (embed_bags_sharded,
                                             make_sharded_step,
                                             sharded_tables)
    from repro_torch.sharding.specs import param_specs
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainstep import value_and_grad

    case = inputs["dlrm"]
    cfg = dlrm_config()
    model = dlrm.DLRM(cfg)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["params"].items()})
    specs = param_specs(model, "recsys", mesh)
    sharded = sharded_tables(specs, cfg.n_sparse)
    m, d = mesh.get_local_rank("model"), mesh.get_local_rank("data")
    group = mesh.get_group("model")
    for i, s in enumerate(sharded):
        if s:
            rows = model.tables[i].shape[0] // 2
            model.tables[i] = nn.Parameter(
                model.tables[i].detach()[m * rows:(m + 1) * rows].clone())
    names = {f"tables.{i}" for i, s in enumerate(sharded) if s}

    def whole(tree: dict) -> dict:
        out = {}
        for k, t in tree.items():
            if k in names:
                parts = [torch.empty_like(t) for _ in range(2)]
                dist.all_gather(parts, t.detach().contiguous(), group=group)
                t = torch.cat(parts)
            out[k] = _np(t)
        return out

    b = case["batch"]["labels"].shape[0] // 2
    local = {k: torch.from_numpy(v[d * b:(d + 1) * b])
             for k, v in case["batch"].items()}
    r = d * 2 + m  # the candidates' block: ("data", "model") data-major
    n = case["retrieval"]["cand"].shape[0] // 4
    ret = {k: torch.from_numpy(v[r * n:(r + 1) * n] if k == "cand" else v)
           for k, v in case["retrieval"].items()}
    out = {"dlrm/sharded": sharded, "dlrm/data_rank": d, "dlrm/block": r,
           "dlrm/serve": _np(make_sharded_step(model, mesh, specs, "serve")(
               model, local)),
           "dlrm/retrieval": _np(make_sharded_step(
               model, mesh, specs, "retrieval")(model, ret))}

    def loss(mod, batch):
        return dlrm.loss_fn(mod, batch, embed_bags_sharded(
            mod.tables, batch["sparse"], cfg.dtype, sharded, mesh))

    with mesh_scope(mesh):
        _, grads = value_and_grad(loss, model, local)
        pmean_(grads.values(), ("data",))
    out["dlrm/grads"] = whole(grads)
    opt_cfg = OptConfig(**case["opt"])
    step = make_sharded_step(model, mesh, specs, "train", opt_cfg)
    opt = adamw_init(dict(model.named_parameters()), opt_cfg)
    for i in range(2):
        _, opt, metrics = step(model, opt, local)
        out[f"dlrm/loss{i}"] = float(metrics["loss"])
        out[f"dlrm/grad_norm{i}"] = float(metrics["grad_norm"])
    out["dlrm/params"] = whole(dict(model.named_parameters()))
    return out


def pipeline(mesh_pod, inputs: dict) -> dict:
    """``pipelined_loss`` over 4 stages of ``("pod",)`` with 2
    microbatches (its gradients averaged over the stages), then one step
    of ``make_pipeline_train_step``."""
    from repro_torch.configs import get_arch
    from repro_torch.sharding.comm import mesh_scope, pmean_
    from repro_torch.sharding.pipeline import (make_pipeline_train_step,
                                               pipelined_loss)
    from repro_torch.train.optimizer import OptConfig, adamw_init

    case = inputs["pipe"]
    arch = get_arch("qwen3-8b")
    cfg, batch = arch.smoke()
    cfg = dataclasses.replace(cfg, compute_dtype="float32", n_layers=4,
                              remat=False)
    model = _model(arch, cfg, case["params"])
    params = dict(model.named_parameters())
    with mesh_scope(mesh_pod):
        loss = pipelined_loss(model, batch, cfg, n_stages=4,
                              n_microbatches=2)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    materialize_grads=True,
                                    allow_unused=True)
        pmean_(grads, "pod")
    out = {"pipe/loss": float(loss.detach()),
           "pipe/grads": {k: _np(g) for k, g in zip(params, grads)}}
    opt_cfg = OptConfig(**case["opt"])
    step = make_pipeline_train_step(model, cfg, opt_cfg, mesh_pod,
                                    n_microbatches=2)
    _, _, metrics = step(model, adamw_init(params, opt_cfg), batch)
    out["pipe/step_loss"] = float(metrics["loss"])
    out["pipe/step_grad_norm"] = float(metrics["grad_norm"])
    out["pipe/step_params"] = {k: _np(p)
                               for k, p in model.named_parameters()}
    return out


def adamw_group(rank: int, mesh_1d, inputs: dict) -> dict:
    """``adamw_update(group=...)`` with rank-dependent gradients, with and
    without int8 compression."""
    from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update

    case = inputs["adamw"]
    out = {}
    for compress in (False, True):
        cfg = OptConfig(**case["opt"], grad_compress=compress)
        params = {k: torch.from_numpy(v.copy())
                  for k, v in case["params"].items()}
        grads = {k: torch.from_numpy(v[rank].copy())
                 for k, v in case["grads"].items()}
        state = adamw_init(params, cfg)
        _, state, gn = adamw_update(params, grads, state, cfg,
                                    group=mesh_1d.get_group("data"))
        tag = f"adamw/{int(compress)}"
        out[f"{tag}/params"] = {k: _np(p) for k, p in params.items()}
        out[f"{tag}/gn"] = float(gn)
        if compress:
            out[f"{tag}/err"] = {k: _np(e) for k, e in state.err.items()}
    return out


def elastic(device: str, inputs: dict) -> dict:
    """Save a tree sharded over a (2, 2) mesh, restore it onto the
    elastic mesh of the same 4 ranks with another spec."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.sharding.specs import NamedSharding, distribute
    from repro_torch.train.checkpoint import Checkpointer

    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mesh1 = init_device_mesh(device, (2, 2), mesh_dim_names=("data", "model"))
    ck = Checkpointer(inputs["ckpt_dir"], keep=2)
    ck.save(7, {"params": {"w": distribute(w, mesh1, ("data", "model"))}})
    dist.barrier()
    mesh2 = make_elastic_mesh(model_parallelism=4, device=device)
    step, trees, _ = ck.restore(
        {"params": {"w": torch.zeros(8, 8)}},
        shardings={"params": {"w": NamedSharding(mesh2, ("model", "data"))}})
    got = trees["params"]["w"]
    return {"elastic/step": step, "elastic/full": _np(got.full_tensor()),
            "elastic/local": _np(got.to_local()),
            "elastic/mesh": tuple(mesh2.mesh.shape),
            "elastic/placements": [str(p) for p in got.placements]}


def all_cases(rank: int, world: int, device: str, inputs: dict) -> dict:
    """Every multi-rank case, on one rank of the 4-rank world."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(device, (2, 2), mesh_dim_names=AGG_AXES)
    mesh_data = init_device_mesh(device, (4,), mesh_dim_names=("data",))
    mesh_pod = init_device_mesh(device, (4,), mesh_dim_names=("pod",))
    out = {}
    out.update(placement_order(device))
    out.update(aggregations(rank, mesh, inputs["agg"]))
    out.update(gnn_steps(mesh, inputs, mesh_data))
    out.update(lm_dp_tp(mesh, inputs))
    out.update(moe_dp_tp(mesh, inputs))
    out.update(dlrm_sharded(mesh, inputs))
    out.update(pipeline(mesh_pod, inputs))
    out.update(adamw_group(rank, mesh_data, inputs))
    out.update(elastic(device, inputs))
    return out
