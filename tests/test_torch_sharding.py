"""The port's sharded training layer against the reference on the CPU.

- Specs: ``param_specs`` / ``opt_state_specs`` / ``batch_specs`` of every
  reference arch at its full abstract shapes over ``(16, 16)``, ``(2, 16,
  16)`` and ``(2, 4)`` meshes, leaf for leaf and exactly (a layer's spec
  is the reference's stacked spec without its layer entry); both
  production meshes formed on a fake process group; GNN batch padding.
- One 4-rank gloo world for the whole file (``torch_sharding_ranks``, a
  module that imports no JAX) runs every multi-rank case; the parent
  holds what the ranks return against the reference's single-device
  results computed here: the ``*_spmd`` aggregations (cross-shard ties,
  empty segments) forward and backward, the four GNN SPMD steps over
  ``(2, 2)`` and DimeNet v2 at 4 shards, the DP+TP step of ``qwen3-8b``'s
  smoke config in float32 over ``(2, 2)``, ``pipelined_loss`` over 4
  stages of ``("pod",)``, ``adamw_update(group=...)`` and the elastic
  restore; the DP+TP step of ``deepseek-v2-236b``'s smoke config (MLA,
  experts sharded over ``model``) and DLRM's explicit-SPMD train, serve
  and retrieval steps (tables row-sharded over ``model``) against the
  port's plain steps.

Tolerances are the reference's own tests' (``tests/test_distributed.py``)
or tighter, stated where used.
"""

import dataclasses
import functools
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_sharding_ranks
from repro.configs import ASSIGNED
from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as ref_tf
from repro.models.gnn import common as ref_common
from repro.models.gnn import dimenet as ref_dimenet
from repro.models.gnn import gcn as ref_gcn
from repro.models.gnn import meshgraphnet as ref_mgn
from repro.models.gnn import pna as ref_pna
from repro.models.recsys import dlrm as ref_dlrm
from repro.sharding import gnn_spmd as ref_gnn_spmd
from repro.sharding import specs as ref_specs
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch.sharded import spawn_world
from repro_torch.launch.train import model_for
from repro_torch.sharding import gnn_spmd, specs
from repro_torch.train.optimizer import AdamWState

GNNS = ("gcn-cora", "pna", "meshgraphnet", "dimenet")
AGG_OPS = ("sum", "mean", "max", "min", "std")
GNN_MODULES = {"gcn-cora": ref_gcn, "pna": ref_pna,
               "meshgraphnet": ref_mgn, "dimenet": ref_dimenet}
# the reference's test_gnn_spmd_matches_single_device limits: the largest
# relative leaf norm of the gradient difference
GNN_GRAD_REL = {"gcn-cora": 1e-4, "pna": 1e-3, "meshgraphnet": 1e-4,
                "dimenet": 1e-4, "dimenet-v2": 1e-4}
# after one AdamW step (lr 1e-3): test_torch_gnn.py's STEP_PARAMS, but for
# an element whose gradient is below NOISE_GRAD, whose update is noise and
# may differ by up to 2·lr
STEP_PARAMS = dict(rtol=1e-4, atol=1e-5)
NOISE_GRAD = 1e-6
GNN_OPT = dict(lr=1e-3, warmup_steps=1)
LM_OPT = dict(lr=1e-3, warmup_steps=1)
# the LM steps' gradients: the largest relative leaf norm of the
# difference (the GNN SPMD limit) and the gradient norm; their first
# AdamW update by norm (a zero gradient is 1 off, a flipped sign 2)
LM_GRAD_REL = 1e-4
LM_UPDATE_REL = 1e-2
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}


def _mesh(dims: dict):
    """What both packages' spec rules read of a mesh."""
    return SimpleNamespace(shape=dict(dims), axis_names=tuple(dims))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- specs

_INIT = {"lm": ref_tf.init_params, "recsys": ref_dlrm.init_params}


@functools.lru_cache(maxsize=None)
def _ref_abstract(name: str):
    arch = ref_get_arch(name)
    init = _INIT.get(arch.family) or GNN_MODULES[name].init_params
    return arch.abstract_params(init)


def _ref_named(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {".".join(ref_specs._path_names(kp)): tuple(s) for kp, s in flat}


def _port_named_want(ref: dict, port_names) -> dict:
    """The reference's specs under the port's names: a layer's leaf
    (``dense_layers.{i}.<leaf>``) takes its stack's spec without the layer
    entry."""
    want = {}
    for name in port_names:
        parts = name.split(".")
        if parts[0] in ("dense_layers", "moe_layers") and parts[1].isdigit():
            want[name] = ref[".".join([parts[0]] + parts[2:])][1:]
        else:
            want[name] = ref[name]
    return want


@pytest.mark.parametrize("name", ASSIGNED)
def test_specs_match_reference(name):
    """Every parameter's, moment's and batch leaf's spec equals the
    reference's at the published config, over the three meshes."""
    arch = get_arch(name)
    model = arch.abstract_params(
        lambda cfg, device: model_for(arch, cfg, device, None))
    ref_abs = _ref_abstract(name)
    ref_arch = ref_get_arch(name)
    for mesh_name, dims in MESHES.items():
        mesh = _mesh(dims)
        for zero in (True, False):
            got = specs.param_specs(model, arch.family, mesh, zero=zero)
            ref = _ref_named(ref_specs.param_specs(ref_abs, arch.family,
                                                   mesh, zero=zero))
            assert got == _port_named_want(ref, got), (mesh_name, zero)
        pspecs = specs.param_specs(model, arch.family, mesh)
        for err in (None, {}):
            ost = specs.opt_state_specs(
                pspecs, AdamWState(None, {}, {}, err))
            ref_ost = ref_specs.opt_state_specs(
                ref_specs.param_specs(ref_abs, arch.family, mesh),
                ref_opt.AdamWState(None, {}, {}, err))
            assert ost.step == tuple(ref_ost.step) == ()
            assert ost.mu is pspecs and ost.nu is pspecs
            assert (ost.err is None) == (ref_ost.err is None)
        for cell in arch.cells:
            kind = arch.cells[cell].kind
            for seq_shard in (False, True):
                got = specs.batch_specs(arch.family, kind,
                                        arch.input_specs(cell), mesh,
                                        seq_shard=seq_shard)
                ref = ref_specs.batch_specs(arch.family, kind,
                                            ref_arch.input_specs(cell),
                                            mesh, seq_shard=seq_shard)
                flat = {}
                for k, v in got.items():
                    if isinstance(v, dict):
                        flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
                    else:
                        flat[k] = v
                assert flat == _ref_named(ref), (mesh_name, cell, seq_shard)


def test_production_meshes_form_on_fake_process_group():
    """``(16, 16)`` and ``(2, 16, 16)`` DeviceMeshes on a fake process
    group of 512 ranks, with the reference's axis names; the specs read
    their sizes as they read the plain meshes'."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import (dp_axes, elastic_shape,
                                         make_elastic_mesh,
                                         make_production_mesh)

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        one = make_production_mesh(device="cpu")
        two = make_production_mesh(multi_pod=True, device="cpu")
        assert one.mesh_dim_names == ("data", "model")
        assert tuple(one.mesh.shape) == (16, 16)
        assert two.mesh_dim_names == ("pod", "data", "model")
        assert tuple(two.mesh.shape) == (2, 16, 16)
        assert dp_axes(one) == ("data",)
        assert dp_axes(two) == ("pod", "data")
        assert specs.mesh_dims(two) == MESHES["2x16x16"]
        el = make_elastic_mesh(model_parallelism=48, device="cpu")
        assert tuple(el.mesh.shape) == (16, 32)
        model = get_arch("qwen2-1.5b").abstract_params(
            lambda cfg, device: model_for(get_arch("qwen2-1.5b"), cfg,
                                          device, None))
        assert specs.param_specs(model, "lm", two) == specs.param_specs(
            model, "lm", _mesh(MESHES["2x16x16"]))
    finally:
        dist.destroy_process_group()
    assert elastic_shape(16, 24) == (2, 12)
    assert elastic_shape(16, 7) == (1, 7)
    assert elastic_shape(4, 64) == (16, 4)


@pytest.mark.parametrize("name", GNNS)
def test_pad_gnn_batch_matches_reference(name):
    ref_arch = ref_get_arch(name)
    _, jbatch = ref_arch.smoke()
    _, tbatch = get_arch(name).smoke()
    n_seg = tbatch["edge_src"].shape[0] if name == "dimenet" \
        else tbatch["x"].shape[0]
    for ns in (3, 4, 7):
        want = ref_gnn_spmd.pad_gnn_batch(
            name, {k: np.asarray(v) for k, v in jbatch.items()}, ns, n_seg)
        got = gnn_spmd.pad_gnn_batch(name, tbatch, ns, n_seg)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        for cell in ref_arch.cells:
            ref_abs = ref_gnn_spmd.pad_gnn_batch_abstract(
                name, ref_arch.input_specs(cell), ns, n_seg)
            abs_ = gnn_spmd.pad_gnn_batch_abstract(
                name, get_arch(name).input_specs(cell), ns, n_seg)
            assert {k: tuple(v.shape) for k, v in abs_.items()} == {
                k: tuple(v.shape) for k, v in ref_abs.items()}
            assert all(v.device.type == "meta" for v in abs_.values())
    assert gnn_spmd.n_shards_of(_mesh(MESHES["2x16x16"])) == 512
    assert gnn_spmd.mesh_axes(_mesh(MESHES["2x4"])) == ("data", "model")


# ------------------------------------------------------ the 4-rank world

def _agg_case() -> dict:
    """16 edges, 4 to a rank, 6 segments: segment 0's maximum (and
    segment 1's minimum) tied across ranks 0 and 2, one element a rank;
    segment 4 only on rank 3; segment 5 empty; one id past the end
    (dropped)."""
    rng = np.random.default_rng(3)
    x = rng.integers(-4, 5, (16, 3)).astype(np.float32)
    seg = np.array([0, 1, 2, 3, 2, 3, 1, 2, 0, 1, 3, 6, 4, 4, 2, 3],
                   np.int32)
    x[0], x[8] = 9.0, 9.0  # max of segment 0 on ranks 0 and 2
    x[1], x[9] = -9.0, -9.0  # min of segment 1 on ranks 0 and 2
    w = rng.normal(size=(6, 3)).astype(np.float32)
    return {"x": x, "seg": seg, "w": w, "n": 6}


def _port_weights(arch_name: str, cfg) -> dict:
    """The port's seeded weights for ``cfg`` (numpy, by parameter name):
    both packages run on them."""
    arch = get_arch(arch_name)
    model = model_for(arch, cfg, "cpu", torch.Generator().manual_seed(0))
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _ref_tree(init, cfg, named: dict):
    """The reference's parameter pytree for ``cfg`` holding the port's
    weights ``named``: a stacked leaf (``dense_layers.<leaf>``) stacks the
    port's layers (the inverse of ``convert.params_from_jax``).  Only the
    tree's shapes are traced (``eval_shape``), nothing is compiled."""
    abstract = jax.eval_shape(lambda k: init(k, cfg),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    flat, treedef = jax.tree_util.tree_flatten_with_path(abstract)
    leaves = []
    for kp, sds in flat:
        name = ".".join(ref_specs._path_names(kp))
        if name in named:
            arr = named[name]
        else:
            stack, rest = name.split(".", 1)
            arr = np.stack([named[f"{stack}.{i}.{rest}"]
                            for i in range(sds.shape[0])])
        assert arr.shape == sds.shape, name
        leaves.append(jnp.asarray(arr, sds.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


@functools.lru_cache(maxsize=None)
def _gnn_weights(name: str) -> dict:
    return _port_weights(name, get_arch(name).smoke()[0])


@functools.lru_cache(maxsize=None)
def _ref_gnn(name: str):
    """The reference's single-device loss, gradients and one AdamW step
    on its smoke batch and the port's weights (DimeNet v2 is held to
    DimeNet's)."""
    if name == "dimenet-v2":
        return _ref_gnn("dimenet")
    mod = GNN_MODULES[name]
    cfg, batch = ref_get_arch(name).smoke()
    params = _ref_tree(mod.init_params, cfg, _gnn_weights(name))
    return _ref_step(mod.loss_fn, params, batch, cfg, GNN_OPT)


def _ref_step(loss_fn, params, batch, cfg, opt: dict):
    """The reference's single-device ``value_and_grad`` of ``loss_fn`` and
    its train step's AdamW update (the parameters after it and the
    gradient norm it clips by) (``make_train_step``'s two parts, each
    jitted: one compile of the loss's graph, not two)."""
    loss, grads = jax.jit(jax.value_and_grad(loss_fn), static_argnums=2)(
        params, batch, cfg)
    opt_cfg = ref_opt.OptConfig(**opt)
    p1, _, gn = jax.jit(ref_opt.adamw_update, static_argnums=3)(
        params, grads, ref_opt.adamw_init(params, opt_cfg), opt_cfg)
    return float(loss), _np(grads), _np(p1), float(gn)


def _lm_cfg(ref: bool, n_layers: int):
    """qwen3-8b's smoke config in float32 (remat off at 4 layers, as the
    reference's pipeline test), in either package."""
    arch = (ref_get_arch if ref else get_arch)("qwen3-8b")
    cfg = dataclasses.replace(arch.smoke()[0], compute_dtype="float32")
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers, remat=False)
    return cfg


@functools.lru_cache(maxsize=None)
def _lm_weights(n_layers: int) -> dict:
    return _port_weights("qwen3-8b", _lm_cfg(False, n_layers))


@functools.lru_cache(maxsize=None)
def _ref_lm(n_layers: int):
    """The dense loss and gradients, and one single-device AdamW step."""
    cfg = _lm_cfg(True, n_layers)
    _, batch = ref_get_arch("qwen3-8b").smoke()
    params = _ref_tree(ref_tf.init_params, cfg, _lm_weights(n_layers))
    return _ref_step(ref_tf.loss_fn, params, batch, cfg, LM_OPT)


def _moe_cfg():
    """deepseek-v2-236b's smoke config in float32 (the port's)."""
    cfg = get_arch("deepseek-v2-236b").smoke()[0]
    return dataclasses.replace(cfg, compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _moe_weights() -> dict:
    return _port_weights("deepseek-v2-236b", _moe_cfg())


@functools.lru_cache(maxsize=None)
def _plain_moe():
    """The port's plain (unsharded) step on the same weights and batch:
    the loss, the gradients, the gradient norm and the parameters after
    one AdamW step."""
    from repro_torch.models import transformer
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainstep import make_train_step, value_and_grad

    arch = get_arch("deepseek-v2-236b")
    model = model_for(arch, _moe_cfg(), "cpu",
                      torch.Generator().manual_seed(0))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _moe_weights().items()})
    batch = arch.smoke()[1]
    _, grads = value_and_grad(transformer.loss_fn, model, batch)
    opt_cfg = OptConfig(**LM_OPT)
    step = make_train_step(transformer.loss_fn, model, opt_cfg)
    _, _, metrics = step(model, adamw_init(dict(model.named_parameters()),
                                           opt_cfg), batch)
    return (float(metrics["loss"]),
            {k: g.numpy().copy() for k, g in grads.items()},
            float(metrics["grad_norm"]),
            {k: p.detach().numpy().copy()
             for k, p in model.named_parameters()})


# DLRM's explicit-SPMD steps: a clip norm the first steps' gradient norms
# pass, so the clip scales them
DLRM_OPT = dict(lr=1e-2, warmup_steps=1, clip_norm=0.01)


def _dlrm_case() -> dict:
    """Weights, an 8-row train batch (ids from -1, padding, to past each
    table's end) and a retrieval query with 16 candidates, at
    ``torch_sharding_ranks.dlrm_config``'s widths."""
    from repro_torch.models.recsys import dlrm

    cfg = torch_sharding_ranks.dlrm_config()
    model = dlrm.DLRM(cfg, generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    k = cfg.hotness

    def sparse(b):
        return np.stack([rng.integers(-1, v + 3, (b, k))
                         for v in cfg.vocab_sizes], axis=1).astype(np.int32)

    batch = {"dense": rng.normal(size=(8, cfg.n_dense)).astype(np.float32),
             "sparse": sparse(8),
             "labels": rng.integers(0, 2, 8).astype(np.float32)}
    ret = {"dense": rng.normal(size=(1, cfg.n_dense)).astype(np.float32),
           "sparse": sparse(1),
           "cand": rng.normal(size=(16, cfg.embed_dim)).astype(np.float32)}
    return {"params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
            "batch": batch, "retrieval": ret, "opt": DLRM_OPT}


@functools.lru_cache(maxsize=None)
def _plain_dlrm():
    """The port's plain DLRM on ``_dlrm_case``: serve logits, retrieval
    scores, the train loss's gradients, and two steps' losses, gradient
    norms and parameters."""
    from repro_torch.models.recsys import dlrm
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainstep import make_train_step, value_and_grad

    case = _dlrm_case()
    model = dlrm.DLRM(torch_sharding_ranks.dlrm_config())
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["params"].items()})
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    ret = {k: torch.from_numpy(v) for k, v in case["retrieval"].items()}
    with torch.no_grad():
        out = {"serve": model(batch).numpy(),
               "retrieval": dlrm.retrieval_score(model, ret).numpy()}
    _, grads = value_and_grad(dlrm.loss_fn, model, batch)
    out["grads"] = {k: g.numpy().copy() for k, g in grads.items()}
    opt_cfg = OptConfig(**DLRM_OPT)
    step = make_train_step(dlrm.loss_fn, model, opt_cfg)
    opt = adamw_init(dict(model.named_parameters()), opt_cfg)
    for i in range(2):
        _, opt, metrics = step(model, opt, batch)
        out[f"loss{i}"] = float(metrics["loss"])
        out[f"grad_norm{i}"] = float(metrics["grad_norm"])
    out["params"] = {k: p.detach().numpy().copy()
                     for k, p in model.named_parameters()}
    return out


def _adamw_case() -> dict:
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = {k: rng.normal(size=(4,) + v.shape).astype(np.float32)
             for k, v in params.items()}
    return {"params": params, "grads": grads,
            "opt": dict(lr=1e-2, warmup_steps=1, clip_norm=0.5)}


@functools.lru_cache(maxsize=None)
def _ref_adamw(compress: bool):
    """The reference's single-device AdamW update on the mean of
    ``_adamw_case``'s per-rank gradients (``compress``: of each rank's
    int8-compressed gradient): the parameters, the gradient norm and each
    rank's compression residual."""
    case = _adamw_case()
    params = {k: jnp.asarray(v) for k, v in case["params"].items()}
    per_rank = [{k: jnp.asarray(v[r]) for k, v in case["grads"].items()}
                for r in range(4)]
    errs = None
    if compress:
        pairs = [{k: ref_opt.compress_int8(g, jnp.zeros_like(g))
                  for k, g in gr.items()} for gr in per_rank]
        per_rank = [{k: pr[0] for k, pr in p.items()} for p in pairs]
        errs = [{k: np.asarray(pr[1]) for k, pr in p.items()} for p in pairs]
    mean = {k: sum(gr[k] for gr in per_rank) / 4 for k in params}
    cfg = ref_opt.OptConfig(**case["opt"])
    p1, _, gn = ref_opt.adamw_update(params, mean,
                                     ref_opt.adamw_init(params, cfg), cfg)
    return _np(p1), float(gn), errs


@pytest.fixture(scope="module", autouse=True)
def _ranks(tmp_path_factory):
    """The one 4-rank gloo world, started with this module's first test so
    that its ranks run while the spec and padding tests do: yields its
    inputs, the box that receives its outputs (or its error) and its
    thread."""
    inputs = {"agg": _agg_case(), "gnn_opt": GNN_OPT,
              "adamw": _adamw_case(),
              "ckpt_dir": str(tmp_path_factory.mktemp("elastic")),
              "gnn": {}}
    for name in GNNS + ("dimenet-v2",):
        arch_name = "dimenet" if name == "dimenet-v2" else name
        batch = get_arch(arch_name).smoke()[1]
        n_seg = batch["edge_src"].shape[0] if arch_name == "dimenet" \
            else batch["x"].shape[0]
        inputs["gnn"][name] = {"params": _gnn_weights(arch_name),
                               "n_seg": int(n_seg)}
    for key, layers in (("dp_tp", 2), ("pipe", 4)):
        inputs[key] = {"params": _lm_weights(layers), "opt": LM_OPT}
    inputs["moe"] = {"params": _moe_weights(), "opt": LM_OPT}
    inputs["dlrm"] = _dlrm_case()
    box = {}

    def run():
        try:
            box["outs"] = spawn_world(torch_sharding_ranks.all_cases, 4,
                                      inputs, "cpu", timeout=300)
        except BaseException as e:  # re-raised below
            box["error"] = e

    ranks = threading.Thread(target=run)
    ranks.start()
    try:
        yield inputs, box, ranks
    finally:
        ranks.join()


@pytest.fixture(scope="module")
def world(_ranks):
    """Every rank's outputs of the one 4-rank gloo world, and the inputs
    it was given.  The reference's single-device results compile here
    while the ranks run."""
    inputs, box, ranks = _ranks
    try:
        for op in AGG_OPS:
            _ref_agg(op)
        for compress in (False, True):
            _ref_adamw(compress)
        for name in GNNS:
            _ref_gnn(name)
        _ref_lm(2)
        _ref_lm(4)
        _plain_moe()
        _plain_dlrm()
    finally:
        ranks.join()
    if "error" in box:
        raise box["error"]
    outs = box["outs"]
    assert [o["rank"] for o in outs] == [0, 1, 2, 3]
    return inputs, outs


def test_pod_data_placement_is_pod_major(world):
    """A dimension sharded over ``("pod", "data")`` splits over both mesh
    dimensions, pod major, as JAX's ``P(("pod", "data"))``."""
    _, outs = world
    for o in outs:
        r = o["rank"]
        np.testing.assert_array_equal(o["pod_data_local"],
                                      np.arange(2 * r, 2 * r + 2))


@functools.lru_cache(maxsize=None)
def _ref_agg(op: str):
    """The reference's single-device ``segment_{op}`` of ``_agg_case`` and
    the gradient of ``sum(out · w)`` (finite entries)."""
    case = _agg_case()
    x, seg, w, n = (jnp.asarray(case["x"]), jnp.asarray(case["seg"]),
                    jnp.asarray(case["w"]), case["n"])
    fn = getattr(ref_common, f"segment_{op}")

    def loss(xx):
        y = fn(xx, seg, n)
        return jnp.sum(jnp.where(jnp.isfinite(y), y, 0.0) * w)

    return np.asarray(fn(x, seg, n)), np.asarray(jax.grad(loss)(x)), \
        np.asarray(ref_common.degrees(seg, n))


@pytest.mark.parametrize("op", AGG_OPS)
def test_spmd_aggregation_matches_reference(world, op):
    """Each rank's output equals the reference's single-device
    aggregation (float32 ulps; the ties and the empty segments exactly);
    the ranks' gradients, concatenated and divided by the 4 ranks (each
    holds the all-reduced cotangent), equal the reference's gradient."""
    _, outs = world
    want, want_g, degrees = _ref_agg(op)
    for o in outs:
        np.testing.assert_allclose(o[f"agg_{op}"], want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(np.isfinite(o[f"agg_{op}"]),
                                      np.isfinite(want))
        np.testing.assert_array_equal(o["agg_degrees"], degrees)
    got_g = np.concatenate([o[f"agg_{op}_grad"] for o in outs]) / 4
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-6)
    if op in ("max", "min"):  # the tie splits its gradient in two
        row = 0 if op == "max" else 1
        np.testing.assert_allclose(got_g[row], want_g[row], rtol=0, atol=0)
        assert np.all(np.abs(got_g[row]) > 0)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-12))


@pytest.mark.parametrize("name", GNNS + ("dimenet-v2",))
def test_gnn_spmd_grads_match_single_device(world, name):
    """Loss and gradients of the SPMD forward over the (2, 2) mesh (v2: 4
    edge shards) against the reference's single-device ones: every
    leaf's relative norm within the reference test's limit; the loss
    within 1e-5 (the reference's v2 limit)."""
    _, outs = world
    arch_name = "dimenet" if name == "dimenet-v2" else name
    loss, grads, _, _ = _ref_gnn(name)
    want = {k: v.numpy() for k, v in params_from_jax(arch_name,
                                                     grads).items()}
    for o in outs:
        assert abs(o[f"{name}/loss"] - loss) < 1e-5
        got = o[f"{name}/grads"]
        assert sorted(got) == sorted(want)
        worst = max(_rel(want[k], got[k]) for k in want)
        assert worst < GNN_GRAD_REL[name], (name, worst)
    for o in outs[1:]:  # the mean is the same on every rank
        for k, g in o[f"{name}/grads"].items():
            np.testing.assert_array_equal(g, outs[0][f"{name}/grads"][k])


@pytest.mark.parametrize("name", GNNS + ("dimenet-v2",))
def test_gnn_spmd_step_matches_single_device_step(world, name):
    """One step of ``make_spmd_train_step`` (the replicated AdamW after
    the mean) against the reference's single-device train step."""
    _, outs = world
    arch_name = "dimenet" if name == "dimenet-v2" else name
    loss1, grads, p1, _ = _ref_gnn(name)
    want = {k: v.numpy() for k, v in params_from_jax(arch_name, p1).items()}
    g = {k: v.numpy() for k, v in params_from_jax(arch_name, grads).items()}
    for o in outs:
        assert abs(o[f"{name}/step_loss"] - loss1) < 1e-5
        assert o[f"{name}/step"] == 1
        for k, w in want.items():
            got = o[f"{name}/params"][k]
            noise = np.abs(g[k]) < NOISE_GRAD
            np.testing.assert_allclose(got[~noise], w[~noise], **STEP_PARAMS)
            assert np.all(np.abs(got - w)[noise] <= 2 * GNN_OPT["lr"] + 1e-6)


def _held_update(o: dict, tag: str, p0: dict, want: dict, gn: float
                 ) -> None:
    """One AdamW step's result ``o[tag + "params"]`` from ``p0`` against
    ``want`` (port names): every parameter within rtol / atol 2e-3 (the
    reference DP+TP test's limits), and, since the first step moves each
    element by about lr·sign(g) whatever the gradient's size (which those
    limits cannot tell from a zero or sign-flipped gradient), the update
    ``want - p0`` of every leaf within ``LM_UPDATE_REL`` of the
    reference's by norm and the gradient norm the step clipped by within
    ``LM_GRAD_REL`` of the reference's (a gradient off by a factor)."""
    got = o[tag + "params"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-3,
                                   err_msg=k)
    worst = max(_rel(want[k] - p0[k], got[k] - p0[k]) for k in want)
    assert worst < LM_UPDATE_REL, worst
    assert o[tag + "grad_norm"] == pytest.approx(gn, rel=LM_GRAD_REL)


def _lm_named(tree) -> dict:
    """A reference LM tree (stacked layers) as the port's named arrays."""
    return {k: v.numpy() for k, v in params_from_jax("qwen3-8b",
                                                     tree).items()}


def _held_grads(got: dict, want: dict) -> None:
    """Every gradient leaf within ``LM_GRAD_REL`` of ``want``'s by norm."""
    assert sorted(got) == sorted(want)
    worst = max(_rel(want[k], got[k]) for k in want)
    assert worst < LM_GRAD_REL, worst


def test_dp_tp_step_matches_single_device(world):
    """The DP+TP step over (2, 2) against the reference's single-device
    step (not its sharded one, which disagrees with it): the loss within
    1e-3 (the reference test's limit), every gradient leaf within
    ``LM_GRAD_REL`` by norm, the step's parameters as
    :func:`_held_update` holds them; the parameters are placed by the
    specs."""
    inputs, outs = world
    loss1, g1, p1, gn1 = _ref_lm(2)
    for o in outs:
        assert abs(o["dp_tp/loss"] - loss1) < 1e-3
        assert abs(o["dp_tp/hinted_loss"] - o["dp_tp/plain_loss"]) < 1e-6
        _held_grads(o["dp_tp/grads"], _lm_named(g1))
        _held_update(o, "dp_tp/", inputs["dp_tp"]["params"], _lm_named(p1),
                     gn1)
    o = outs[0]
    assert o["dp_tp/placements"]["dense_layers.0.attn.wq"] == [
        "S(0)", "S(1)"]
    assert o["dp_tp/placements"]["dense_layers.0.mlp.w_down"] == [
        "S(1)", "S(0)"]
    assert o["dp_tp/placements"]["embed"] == ["R", "S(0)"]
    assert o["dp_tp/placements"]["final_ln"] == ["R", "R"]
    assert o["dp_tp/local_shapes"]["lm_head"] == (32, 128)
    assert o["dp_tp/logits_placements"] == ["S(0)", "R"]


def test_moe_dp_tp_step_matches_plain_step(world):
    """The DP+TP step of DeepSeek-V2's smoke config (experts sharded over
    ``model``) over (2, 2) against the port's plain step on the same
    weights and batch: the loss within 1e-3 (the DP+TP step's limit),
    every gradient leaf within ``LM_GRAD_REL`` by norm (the sum over
    ``model`` in the sharded backward: a missing or doubled one is off by
    a factor), the step's parameters as :func:`_held_update` holds them;
    the experts sharded over ``model`` and ZeRO-sharded over ``data``."""
    inputs, outs = world
    loss, grads, gn, params = _plain_moe()
    for o in outs:
        assert abs(o["moe/loss"] - loss) < 1e-3
        _held_grads(o["moe/grads"], grads)
        _held_update(o, "moe/", inputs["moe"]["params"], params, gn)
        assert o["moe/expert_placements"] == ["S(1)", "S(0)"]


def test_dlrm_sharded_steps_match_plain_steps(world):
    """DLRM's explicit-SPMD steps over (data 2, model 2), two of four
    tables row-sharded over ``model``, against the port's plain DLRM on
    the same weights and batches: each rank's serve logits (its data
    rows) and retrieval scores (its block of candidates) within rtol
    1e-5 / atol 1e-6, every gradient leaf within ``LM_GRAD_REL`` by norm,
    and two AdamW steps whose clip binds: each step's loss within 1e-6
    and gradient norm within ``LM_GRAD_REL`` (a norm of one rank's rows
    only is off), and the parameters after them within ``STEP_PARAMS``
    with each leaf's update within ``LM_UPDATE_REL`` by norm (the
    replicated MLPs stay equal across ``model`` ranks)."""
    inputs, outs = world
    want = _plain_dlrm()
    p0 = inputs["dlrm"]["params"]
    assert min(want["grad_norm0"], want["grad_norm1"]) > \
        2 * DLRM_OPT["clip_norm"]
    b = inputs["dlrm"]["batch"]["labels"].shape[0] // 2
    n = inputs["dlrm"]["retrieval"]["cand"].shape[0] // 4
    assert sorted(o["dlrm/block"] for o in outs) == [0, 1, 2, 3]
    for o in outs:
        assert o["dlrm/sharded"] == [True, False, True, False]
        d, r = o["dlrm/data_rank"], o["dlrm/block"]
        np.testing.assert_allclose(o["dlrm/serve"],
                                   want["serve"][d * b:(d + 1) * b],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["dlrm/retrieval"],
                                   want["retrieval"][r * n:(r + 1) * n],
                                   rtol=1e-5, atol=1e-6)
        _held_grads(o["dlrm/grads"], want["grads"])
        for i in range(2):
            assert abs(o[f"dlrm/loss{i}"] - want[f"loss{i}"]) < 1e-6
            assert o[f"dlrm/grad_norm{i}"] == pytest.approx(
                want[f"grad_norm{i}"], rel=LM_GRAD_REL)
        got = o["dlrm/params"]
        assert sorted(got) == sorted(want["params"])
        for k, w in want["params"].items():
            np.testing.assert_allclose(got[k], w, **STEP_PARAMS, err_msg=k)
            assert _rel(w - p0[k], got[k] - p0[k]) < LM_UPDATE_REL, k


def test_pipeline_matches_dense(world):
    """``pipelined_loss`` over 4 stages with 2 microbatches against the
    reference's dense loss (within 2e-3) and gradients (rtol 5e-2, atol
    5e-3), the reference test's limits."""
    _, outs = world
    loss, grads, _, _ = _ref_lm(4)
    want = {k: v.numpy() for k, v in params_from_jax("qwen3-8b",
                                                     grads).items()}
    for o in outs:
        assert abs(o["pipe/loss"] - loss) < 2e-3
        for k in want:
            np.testing.assert_allclose(o["pipe/grads"][k], want[k],
                                       rtol=5e-2, atol=5e-3, err_msg=k)


def test_pipeline_train_step_matches_dense_step(world):
    """One step of ``make_pipeline_train_step`` against the reference's
    dense single-device step: the loss within 2e-3, the parameters as
    :func:`_held_update` holds the DP+TP step's."""
    inputs, outs = world
    loss, _, p1, gn = _ref_lm(4)
    for o in outs:
        assert abs(o["pipe/step_loss"] - loss) < 2e-3
        _held_update(o, "pipe/step_", inputs["pipe"]["params"],
                     _lm_named(p1), gn)


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_group_mean_matches_reference(world, compress):
    """``adamw_update(group=...)`` over 4 ranks with their own gradients
    equals the reference's single-device update on the mean gradient
    (with compression: the mean of each rank's int8-compressed gradient,
    each rank keeping its own residual)."""
    _, outs = world
    p1, gn, errs = _ref_adamw(compress)
    tag = f"adamw/{int(compress)}"
    for o in outs:
        for k in p1:
            np.testing.assert_allclose(o[f"{tag}/params"][k], p1[k],
                                       rtol=1e-6, atol=1e-7)
        assert o[f"{tag}/gn"] == pytest.approx(gn, rel=1e-6)
        if compress:
            for k in p1:
                np.testing.assert_allclose(o[f"{tag}/err"][k],
                                           errs[o["rank"]][k], rtol=0,
                                           atol=1e-7)


def test_elastic_restore_onto_new_mesh(world):
    """Saved from a (2, 2) mesh as P("data", "model"), restored onto the
    elastic (1, 4) mesh of the same ranks as P("model", "data"): the
    saved values, each rank holding its own rows."""
    _, outs = world
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    for o in outs:
        assert o["elastic/step"] == 7
        assert o["elastic/mesh"] == (1, 4)
        assert o["elastic/placements"] == ["S(1)", "S(0)"]
        np.testing.assert_array_equal(o["elastic/full"], w)
        r = o["rank"]
        np.testing.assert_array_equal(o["elastic/local"], w[2 * r:2 * r + 2])
