"""The port's PNA, MeshGraphNet and DimeNet against the reference: smoke
batches bit for bit, forward, loss and every gradient leaf with the
reference's weights carried across (``convert.params_from_jax``), AdamW
trajectories (1 and 12 steps; 3 microbatched and compressed), the
abstract models and input specs at the published configs, a bfloat16
forward, DimeNet's out-of-range ids, PNA's empty segments and tied
maxima, DimeNet's bilinear product, batches at the cells' shapes, and
the ``launch.train`` CLI.

The reference runs as its own tests run it (jitted on the CPU); each
compiled reference function is built once a file.  Tolerances are
test_torch_models.py's (``FWD`` / ``GRAD`` / ``STEP_PARAMS``, float32 on
the CPU: the two packages sum in other orders) unless stated where used.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.configs import get_arch as ref_get_arch
from repro.models.gnn import dimenet as ref_dimenet
from repro.models.gnn import meshgraphnet as ref_mgn
from repro.models.gnn import pna as ref_pna
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.trainstep import make_train_step as ref_make_train_step
from repro_torch.configs import all_archs, get_arch
from repro_torch.configs.common import gnn_cell_dims
from repro_torch.configs.gnn_common import cell_batch
from repro_torch.convert import (_named_leaves, adam_state_from_jax,
                                  params_from_jax)
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import model_for
from repro_torch.models.gnn import dimenet
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.trainstep import (make_train_step, named_params,
                                          value_and_grad)

ARCHS = ("pna", "meshgraphnet", "dimenet")
REF_MODULES = {"pna": ref_pna, "meshgraphnet": ref_mgn,
               "dimenet": ref_dimenet}

# test_torch_models.py's tolerances: forward values and losses a few
# float32 ulps of outputs of order 1; gradients summed in another order
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
# after AdamW steps (lr 3e-3): parameters as test_torch_models.py holds
# them, but for the elements whose update is noise.  AdamW moves an
# element by lr·g/(|g| + 1e-8): where |g| falls below GRAD's atol (1e-6),
# the two packages' gradients agree only absolutely (PNA's post-MLP rows
# on constant aggregates sum to 3e-9-4e-8 with 3% apart), and the
# update's difference reaches lr.  Such an element may differ by up to
# 2·lr a step; so may one whose int8-compressed gradient quantized one
# step apart (a residual flip, below)
STEP_PARAMS = dict(rtol=1e-4, atol=1e-5)
NOISE_GRAD = 1e-6
# bfloat16 compute (unit roundoff 2^-9): the output within 2e-2 of the
# reference's bfloat16 output norm-wise (a product rounded the other way
# moves what follows by a bf16 ulp), as the LM's bfloat16 checks
BF16_REL = 2e-2

# the published configs' parameter counts (the reference's eval_shape);
# PNA and MeshGraphNet at full_graph_sm's d_feat 1433 and minibatch_lg's 602
PARAMS = {"pna": (667_666, 480_691), "meshgraphnet": (1_970_307, 1_863_939),
          "dimenet": (1_236_838, 1_236_838)}

TRAJ_OPT = dict(lr=3e-3, warmup_steps=1, total_steps=1000, schedule="const",
                weight_decay=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one torch thread keeps the suite's
    parallel workers from oversubscribing the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_world(name: str, seed: int = 1):
    """The reference's smoke config, batch and weights (``PRNGKey(seed)``),
    built once a file (JAX arrays are immutable)."""
    ref_arch = ref_get_arch(name)
    cfg, jbatch = ref_arch.smoke()
    jparams = jax.jit(REF_MODULES[name].init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)
    return ref_arch, cfg, jbatch, jparams


@functools.lru_cache(maxsize=None)
def _ref_fn(name: str, what: str):
    """The reference's jitted ``forward`` or ``value_and_grad(loss_fn)``
    (config static), compiled once a file and shape."""
    mod = REF_MODULES[name]
    fn = mod.forward if what == "forward" else jax.value_and_grad(
        mod.loss_fn)
    return jax.jit(fn, static_argnums=2)


def _world(name: str):
    """The reference's world, and the port's smoke batch and a fresh module
    holding the same weights."""
    ref_arch, cfg, jbatch, jparams = _ref_world(name)
    arch = get_arch(name)
    pcfg, tbatch = arch.smoke()
    model = model_for(arch, pcfg, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(name, _np(jparams)))
    return ref_arch, cfg, jbatch, jparams, arch, model, tbatch


def _close(got: dict, want: dict, tol: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k].detach()),
                                   np.asarray(want[k]), err_msg=f"{what} {k}",
                                   **tol)


def _grads_match(name, model, tbatch, jparams, jbatch, cfg, what):
    """Loss and every gradient leaf of the port against the reference's
    ``value_and_grad`` on the same weights and batch."""
    jloss, jgrads = _ref_fn(name, "grad")(jparams, jbatch, cfg)
    loss = get_arch(name).loss_fn(model, tbatch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               err_msg=f"{what} loss", **FWD)
    grads = dict(zip(named_params(model), torch.autograd.grad(
        loss, list(model.parameters()), allow_unused=True,
        materialize_grads=True)))
    _close(grads, params_from_jax(name, _np(jgrads)), GRAD, f"{what} grad")


def test_registry_holds_the_reference_archs():
    from repro.configs import all_archs as ref_all_archs
    from repro_torch.configs import ASSIGNED as PORT_ASSIGNED

    assert all_archs() == ref_all_archs()
    assert PORT_ASSIGNED == ASSIGNED


@pytest.mark.parametrize("name", ARCHS)
def test_smoke_batch_equals_reference(name):
    _, _, jbatch, _, _, _, tbatch = _world(name)
    assert sorted(jbatch) == sorted(tbatch)
    for k in jbatch:
        assert tbatch[k].dtype == {"int32": torch.int32, "bool": torch.bool,
                                   "float32": torch.float32}[
            str(jbatch[k].dtype)], k
        np.testing.assert_array_equal(tbatch[k].numpy(),
                                      np.asarray(jbatch[k]))


@pytest.mark.parametrize("name", ARCHS)
def test_forward_loss_and_grads_match_reference(name):
    _, cfg, jbatch, jparams, _, model, tbatch = _world(name)
    np.testing.assert_allclose(
        model(tbatch).detach().numpy(),
        np.asarray(_ref_fn(name, "forward")(jparams, jbatch, cfg)), **FWD)
    _grads_match(name, model, tbatch, jparams, jbatch, cfg, name)


@pytest.mark.parametrize("name", ARCHS)
def test_bfloat16_forward_matches_reference(name):
    """bfloat16 compute from float32 master weights, the output within
    ``BF16_REL`` of the reference's bfloat16 output norm-wise."""
    _, cfg, jbatch, jparams, _, model, tbatch = _world(name)
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model.cfg = dataclasses.replace(model.cfg, compute_dtype="bfloat16")
    got = model(tbatch).detach()
    assert got.dtype == torch.bfloat16
    want = np.asarray(_ref_fn(name, "forward")(jparams, jbatch, cfg16),
                      np.float32)
    got = got.float().numpy()
    assert np.all(np.isfinite(got))
    assert np.linalg.norm(got - want) <= BF16_REL * np.linalg.norm(want)


# ------------------------------------------------------------ trajectories

@functools.lru_cache(maxsize=None)
def _ref_step(name: str, microbatches: int, grad_compress: bool):
    """The reference's jitted train step, compiled once a file."""
    ref_arch, cfg, _, _ = _ref_world(name)
    opt = RefOptConfig(**TRAJ_OPT, grad_compress=grad_compress)
    return jax.jit(ref_make_train_step(ref_arch.loss_fn, cfg, opt,
                                       microbatches=microbatches)), opt


def _step_grads(arch, model, batch, microbatches: int) -> dict:
    """The gradient the port's step hands AdamW (before compression): the
    mean over the microbatches' gradients."""
    total = {}
    for i in range(microbatches):
        one = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                            + tuple(v.shape[1:]))[i]
               for k, v in batch.items()}
        _, g = value_and_grad(arch.loss_fn, model, one)
        for k, gk in g.items():
            total[k] = total.get(k, 0) + gk
    return {k: g / microbatches for k, g in total.items()}


def _trajectory(name, steps: int, microbatches: int = 1,
                grad_compress: bool = False):
    """``steps`` AdamW steps on the smoke batch in both packages from the
    same weights (lr 3e-3, const schedule, no weight decay); returns both
    sides' last metrics, params and state, the port's losses, and each
    leaf's elements whose gradient fell under ``NOISE_GRAD`` at a step."""
    _, _, jbatch, jparams, arch, model, tbatch = _world(name)
    jstep, ref_opt = _ref_step(name, microbatches, grad_compress)
    jstate = ref_adamw_init(jparams, ref_opt)
    opt_cfg = OptConfig(**TRAJ_OPT, grad_compress=grad_compress)
    step = make_train_step(arch.loss_fn, model, opt_cfg,
                           microbatches=microbatches)
    state = adamw_init(named_params(model), opt_cfg)
    noisy = {k: torch.zeros(p.shape, dtype=torch.bool)
             for k, p in named_params(model).items()}
    jm = tm = None
    losses = []
    for _ in range(steps):
        for k, g in _step_grads(arch, model, tbatch, microbatches).items():
            noisy[k] |= g.abs() < NOISE_GRAD
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        _, state, tm = step(model, state, tbatch)
        losses.append(float(tm["loss"]))
    return (jm, jparams, jstate), (tm, model, state), losses, noisy


def _compare_trajectory(name, ref, port, what, noisy, steps):
    (jm, jparams, jstate), (tm, model, state) = ref, port
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               err_msg=f"{what} loss", **FWD)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               err_msg=f"{what} grad norm", **GRAD)
    assert int(tm["step"]) == int(jm["step"])
    want = adam_state_from_jax(_np(jstate))
    flips = {k: np.zeros(v.shape, bool) for k, v in want.mu.items()}
    if want.err is not None:
        # int8 residuals r = t - q·step, t = g + r_prev: r carries t's
        # absolute error, GRAD's rtol of t's largest, which is 127 steps
        # (step >= 2·max|r|).  Where the two packages round a value of t to
        # either side of a half step, it quantizes one step apart: the
        # residual differs by a step there (and that step's moments and
        # update).  Such flips are rare: one element, or 1% of a leaf
        for k, e in want.err.items():
            got, e = state.err[k].numpy(), e.numpy()
            q = 2 * np.abs(e).max()
            diff = np.abs(got - e)
            flips[k] = diff > GRAD["rtol"] * 127 * q + GRAD["atol"]
            assert flips[k].sum() <= max(1, 0.01 * e.size), \
                f"{what} err {k}: {flips[k].sum()} flips"
            assert (diff <= 1.01 * q + GRAD["atol"]).all(), \
                f"{what} err {k}: off by more than a step"
    params = params_from_jax(name, _np(jparams))
    got = named_params(model)
    assert sorted(got) == sorted(params)
    for k, p in params.items():
        g, p = got[k].detach().numpy(), p.numpy()
        off = ~np.isclose(g, p, **STEP_PARAMS)
        assert not (off & ~noisy[k].numpy() & ~flips[k]).any(), \
            f"{what} params {k}: {np.argwhere(off)[:5]} off, not noise"
        assert np.abs(g - p).max() <= 2 * TRAJ_OPT["lr"] * steps, \
            f"{what} params {k}"
    for moment, mine in (("mu", state.mu), ("nu", state.nu)):
        theirs = getattr(want, moment)
        assert sorted(mine) == sorted(theirs)
        for k, t in theirs.items():
            off = ~np.isclose(mine[k].numpy(), t.numpy(), **GRAD)
            assert not (off & ~flips[k]).any(), f"{what} {moment} {k}"


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("steps", [1, 12])
def test_adamw_trajectory_matches_reference(name, steps):
    ref, port, losses, noisy = _trajectory(name, steps)
    _compare_trajectory(name, ref, port, f"{name} after {steps}", noisy,
                        steps)
    # the reference's own claim for the zoo (test_arch_loss_decreases)
    assert steps == 1 or losses[-1] < losses[0]


@pytest.mark.parametrize("name", ARCHS)
def test_microbatched_compressed_steps_match_reference(name):
    """``microbatches=2`` halves every leaf's leading dimension: the
    halves' edge, triplet and molecule ids reach past their arrays
    (gathers clamp and scatters drop as JAX's do), with
    ``grad_compress=True`` (int8 with error feedback), 3 steps."""
    ref, port, _, noisy = _trajectory(name, 3, microbatches=2,
                                      grad_compress=True)
    _compare_trajectory(name, ref, port, f"{name} microbatched, compressed",
                        noisy, 3)


# ------------------------------------------------------------ edge cases

def test_dimenet_out_of_range_ids_match_reference():
    """Atom types past ``n_atom_types`` and negative, triplet edge ids past
    ``e`` and negative on both sides, node ids past ``n``, molecule ids
    past ``n_graphs``: the gathers clamp (a clamped id passes no
    gradient back) and the scatters drop, as the reference's."""
    _, cfg, jbatch, jparams, _, model, tbatch = _world("dimenet")
    e, n, t = (tbatch["edge_src"].shape[0], tbatch["z"].shape[0],
               tbatch["t_kj"].shape[0])
    nb = {k: v.clone() for k, v in tbatch.items()}
    nb["z"][:3] = torch.tensor([cfg.n_atom_types, cfg.n_atom_types + 7, -2])
    nb["t_kj"][:4] = torch.tensor([e, e + 50, -1, -e - 3])
    nb["t_ji"][t - 4:] = torch.tensor([e, e + 9, -1, -e - 3])
    nb["edge_src"][:2] = torch.tensor([n, n + 4])
    nb["batch_seg"][:3] = torch.tensor([4, 9, -1])
    jb = {k: jnp.asarray(v.numpy()) for k, v in nb.items()}
    np.testing.assert_allclose(
        model(nb).detach().numpy(),
        np.asarray(_ref_fn("dimenet", "forward")(jparams, jb, cfg)), **FWD)
    _grads_match("dimenet", model, nb, jparams, jb, cfg, "dimenet oob")


def test_pna_empty_segments_and_tied_maxima_match_reference():
    """Nodes with no incoming edge (their max / min are -inf / +inf until
    ``nan_to_num``; attenuation delta / 1e-2), repeated edges whose
    messages tie for a segment's max and min, and ReLU zeros that tie:
    forward, loss and gradients as the reference's."""
    _, cfg, _, jparams, arch, model, _ = _world("pna")
    rng = np.random.default_rng(5)
    n = 10
    src = np.array([0, 1, 1, 1, 2, 3, 3, 4, 6, 6, 7, 8, 0, 5, 5, 9],
                   np.int32)
    dst = np.array([1, 2, 2, 2, 0, 4, 4, 3, 3, 3, 0, 1, 7, 4, 4, 7],
                   np.int32)  # nodes 5, 6, 8, 9 receive nothing
    x = rng.normal(size=(n, cfg.d_feat)).astype(np.float32)
    x[6] = x[3]  # edges 6->3 and 4->3 carry different messages ...
    batch = {"edge_src": src, "edge_dst": dst, "x": x,
             "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32),
             "train_mask": np.ones(n, bool)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    deg = np.bincount(dst, minlength=n)
    assert (deg == 0).sum() == 4 and deg.max() == 4
    # ... and the repeated pairs (1->2 three times, 3->4, 5->4, 6->3
    # twice) tie exactly; ReLU zeros tie in every segment of 2 or more
    m = torch.relu(model.layers[0].pre.w[0].new_tensor(
        np.concatenate([x[src], x[dst]], -1)) @ model.layers[0].pre.w[0]
        + model.layers[0].pre.b[0])
    assert bool((m == 0).any())
    np.testing.assert_allclose(
        model(tb).detach().numpy(),
        np.asarray(_ref_fn("pna", "forward")(jparams, jb, cfg)), **FWD)
    _grads_match("pna", model, tb, jparams, jb, cfg, "pna ties")


def test_dimenet_bilinear_matches_einsum_and_its_gradient():
    """The bilinear product, contracted in its own order, against
    ``torch.einsum`` and its autograd in float64."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(11, 3, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(3, 5, 4, generator=g, dtype=torch.float64,
                    requires_grad=True)
    m = torch.randn(11, 5, generator=g, dtype=torch.float64,
                    requires_grad=True)
    d_out = torch.randn(11, 4, generator=g, dtype=torch.float64)
    got = dimenet.bilinear(a, w, m)
    want = torch.einsum("tb,bhg,th->tg", a, w, m)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for gg, gw in zip(torch.autograd.grad(got, (a, w, m), d_out),
                      torch.autograd.grad(want, (a, w, m), d_out)):
        torch.testing.assert_close(gg, gw, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cell", ["full_graph_sm", "molecule"])
@pytest.mark.parametrize("name", ("gcn-cora",) + ARCHS)
def test_cell_batch_has_the_input_specs_shapes(name, cell):
    """A batch drawn at a cell in the arch's own layout has exactly the
    fields, shapes and dtypes of its ``input_specs``, and its ids lie in
    range."""
    arch = get_arch(name)
    cfg, batch = cell_batch(arch, cell, seed=3)
    specs = arch.input_specs(cell)
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in specs.items()}
    dims = gnn_cell_dims(cell)
    assert int(batch["edge_src"].max()) < dims.n
    assert int(batch["edge_dst"].max()) < dims.n
    if "t_kj" in batch:
        assert int(batch["t_kj"].max()) < dims.e
        assert int(batch["batch_seg"].max()) < dims.n_graphs


@pytest.mark.parametrize("name", ARCHS)
def test_spmd_config_is_refused(name):
    """A config with ``spmd_axes`` runs its collectives over the mesh the
    step runs under (``sharding.comm.mesh_scope``); outside one it is
    refused (the SPMD runs themselves: tests/test_torch_sharding.py)."""
    _, _, _, _, arch, model, tbatch = _world(name)
    model.cfg = dataclasses.replace(model.cfg, spmd_axes=("data",))
    with pytest.raises(RuntimeError, match="mesh_scope"):
        model(tbatch)


# ------------------------------------------------------ abstract models

@pytest.mark.parametrize("name", ARCHS)
def test_abstract_params_and_input_specs_on_meta(name):
    """The published config's abstract model (``meta``) has the
    reference's parameter names and shapes (and its counts at
    full_graph_sm and minibatch_lg); the input specs of all four cells
    have the reference's shapes and dtypes."""
    arch, ref_arch = get_arch(name), ref_get_arch(name)

    def build(cfg, device):
        return model_for(arch, cfg, device, None)

    model = arch.abstract_params(build)
    assert all(p.device.type == "meta" for p in model.parameters())
    ref_tree = ref_arch.abstract_params(REF_MODULES[name].init_params)
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == {
        k: tuple(s.shape) for k, s in _named_leaves(ref_tree).items()}
    counts = tuple(sum(p.numel() for p in build(
        arch.config_for(cell), "meta").parameters())
        for cell in ("full_graph_sm", "minibatch_lg"))
    assert counts == PARAMS[name]
    dtypes = {torch.int32: "int32", torch.float32: "float32",
              torch.bool: "bool"}
    assert sorted(arch.cells) == sorted(ref_arch.cells)
    for cell in arch.cells:
        specs = arch.input_specs(cell)
        ref_specs = ref_arch.input_specs(cell)
        assert {k: (tuple(t.shape), dtypes[t.dtype], t.device.type)
                for k, t in specs.items()} == {
            k: (tuple(t.shape), str(t.dtype), "meta")
            for k, t in ref_specs.items()}, cell


# ------------------------------------------------------------ launcher

def test_launch_train_pna_on_cpu(tmp_path, capsys):
    tr = launch_train.main(["--arch", "pna", "--device", "cpu", "--steps",
                            "3", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final step=3 loss=" in out
    assert tr.ckpt.latest_step() == 3
    assert all(np.isfinite(r["loss"]) for r in tr.metrics_log)


@pytest.mark.parametrize("preset", ["smoke", "full"])
@pytest.mark.parametrize("name", ["meshgraphnet", "dimenet"])
def test_launch_train_refuses_mesh_and_molecule_archs(name, preset,
                                                      tmp_path):
    """The reference's ``--preset smoke`` message; under ``--preset
    full`` the reference dies at its first step on the sampled stream's
    missing ``edge_attr`` / ``z`` (a ``KeyError``), the port exits first
    with a message naming what is missing."""
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--arch", name, "--preset", preset, "--device",
                           "cpu", "--steps", "1", "--ckpt-dir",
                           str(tmp_path)])
    msg = str(e.value)
    if preset == "smoke":
        assert msg == (f"{name} smoke training uses the molecule layout; "
                       "run examples/gnn_training.py instead")
    else:
        assert "sampled graph stream" in msg
        assert ("edge_attr" if name == "meshgraphnet" else "z, pos") in msg
    assert not list(tmp_path.iterdir())
