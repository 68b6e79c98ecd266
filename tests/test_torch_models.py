"""The port's model zoo against the reference: DLRM and GCN forward, loss,
gradients and AdamW trajectories on their ``SMALL`` configs with the
reference's weights carried across (``convert.params_from_jax``), the
embedding bag's gradient, and the GNN aggregation primitives.

Each test builds its own reference world from a seed.  The reference's
train step runs as its own tests run it (``jax.jit(make_train_step(...))``
on the CPU).  Tolerances, all float32 on the CPU, are stated where used:
the two packages sum in different orders (XLA fuses and reassociates), so
nothing is compared bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models.gnn import common as ref_common
from repro.models.gnn import gcn as ref_gcn
from repro.models.recsys import dlrm as ref_dlrm
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.trainstep import make_train_step as ref_make_train_step
from repro_torch.configs import get_arch
from repro_torch.convert import (_named_leaves, adam_state_from_jax,
                                  params_from_jax)
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ops import EmbeddingBagSum, embedding_bag_sum
from repro_torch.launch.train import model_for
from repro_torch.models.gnn import common
from repro_torch.models.recsys import dlrm
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.trainstep import make_train_step, named_params

ARCHS = ("dlrm-rm2", "gcn-cora")
REF_MODULES = {"dlrm-rm2": ref_dlrm, "gcn-cora": ref_gcn}

# forward values and losses: a few float32 ulps of outputs of order 1
FWD = dict(rtol=1e-5, atol=1e-6)
# gradients: sums over the batch in another order; leaves of order 1e-3-1
GRAD = dict(rtol=1e-4, atol=1e-6)


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


def _world(name: str, seed: int = 1):
    """The reference's world, and the port's smoke batch and a fresh module
    holding the same weights."""
    ref_arch, cfg, jbatch, jparams = _ref_world(name, seed)
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


def test_smoke_batches_equal_reference():
    for name in ARCHS:
        _, _, jbatch, _, _, _, tbatch = _world(name)
        assert sorted(jbatch) == sorted(tbatch)
        for k in jbatch:
            np.testing.assert_array_equal(tbatch[k].numpy(),
                                          np.asarray(jbatch[k]))


@pytest.mark.parametrize("name", ARCHS)
def test_forward_loss_and_grads_match_reference(name):
    ref_arch, cfg, jbatch, jparams, arch, model, tbatch = _world(name)
    mod = REF_MODULES[name]
    np.testing.assert_allclose(
        model(tbatch).detach().numpy(),
        np.asarray(jax.jit(mod.forward, static_argnums=2)(jparams, jbatch,
                                                           cfg)), **FWD)
    jloss, jgrads = jax.jit(jax.value_and_grad(ref_arch.loss_fn),
                            static_argnums=2)(jparams, jbatch, cfg)
    loss = arch.loss_fn(model, tbatch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **FWD)
    grads = dict(zip(named_params(model), torch.autograd.grad(
        loss, list(model.parameters()))))
    _close(grads, params_from_jax(name, _np(jgrads)), GRAD, f"{name} grad")


def test_dlrm_retrieval_score_matches_reference():
    _, cfg, _, jparams, _, model, _ = _world("dlrm-rm2", seed=0)
    rng = np.random.default_rng(0)
    rb = {
        "dense": rng.normal(size=(1, cfg.n_dense)).astype(np.float32),
        "sparse": rng.integers(-1, 70, (1, cfg.n_sparse, cfg.hotness)
                               ).astype(np.int32),  # padding and ids >= V
        "cand": rng.normal(size=(1000, cfg.bot_mlp[-1])).astype(np.float32),
    }
    want = np.asarray(ref_dlrm.retrieval_score(
        jparams, {k: jnp.asarray(v) for k, v in rb.items()}, cfg))
    got = dlrm.retrieval_score(model, {k: torch.from_numpy(v)
                                       for k, v in rb.items()})
    assert got.shape == (1000,)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)


# ------------------------------------------------------------ trajectories

# test_arch_loss_decreases's optimizer setting
TRAJ_OPT = dict(lr=3e-3, warmup_steps=1, total_steps=1000, schedule="const",
                weight_decay=0.0)


@functools.lru_cache(maxsize=None)
def _ref_step(name: str, microbatches: int, grad_compress: bool):
    """The reference's jitted train step, compiled once a file."""
    ref_arch, cfg, _, _ = _ref_world(name)
    opt = RefOptConfig(**TRAJ_OPT, grad_compress=grad_compress)
    return jax.jit(ref_make_train_step(ref_arch.loss_fn, cfg, opt,
                                       microbatches=microbatches)), opt


def _trajectory(name, steps: int, microbatches: int = 1,
                grad_compress: bool = False):
    """``test_arch_loss_decreases``'s setting (``PRNGKey(1)``, lr 3e-3,
    const schedule, no weight decay, the smoke batch) for ``steps`` steps
    in both packages; returns both sides' last metrics, params and state,
    and the port's losses."""
    ref_arch, cfg, jbatch, jparams, arch, model, tbatch = _world(name)
    jstep, ref_opt = _ref_step(name, microbatches, grad_compress)
    jstate = ref_adamw_init(jparams, ref_opt)
    opt_cfg = OptConfig(**TRAJ_OPT, grad_compress=grad_compress)
    step = make_train_step(arch.loss_fn, model, opt_cfg,
                           microbatches=microbatches)
    state = adamw_init(named_params(model), opt_cfg)
    jm = tm = None
    losses = []
    for _ in range(steps):
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        _, state, tm = step(model, state, tbatch)
        losses.append(float(tm["loss"]))
    return (jm, jparams, jstate), (tm, model, state), losses


# parameters and moments after a step: AdamW's update is close to
# sign(g)·lr, so a gradient near 0 that the two sums round apart moves a
# parameter by up to lr (3e-3); after 1 step everything must agree to
# 1e-5, after 12 no leaf may drift further than this (and the moments,
# squares and averages of the gradients, as GRAD)
STEP_PARAMS = dict(rtol=1e-4, atol=1e-5)


def _compare_trajectory(name, ref, port, what):
    (jm, jparams, jstate), (tm, model, state) = ref, port
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               err_msg=f"{what} loss", **FWD)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               err_msg=f"{what} grad norm", **GRAD)
    assert int(tm["step"]) == int(jm["step"])
    _close(named_params(model), params_from_jax(name, _np(jparams)),
           STEP_PARAMS, f"{what} params")
    want = adam_state_from_jax(_np(jstate))
    _close(state.mu, want.mu, GRAD, f"{what} mu")
    _close(state.nu, want.nu, GRAD, f"{what} nu")
    if want.err is not None:
        # int8 residuals: a value of g+err that the two packages round to
        # either side of a half step quantizes one step apart, so the
        # residual differs by a step there; such flips are rare, and every
        # other residual agrees as GRAD
        for k, e in want.err.items():
            got, e = state.err[k].numpy(), e.numpy()
            off = ~np.isclose(got, e, **GRAD)
            assert off.mean() <= 0.01, f"{what} err {k}: {off.sum()} flips"


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("steps", [1, 12])
def test_adamw_trajectory_matches_reference(name, steps):
    ref, port, losses = _trajectory(name, steps)
    _compare_trajectory(name, ref, port, f"{name} after {steps}")
    # the reference test's own claim holds in the port
    assert steps == 1 or losses[-1] < losses[0]


@pytest.mark.parametrize("name", ARCHS)
def test_microbatched_compressed_steps_match_reference(name):
    """``microbatches=2`` (for GCN the halves' edge ids reach past their
    20 nodes: gathers clamp and scatters drop as JAX's do, and a clamped
    gather passes no gradient back) with ``grad_compress=True`` (int8 with
    error feedback, its residuals compared too), 3 steps: one compile of
    the reference's step an arch."""
    ref, port, _ = _trajectory(name, 3, microbatches=2, grad_compress=True)
    _compare_trajectory(name, ref, port, f"{name} microbatched, compressed")


def test_resume_reference_trajectory_in_port():
    """3 reference steps, then weights and AdamW state carried across: 3
    more steps in each package agree."""
    _, _, jbatch, jparams, arch, model, tbatch = _world("dlrm-rm2")
    jstep, ref_opt = _ref_step("dlrm-rm2", 1, False)
    jstate = ref_adamw_init(jparams, ref_opt)
    for _ in range(3):
        jparams, jstate, _ = jstep(jparams, jstate, jbatch)
    model.load_state_dict(params_from_jax("dlrm-rm2", _np(jparams)))
    state = adam_state_from_jax(_np(jstate))
    step = make_train_step(arch.loss_fn, model, OptConfig(**TRAJ_OPT))
    for _ in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        _, state, tm = step(model, state, tbatch)
    _compare_trajectory("dlrm-rm2", (jm, jparams, jstate),
                        (tm, model, state), "resumed")


# ------------------------------------------------------------ embedding bag

def _bag_inputs(seed: int = 0, v: int = 7, s: int = 5, k: int = 4, d: int = 3):
    """Ids with padding (-1), ids >= V and ids repeated within a bag."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(-1, v + 3, (s, k)).astype(np.int32)
    idx[0] = [2, 2, 2, -1]  # one row three times in a bag
    idx[1] = [v, v + 5, v - 1, -1]  # all read row V-1
    idx[2] = -1  # an empty bag
    w = rng.uniform(0.5, 1.5, (s, k)).astype(np.float32)
    d_out = rng.normal(size=(s, d)).astype(np.float32)
    return table, idx, w, d_out


@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_backward_matches_autograd_of_plain(weighted):
    table, idx, w, d_out = _bag_inputs()
    ti = torch.from_numpy(idx)

    def run(fn):
        t = torch.from_numpy(table).requires_grad_()
        ws = torch.from_numpy(w).requires_grad_() if weighted else None
        out = fn(t, ti, ws)
        out.backward(torch.from_numpy(d_out))
        return out.detach(), t.grad, None if ws is None else ws.grad

    got = run(EmbeddingBagSum.apply)
    want = run(lambda t, i, ws: kref.segment_gather_fixed_ref(t, i, ws))
    for g, e in zip(got, want):
        if e is None:
            assert g is None
            continue
        # the same float32 products summed in another order
        torch.testing.assert_close(g, e, rtol=1e-6, atol=1e-6)
    assert got[1].shape == table.shape  # dense, as JAX's
    touched = np.zeros(table.shape[0], bool)
    touched[np.minimum(idx[idx >= 0], table.shape[0] - 1)] = True
    np.testing.assert_array_equal((got[1] != 0).any(1).numpy(), touched)


def test_embedding_bag_matches_reference_bags():
    """The port's bags against the reference's ``embed_bags`` and its
    gradient (``jnp.take`` of clipped ids + masked sum)."""
    table, idx, _, d_out = _bag_inputs(seed=1)

    def ref_bag(t):
        return ref_dlrm.embed_bags([t], jnp.asarray(idx)[:, None, :],
                                   jnp.float32)[:, 0]

    want, vjp = jax.vjp(ref_bag, jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    got = embedding_bag_sum(t, torch.from_numpy(idx))
    got.backward(torch.from_numpy(d_out))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(d_out))[0]), **FWD)


# ------------------------------------------------------------ GNN primitives

def test_gnn_segment_ops_match_reference():
    """Each single-device aggregation on segments with ids -1 and n
    (dropped) and an empty segment; gathers by out-of-range ids clamp."""
    rng = np.random.default_rng(3)
    n, e = 6, 40
    x = rng.normal(size=(e, 3)).astype(np.float32)
    seg = rng.integers(-1, n + 1, e).astype(np.int32)
    seg[seg == 4] = 3  # segment 4 stays empty
    scores = rng.normal(size=e).astype(np.float32)
    jx, jseg, jsc = jnp.asarray(x), jnp.asarray(seg), jnp.asarray(scores)
    tx, tseg, tsc = (torch.from_numpy(a) for a in (x, seg, scores))
    pairs = [
        (common.segment_sum(tx, tseg, n), ref_common.segment_sum(jx, jseg, n)),
        (common.segment_mean(tx, tseg, n),
         ref_common.segment_mean(jx, jseg, n)),
        (common.segment_max(tx, tseg, n), ref_common.segment_max(jx, jseg, n)),
        (common.segment_min(tx, tseg, n), ref_common.segment_min(jx, jseg, n)),
        (common.segment_std(tx, tseg, n), ref_common.segment_std(jx, jseg, n)),
        (common.segment_softmax_norm(tsc, tseg, n),
         ref_common.segment_softmax_norm(jsc, jseg, n)),
        (common.degrees(tseg, n), ref_common.degrees(jseg, n)),
        (common.take(tx, torch.tensor([-1, -50, 39, 45, 0])),
         jx[jnp.asarray([-1, -50, 39, 45, 0])]),
        (common.segment_max(tseg, tseg, n),  # integers: least int32 identity
         ref_common.segment_max(jseg, jseg, n)),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"op {i}", **FWD)


def test_abstract_params_and_input_specs_on_meta():
    """The port's abstract model (``meta``) has the reference's parameter
    names and shapes; its input specs have the reference's shapes."""
    for name in ARCHS:
        arch = get_arch(name)
        model = arch.abstract_params(
            lambda cfg, device: model_for(arch, cfg, device, None))
        assert all(p.device.type == "meta" for p in model.parameters())
        ref_tree = ref_get_arch(name).abstract_params(
            REF_MODULES[name].init_params)
        assert {k: tuple(p.shape) for k, p in model.named_parameters()} == {
            k: tuple(s.shape) for k, s in _named_leaves(ref_tree).items()}
        for cell in arch.cells:
            specs = arch.input_specs(cell)
            ref_specs = ref_get_arch(name).input_specs(cell)
            assert {k: (tuple(t.shape), t.device.type)
                    for k, t in specs.items()} == {
                k: (tuple(t.shape), "meta") for k, t in ref_specs.items()}
        if name == "dlrm-rm2":  # RM-2 at its published size
            assert sum(p.numel() for p in model.parameters()) \
                == 1_223_392_321
