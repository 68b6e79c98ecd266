"""The port's MoE block and MLA attention against the reference:
``moe_apply`` (no drops, drops, an expert forced past its capacity, tied
router probabilities) with its gradients, ``_mla_full`` and the absorbed
``_mla_decode`` (a decode step, a multi-token chunk with no causal mask,
a write clamped at the cache's end), then both MoE configs' smoke
geometry (2 layers, d_model 64, 4 experts top-2, vocab 256) with the
reference's weights carried across (``convert.params_from_jax``):
forward, loss with aux and every gradient with remat on and off, the
cache and ``decode_step`` token by token, decode against forward within
the port, AdamW trajectories, the input specs, the full configs'
parameter counts, and the ``launch.train`` CLI.

Inputs come from numpy seeds; the reference runs under JAX on the CPU
(jitted).  Float32 is held to a few float32 ulps; bfloat16 values to a
few bfloat16 ulps norm-wise, and bfloat16 gradients against float32
(the port's no farther from the reference's float32 gradient than twice
the reference's own bfloat16 gradient is).  Tolerances are stated where
used.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.trainstep import make_train_step as ref_make_train_step
from repro_torch.configs import get_arch
from repro_torch.configs.common import LM_SHAPES
from repro_torch.convert import (_named_leaves, adam_state_from_jax,
                                  cache_from_jax, params_from_jax)
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import model_for
from repro_torch.models import layers, moe, transformer
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.trainstep import make_train_step, named_params

ARCHS = ("deepseek-v2-236b", "dbrx-132b")

# float32: values of order 1-10 in a few ulps (the two packages sum
# products in other orders; measured up to 3.3e-6 on logits), gradients
# each element against the leaf's largest |g| and norm-wise (measured up
# to 2.9e-6)
F32 = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = 1e-5
# bfloat16 (unit roundoff 2^-9): each element within 2^-5 of the tensor's
# largest |value| and the tensor within 2e-2 norm-wise (a product rounded
# the other way moves what follows by a bf16 ulp); the loss within 1e-3
# (measured 3.6e-4); a gradient leaf no farther from the reference's
# float32 gradient than twice the reference's own bfloat16 one, and the
# two bfloat16 gradients within three times that distance of each other
BF16_ELEM = 2.0**-5
BF16_NORM = 2e-2
BF16_LOSS = dict(rtol=1e-3, atol=0)
BF16_GRAD_TO_F32 = 2.0
BF16_GRAD_PAIR = 3.0

DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one torch thread keeps the suite's parallel workers
    from oversubscribing the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    """A JAX array (or pytree) as numpy, bfloat16 widened to float32."""
    def one(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return jax.tree.map(one, x)


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _f(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _norm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close(got, want, dtype: str, what: str):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **F32)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=BF16_ELEM * np.abs(want).max(),
            err_msg=what)
        assert _norm_rel(got, want) <= BF16_NORM, what


def _close_grads(got: dict, want: dict, want32: dict | None, what: str,
                 f32: dict | None = None):
    """Float32 gradients leaf by leaf against the reference's (within
    ``F32_GRAD``, or ``f32[leaf]``); bfloat16 ones (``want32`` given)
    against the reference's float32 gradient."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        if want32 is None:
            tol = (f32 or {}).get(k, F32_GRAD)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=f"{what} {k}")
            assert _norm_rel(g, w) <= tol, (what, k)
            continue
        t = want32[k]
        ref_err = np.linalg.norm(w - t)
        assert np.linalg.norm(g - t) <= BF16_GRAD_TO_F32 * ref_err, (what, k)
        assert np.linalg.norm(g - w) <= BF16_GRAD_PAIR * ref_err, (what, k)


# -------------------------------------------------------------- moe_apply

D, E, K, FF = 16, 4, 2, 8

# (tokens, capacity_factor, n_shared, router): no drops, drops, every
# token forced onto experts 0 and 1 at capacity 2, all probabilities
# tied, experts 1 and 2 tied on every token
MOE_CASES = {
    "no_drops": (32, 100.0, 1, None),
    "drops": (32, 0.5, 1, None),
    "forced": (8, 0.5, 0, "forced"),
    "tied_all": (32, 1.25, 1, "zero"),
    "tied_pair": (32, 1.25, 1, "pair"),
}


# in the forced case only token 0 is kept, and the router's gradient is
# x[0] times its logits' gradient, w0·w1·(c0 - c1) / S for experts 0 and
# 1: a difference of two close sums, so float32 keeps fewer digits there
# (measured 2.3e-5 of the largest element, norm-wise likewise)
FORCED_ROUTER = {"router": 1e-4}


def _moe_world(case: str, seed: int = 0):
    """The case's config, weights (the reference's ``moe_init``, then the
    case's router) and input as numpy."""
    t, cf, shared, router = MOE_CASES[case]
    mcfg = dict(n_experts=E, top_k=K, d_ff_expert=FF, n_shared=shared,
                capacity_factor=cf)
    p = jax.tree.map(np.array, ref_moe.moe_init(
        jax.random.PRNGKey(seed), D, ref_moe.MoEConfig(**mcfg)))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, D)).astype(np.float32)
    if router == "forced":
        x[:, 0] = 1.0
        p["router"] = np.zeros((D, E), np.float32)
        p["router"][0, :2] = (2.0, 1.0)
    elif router == "zero":
        p["router"] = np.zeros((D, E), np.float32)
    elif router == "pair":
        p["router"][:, 2] = p["router"][:, 1]
    cot = rng.normal(size=(t, D)).astype(np.float32)
    return mcfg, p, x, cot


@functools.lru_cache(maxsize=None)
def _ref_moe_fn(case: str, dtype: str, with_aux: bool):
    """The reference's jitted y, aux and the gradients of sum(y · cot)
    (+ aux) with respect to every weight and x."""
    mcfg = _moe_world(case)[0]
    jdt = DT[dtype][1]
    cfg = ref_moe.MoEConfig(**mcfg)

    def f(pp, xx, cot):
        y, aux = ref_moe.moe_apply(pp, xx.astype(jdt), cfg)
        loss = jnp.sum(y.astype(jnp.float32) * cot)
        return (loss + aux if with_aux else loss), (y, aux)

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))


def _ref_moe(case: str, dtype: str, with_aux=True):
    _, p, x, cot = _moe_world(case)
    (_, (y, aux)), (gp, gx) = _ref_moe_fn(case, dtype, with_aux)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(cot))
    grads = {"x": np.asarray(gx)}
    grads.update({k: np.asarray(v) for k, v in _named_leaves(gp).items()})
    return _np(y), float(aux), grads


def _port_moe(mcfg: dict, p: dict, x, cot, dtype: str, with_aux=True):
    tdt = DT[dtype][0]
    cfg = moe.MoEConfig(**mcfg)
    block = moe.MoE(D, cfg, device="meta")
    block.load_state_dict({k: _t(v) for k, v in _named_leaves(p).items()},
                          assign=True)
    xt = _t(x).requires_grad_(True)
    y, aux = moe.moe_apply(block, xt.to(tdt), cfg)
    loss = torch.sum(y.float() * _t(cot))
    params = dict(block.named_parameters())
    gs = torch.autograd.grad(loss + aux if with_aux else loss,
                             [xt, *params.values()])
    grads = {"x": gs[0].numpy()}
    grads.update({k: g.numpy() for k, g in zip(params, gs[1:])})
    assert y.dtype == tdt and aux.dtype == torch.float32
    return _f(y), float(aux.detach()), grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(case, dtype):
    """y, the aux loss and the gradients of sum(y · cot) + aux with
    respect to x, the router, each expert leaf and the shared experts."""
    mcfg, p, x, cot = _moe_world(case)
    wy, waux, wg = _ref_moe(case, dtype)
    y, aux, g = _port_moe(mcfg, p, x, cot, dtype)
    _close(y, wy, dtype, f"{case} y")
    np.testing.assert_allclose(aux, waux, err_msg=f"{case} aux",
                               **(F32 if dtype == "float32" else BF16_LOSS))
    _close_grads(g, wg, None if dtype == "float32" else
                 _ref_moe(case, "float32")[2], f"{case} grad",
                 f32=FORCED_ROUTER if case == "forced" else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_overflow_keeps_capacity_minus_one_like_reference(dtype):
    """Every token routed to experts 0 and 1 at capacity 2: each expert
    keeps only token 0 (the reference's CPU scatter lets the dropped
    tokens' zero rows overwrite rank C - 1), so token 1's output and its
    gradient through the experts are exactly 0 in both packages, and the
    dropped tokens' too."""
    mcfg, p, x, cot = _moe_world("forced")
    assert moe.capacity(8, moe.MoEConfig(**mcfg)) == 2
    wy, _, wg = _ref_moe("forced", dtype, with_aux=False)
    y, _, g = _port_moe(mcfg, p, x, cot, dtype, with_aux=False)
    for what, (yy, gg) in {"reference": (wy, wg["x"]),
                           "port": (y, g["x"])}.items():
        assert np.abs(yy[0]).max() > 0, what
        assert np.all(yy[1:] == 0), what
        assert np.abs(gg[0]).max() > 0, what
        assert np.all(gg[1:] == 0), what


def test_moe_top_k_ties_go_to_the_lower_index():
    """Equal probabilities: the lower expert index first, as
    ``jax.lax.top_k``."""
    probs = np.full((3, E), 0.25, np.float32)
    probs[1] = (0.1, 0.3, 0.3, 0.3)
    probs[2] = (0.4, 0.1, 0.4, 0.1)
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs), K)[1])
    # probabilities from logits: log(p) softmaxes back to p
    x = torch.eye(3, 3)
    router = torch.from_numpy(np.log(probs))
    cfg = moe.MoEConfig(n_experts=E, top_k=K, d_ff_expert=FF)
    _, top_i, _ = moe.route(x, router, cfg)
    np.testing.assert_array_equal(top_i.numpy(), want)
    np.testing.assert_array_equal(want, [[0, 1], [1, 2], [0, 2]])


# --------------------------------------------------------------------- MLA

def _mla_world(dtype: str, seed: int = 0):
    """The DeepSeek smoke config's MLA geometry in ``dtype``, random
    attention weights (gains near 1) as numpy, and a port module holding
    them."""
    cfg = dataclasses.replace(ref_get_arch("deepseek-v2-236b").smoke()[0],
                              compute_dtype=dtype)
    pcfg = dataclasses.replace(get_arch("deepseek-v2-236b").smoke()[0],
                               compute_dtype=dtype)
    attn = transformer.MLAAttention(pcfg, device="meta")
    rng = np.random.default_rng(seed)
    p = {}
    for k, t in attn.named_parameters():
        if k.endswith("_ln"):
            p[k] = (1 + 0.1 * rng.normal(size=t.shape)).astype(np.float32)
        else:
            p[k] = (rng.normal(size=t.shape)
                    / np.sqrt(t.shape[0])).astype(np.float32)
    attn.load_state_dict({k: _t(v) for k, v in p.items()}, assign=True)
    return cfg, pcfg, p, attn


def _angles(pos, dim: int):
    ws, wc = ref_layers.rope_angles(jnp.asarray(pos, jnp.int32), dim, 1e4)
    s, c = layers.rope_angles(torch.tensor(pos, dtype=torch.int32), dim, 1e4)
    return ((ws[None, :, None, :], wc[None, :, None, :]),
            (s[None, :, None, :], c[None, :, None, :]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_full_matches_reference(dtype):
    cfg, pcfg, p, attn = _mla_world(dtype)
    tdt, jdt = DT[dtype]
    x = np.random.default_rng(1).normal(size=(2, 8, 64)).astype(np.float32)
    (ws, wc), (s, c) = _angles(np.arange(8), cfg.rope_head_dim)
    want = _np(jax.jit(ref_tf._mla_full, static_argnums=2)(
        jnp.asarray(x, jdt), jax.tree.map(jnp.asarray, p), cfg, ws, wc))
    got = transformer._mla_full(_t(x, tdt), attn, pcfg, s, c)
    assert got.dtype == tdt
    _close(_f(got), want, dtype, "_mla_full")


# (pos, s): one token into a cache half full, a chunk of 3 (no causal
# mask inside it), a chunk whose write clamps at the cache's end
MLA_DECODE_CASES = [(5, 1), (4, 3), (10, 3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(dtype):
    """The absorbed decode: its output and both caches after the write,
    on caches filled from a seed."""
    cfg, pcfg, p, attn = _mla_world(dtype)
    tdt, jdt = DT[dtype]
    rng = np.random.default_rng(2)
    for pos, s in MLA_DECODE_CASES:
        x = rng.normal(size=(2, s, 64)).astype(np.float32)
        ckv = rng.normal(size=(2, 12, cfg.kv_lora)).astype(np.float32)
        kr = rng.normal(size=(2, 12, cfg.rope_head_dim)).astype(np.float32)
        (ws, wc), (sn, cs) = _angles(pos + np.arange(s), cfg.rope_head_dim)
        want, wckv, wkr = _np(jax.jit(ref_tf._mla_decode,
                                      static_argnums=(2, 5))(
            jnp.asarray(x, jdt), jax.tree.map(jnp.asarray, p), cfg,
            jnp.asarray(ckv, jdt), jnp.asarray(kr, jdt), pos, ws, wc))
        tckv, tkr = _t(ckv, tdt), _t(kr, tdt)
        got = transformer._mla_decode(_t(x, tdt), attn, pcfg, tckv, tkr, pos,
                                      sn, cs)
        assert got.dtype == tdt
        _close(_f(got), want, dtype, f"_mla_decode {pos}, {s}")
        _close(_f(tckv), wckv, dtype, f"ckv {pos}, {s}")
        _close(_f(tkr), wkr, dtype, f"krope {pos}, {s}")


# ------------------------------------------------------------------ models

def _stacked(state: dict) -> dict:
    """The reference's parameter pytree from the port's state dict: the
    inverse of ``convert.params_from_jax`` (``dense_layers.{i}.<leaf>``
    and ``moe_layers.{i}.<leaf>`` stacked over ``i``), as JAX arrays."""
    tree, layers = {}, {}
    for k, v in state.items():
        parts = k.split(".")
        if parts[0] in ("dense_layers", "moe_layers"):
            layers.setdefault((parts[0], *parts[2:]), []).append(
                v.numpy())
            continue
        tree[k] = jnp.asarray(v.numpy())
    for (stack, *path), vs in layers.items():
        node = tree.setdefault(stack, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(np.stack(vs))
    return tree


@functools.lru_cache(maxsize=None)
def _ref_params(name: str, seed: int):
    """Smoke weights drawn by the port's initializers (seed ``seed``),
    stacked as the reference holds them: the reference's own
    ``init_params`` takes seconds to compile for each config."""
    arch = get_arch(name)
    model = model_for(arch, arch.smoke()[0], "cpu",
                      torch.Generator().manual_seed(seed))
    return _stacked(model.state_dict())


@functools.lru_cache(maxsize=None)
def _ref_world(name: str, dtype: str, seed: int = 1):
    """The reference's smoke config (compute ``dtype``, remat off), batch
    and weights (``_ref_params``), built once a file."""
    ref_arch = ref_get_arch(name)
    cfg, jbatch = ref_arch.smoke()
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, remat=False)
    jparams = _ref_params(name, seed)
    want = jax.eval_shape(lambda k: ref_tf.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(jparams) == jax.tree.structure(want)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(jparams),
                                                   jax.tree.leaves(want)))
    return ref_arch, cfg, jbatch, jparams


def _world(name: str, dtype: str, remat: bool = False, seed: int = 1):
    """The reference's world, and the port's smoke batch and a module
    holding the same weights (remat as asked)."""
    ref_arch, cfg, jbatch, jparams = _ref_world(name, dtype, seed)
    arch = get_arch(name)
    pcfg, tbatch = arch.smoke()
    pcfg = dataclasses.replace(pcfg, compute_dtype=dtype, remat=remat)
    model = model_for(arch, pcfg, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(name, _np(jparams)))
    return ref_arch, cfg, jbatch, jparams, arch, model, tbatch


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(name: str, dtype: str):
    ref_arch, cfg, jbatch, jparams = _ref_world(name, dtype)
    loss, grads = jax.jit(jax.value_and_grad(ref_arch.loss_fn),
                          static_argnums=2)(jparams, jbatch, cfg)
    return float(loss), params_from_jax(name, _np(grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_loss_and_grads_match_reference(name, dtype):
    """Logits and the aux loss, then the loss (with aux) and every
    gradient with remat on (``torch.utils.checkpoint`` a layer: the MoE
    dispatch recomputed) and off."""
    _, cfg, jbatch, jparams, _, model, tbatch = _world(name, dtype)
    jlogits, jaux = jax.jit(ref_tf.forward, static_argnums=2)(
        jparams, jbatch["tokens"], cfg)
    logits, aux = transformer.forward(model, tbatch["tokens"])
    assert logits.dtype == DT[dtype][0] and float(aux.detach()) > 0
    _close(_f(logits), _np(jlogits), dtype, f"{name} logits")
    np.testing.assert_allclose(float(aux), float(jaux),
                               err_msg=f"{name} aux",
                               **(F32 if dtype == "float32" else BF16_LOSS))
    jloss, want = _ref_value_and_grad(name, dtype)
    want32 = (None if dtype == "float32"
              else _ref_value_and_grad(name, "float32")[1])
    for remat in (True, False):
        _, _, _, _, arch, model, tbatch = _world(name, dtype, remat=remat)
        loss = arch.loss_fn(model, tbatch)
        np.testing.assert_allclose(float(loss.detach()), jloss,
                                   err_msg=f"{name} loss remat={remat}",
                                   **(F32 if dtype == "float32"
                                      else BF16_LOSS))
        params = named_params(model)
        grads = torch.autograd.grad(loss, list(params.values()))
        _close_grads({k: _f(g) for k, g in zip(params, grads)},
                     {k: v.numpy() for k, v in want.items()},
                     None if want32 is None else
                     {k: v.numpy() for k, v in want32.items()},
                     f"{name} remat={remat} grad")


@functools.lru_cache(maxsize=None)
def _ref_decode(name: str, dtype: str):
    return jax.jit(ref_tf.decode_step, static_argnums=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_reference(name, dtype):
    """``init_cache`` (MLA's ``ckv`` / ``krope`` or GQA's ``k`` / ``v``),
    then 16 tokens one by one into a cache of 20, each step's logits and
    the final cache against the reference's (its MoE layers route the
    step's B tokens with their own capacity); then a chunk of 6 tokens
    into a fresh cache."""
    _, cfg, jbatch, jparams, _, model, tbatch = _world(name, dtype)
    step = _ref_decode(name, dtype)
    jtok, tok = jbatch["tokens"], tbatch["tokens"]
    jcache = ref_tf.init_cache(cfg, 2, 20)
    cache = transformer.init_cache(model.cfg, 2, 20)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in cache.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
    for t in range(tok.shape[1]):
        jl, jcache = step(jparams, jcache, jtok[:, t:t + 1], cfg)
        lg, cache = transformer.decode_step(model, cache, tok[:, t:t + 1])
        _close(_f(lg), _np(jl), dtype, f"{name} decode logits at {t}")
    want = cache_from_jax(jcache)
    assert int(cache["pos"]) == int(want["pos"]) == tok.shape[1]
    for k in want:
        assert cache[k].dtype == want[k].dtype
        _close(_f(cache[k]), _f(want[k]), dtype, f"{name} cache {k}")
    jl, jc = step(jparams, ref_tf.init_cache(cfg, 2, 20), jtok[:, :6], cfg)
    lg, c = transformer.decode_step(model, transformer.init_cache(
        model.cfg, 2, 20), tok[:, :6])
    _close(_f(lg), _np(jl), dtype, f"{name} chunk logits")
    want = cache_from_jax(jc)
    for k in want:
        _close(_f(c[k]), _f(want[k]), dtype, f"{name} chunk cache {k}")


def test_mla_decode_matches_forward():
    """The reference's ``test_mla_decode_matches_forward`` on the port:
    absorbed MLA decode, token by token, equals the full MLA forward in
    float32 (capacity_factor 8, so that no token is dropped: decode routes
    2 tokens a step, the forward 16).  Measured 1.5e-6; held to 1e-5 of
    the largest logit."""
    arch = get_arch("deepseek-v2-236b")
    cfg, batch = arch.smoke()
    cfg = dataclasses.replace(
        cfg, compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = model_for(arch, cfg, "cpu", torch.Generator().manual_seed(3))
    tokens = batch["tokens"][:, :8]
    with torch.no_grad():
        full, _ = transformer.forward(model, tokens)
    cache = transformer.init_cache(cfg, 2, 16)
    dec = torch.cat([transformer.decode_step(model, cache,
                                             tokens[:, t:t + 1])[0]
                     for t in range(8)], 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=0,
                               atol=1e-5 * float(full.abs().max()))


# ------------------------------------------------------------ trajectories

TRAJ_OPT = dict(lr=3e-3, warmup_steps=1, total_steps=1000, schedule="const",
                weight_decay=0.0)
# as tests/test_torch_lm.py: each parameter within 5% of lr, each leaf
# within 2e-5 norm-wise, the moments each element within 1e-4 of the
# leaf's largest and 2e-5 norm-wise, the gradient norm within 1e-5
TRAJ_PARAM = 0.05 * TRAJ_OPT["lr"]
TRAJ_NORM = 2e-5
TRAJ_MOMENT = 1e-4


@functools.lru_cache(maxsize=None)
def _ref_trajectory(name: str):
    ref_arch, cfg, jbatch, jparams = _ref_world(name, "float32")
    jstep = jax.jit(ref_make_train_step(ref_arch.loss_fn, cfg,
                                        RefOptConfig(**TRAJ_OPT)))
    jstate = ref_adamw_init(jparams, RefOptConfig(**TRAJ_OPT))
    metrics = []
    for _ in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        metrics.append({k: float(v) for k, v in jm.items()})
    return metrics, params_from_jax(name, _np(jparams)), \
        adam_state_from_jax(_np(jstate))


@pytest.mark.parametrize("remat", [True, False])
def test_adamw_trajectory_matches_reference(remat):
    """Three AdamW steps of deepseek-v2-236b's smoke config in float32,
    the port with remat on and off against the reference's trajectory."""
    name = "deepseek-v2-236b"
    _, _, _, _, arch, model, tbatch = _world(name, "float32", remat=remat)
    metrics, want, wstate = _ref_trajectory(name)
    opt_cfg = OptConfig(**TRAJ_OPT)
    step = make_train_step(arch.loss_fn, model, opt_cfg)
    state = adamw_init(named_params(model), opt_cfg)
    for i, jm in enumerate(metrics):
        _, state, tm = step(model, state, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), jm["loss"],
                                   err_msg=f"loss at {i}", **F32)
        np.testing.assert_allclose(float(tm["grad_norm"]), jm["grad_norm"],
                                   rtol=1e-5, err_msg=f"grad norm at {i}")
    for k, p in named_params(model).items():
        np.testing.assert_allclose(_f(p), want[k].numpy(), rtol=0,
                                   atol=TRAJ_PARAM, err_msg=k)
        assert _norm_rel(_f(p), want[k].numpy()) <= TRAJ_NORM, k
    assert int(state.step) == int(wstate.step) == 3
    for which in ("mu", "nu"):
        for k, w in getattr(wstate, which).items():
            got, w = getattr(state, which)[k].numpy(), w.numpy()
            np.testing.assert_allclose(got, w, rtol=0,
                                       atol=TRAJ_MOMENT * np.abs(w).max(),
                                       err_msg=f"{which} {k}")
            assert _norm_rel(got, w) <= TRAJ_NORM, (which, k)


# ------------------------------------------------------- configs and specs

@pytest.mark.parametrize("name", ARCHS)
def test_smoke_config_and_batch_equal_reference(name):
    """Every field, the smoke MoE config's included."""
    ref_cfg, jbatch = ref_get_arch(name).smoke()
    cfg, tbatch = get_arch(name).smoke()
    for f in dataclasses.fields(cfg):
        if f.name == "moe":
            assert dataclasses.asdict(cfg.moe) == \
                dataclasses.asdict(ref_cfg.moe), name
        else:
            assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), \
                (name, f.name)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(),
                                      np.asarray(jbatch[k]))


@pytest.mark.parametrize("name", ARCHS)
def test_meta_params_and_input_specs_match_reference(name):
    """The full config on ``meta``: every parameter's name and shape (the
    reference's ``dense_layers`` and ``moe_layers`` stacks split), the
    total against the reference's ``init_params`` under
    ``jax.eval_shape``, the analytic counts, and the four ``LM_SHAPES``
    cells' input specs (MLA's decode cache included)."""
    arch = get_arch(name)
    model = arch.abstract_params(
        lambda cfg, device: model_for(arch, cfg, device, None))
    assert all(p.device.type == "meta" for p in model.parameters())
    ref_tree = _named_leaves(ref_get_arch(name).abstract_params(
        ref_tf.init_params))
    want = {}
    for k, s in ref_tree.items():
        stack = next((p for p in ("dense_layers.", "moe_layers.")
                      if k.startswith(p)), None)
        if stack is None:
            want[k] = tuple(s.shape)
            continue
        for i in range(s.shape[0]):
            want[f"{stack}{i}.{k[len(stack):]}"] = tuple(s.shape[1:])
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == want
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in ref_tree.values())
    ref_cfg = ref_get_arch(name).config
    assert arch.config.param_count() == ref_cfg.param_count()
    assert arch.config.active_param_count() == ref_cfg.active_param_count()
    assert sorted(arch.cells) == sorted(LM_SHAPES)
    for cell in LM_SHAPES:
        specs = arch.input_specs(cell)
        ref_specs = ref_get_arch(name).input_specs(cell)
        got = {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
               for k, t in _named_leaves(specs).items()}
        assert got == {k: (tuple(t.shape), str(t.dtype))
                       for k, t in _named_leaves(ref_specs).items()}, cell
    if name == "deepseek-v2-236b":
        cache = arch.input_specs("decode_32k")["cache"]
        assert tuple(cache["ckv"].shape) == (60, 128, 32768, 512)
        assert tuple(cache["krope"].shape) == (60, 128, 32768, 64)


# ------------------------------------------------------------- launch CLI

@pytest.mark.parametrize("name", ARCHS)
def test_launch_train_moe_on_cpu(name, tmp_path, capsys):
    tr = launch_train.main(["--arch", name, "--device", "cpu", "--steps",
                            "3", "--ckpt-dir", str(tmp_path)])
    assert "final step=3 loss=" in capsys.readouterr().out
    assert np.isfinite(tr.metrics_log[-1]["loss"])
    assert len(tr.params.moe_layers) == (1 if name == "deepseek-v2-236b"
                                         else 2)
