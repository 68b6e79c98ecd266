"""The port's dense LM against the reference: each layer (RMSNorm, RoPE,
GQA attention, SwiGLU), the forward, loss and every gradient of the three
dense configs' smoke geometry (2 layers, d_model 64, vocab 256) with the
reference's weights carried across (``convert.params_from_jax``), the KV
cache and ``decode_step`` (token by token and as one chunk), AdamW
trajectories with and without remat, ``TokenStream``, the input specs,
the full configs' parameter counts, and the ``launch.train`` CLI.

Inputs come from numpy seeds; the reference runs under JAX on the CPU as
its own tests run it (jitted).  Float32 compute is held to a few float32
ulps; bfloat16 compute to a few bfloat16 ulps, norm-wise (the two
packages round the same bf16 products in other summation orders, and a
one-ulp flip early moves what follows).  Tolerances are stated where
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
from repro.models import transformer as ref_tf
from repro.train import data as ref_data
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.trainstep import make_train_step as ref_make_train_step
from repro_torch.configs import get_arch
from repro_torch.configs.common import LM_SHAPES
from repro_torch.convert import (_named_leaves, adam_state_from_jax,
                                  cache_from_jax, params_from_jax)
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import model_for
from repro_torch.models import layers, transformer
from repro_torch.train.data import TokenStream
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.trainstep import make_train_step, named_params

LMS = ("qwen2-1.5b", "qwen3-8b", "minitron-8b")

# float32 compute: values of order 1-4 (logits, caches, layer outputs)
# in a few ulps (XLA fuses and sums in other orders; measured up to
# 2.4e-6); a gradient leaf norm-wise and each element against the leaf's
# largest |g| (measured up to 1.6e-6 both)
F32 = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = 1e-5
# bfloat16 compute (unit roundoff 2^-9): the two packages round the same
# bf16 products after sums in other orders, and a flip early moves what
# follows.  Values: each element within 2^-5 of the tensor's largest
# |value| (a few bf16 ulps of its top binade; measured 1.0%), the tensor
# within 2e-2 norm-wise (measured 8.1e-3).  The loss within 1e-3
# (measured 2.5e-4).  A gradient leaf with much cancellation (a bias of
# k, a norm's gain) has no bf16 digits to compare, so each leaf is held
# against float32: the port's bf16 gradient lies no farther from the
# reference's float32 one than twice the reference's own bf16 gradient
# does (measured 1.45x), and the two bf16 gradients lie within three
# times that distance of each other (measured 1.91x)
BF16_ELEM = 2.0**-5
BF16_NORM = 2e-2
BF16_LOSS = dict(rtol=1e-3, atol=0)
BF16_GRAD_TO_F32 = 2.0
BF16_GRAD_PAIR = 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one torch thread keeps the suite's
    parallel workers from oversubscribing the cores (restored after)."""
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
    t = torch.from_numpy(np.ascontiguousarray(a))
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


def _close_grad(got, want, what: str):
    """A float32 gradient leaf against the reference's."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_GRAD * np.abs(want).max(),
                               err_msg=what)
    assert _norm_rel(got, want) <= F32_GRAD, what


DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype):
    tdt, jdt = DT[dtype]
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 64)) * 3).astype(np.float32)
    g = rng.normal(size=64).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    want = _np(ref_layers.rmsnorm(jnp.asarray(x, jdt), jnp.asarray(g)))
    got = layers.rmsnorm(_t(x, tdt), _t(g))
    assert got.dtype == tdt
    _close(_f(got), want, dtype, "rmsnorm")
    want = _np(ref_layers.layernorm(jnp.asarray(x, jdt), jnp.asarray(g),
                                    jnp.asarray(b)))
    got = layers.layernorm(_t(x, tdt), _t(g), _t(b))
    _close(_f(got), want, dtype, "layernorm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    """Angles at small and large positions (up to long_500k's), then the
    half-split rotation."""
    tdt, jdt = DT[dtype]
    pos = np.array([0, 1, 7, 4095, 32767, 524287], np.int32)
    for theta in (1e4, 1e6):
        ws, wc = ref_layers.rope_angles(jnp.asarray(pos), 16, theta)
        s, c = layers.rope_angles(_t(pos), 16, theta)
        assert s.dtype == c.dtype == torch.float32 and s.shape == (6, 8)
        # sin / cos of angles up to 5e5 rad: float32 argument reduction
        # agrees to a few ulps of the angle
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), atol=1e-4)
        np.testing.assert_allclose(c.numpy(), np.asarray(wc), atol=1e-4)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    ws, wc = ref_layers.rope_angles(jnp.asarray(pos), 16, 1e6)
    want = _np(ref_layers.apply_rope(jnp.asarray(x, jdt),
                                     ws[None, :, None, :],
                                     wc[None, :, None, :]))
    s, c = layers.rope_angles(_t(pos), 16, 1e6)
    got = layers.apply_rope(_t(x, tdt), s[None, :, None, :],
                            c[None, :, None, :])
    assert got.dtype == tdt
    _close(_f(got), want, dtype, "apply_rope")


def _qkv(seed: int, s: int, t: int, hq: int = 4, hkv: int = 2, d: int = 16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, s, hq, d)).astype(np.float32),
            rng.normal(size=(2, t, hkv, d)).astype(np.float32),
            rng.normal(size=(2, t, hkv, d)).astype(np.float32))


# (causal, q_offset, kv_len, s, t): training, a decode step into a cache
# half full, a chunk with an offset, and a cache with no valid entry
ATTN_CASES = [(True, 0, None, 8, 8), (False, 0, 5, 1, 12),
              (True, 4, 10, 3, 12), (False, 0, 0, 2, 6)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fp32_logits", [True, False])
def test_gqa_matches_reference(dtype, fp32_logits):
    """``_gqa`` (finfo-min mask, hand-written softmax) and
    ``layers.gqa_attention`` (-1e30 mask, float32 softmax) on each case;
    ``fp32_logits`` applies to ``_gqa``."""
    tdt, jdt = DT[dtype]
    for i, (causal, off, kv_len, s, t) in enumerate(ATTN_CASES):
        q, k, v = _qkv(i, s, t)
        jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
        tq, tk, tv = (_t(a, tdt) for a in (q, k, v))
        want = _np(ref_tf._gqa(jq, jk, jv, causal=causal, q_offset=off,
                               kv_len=kv_len, fp32_logits=fp32_logits))
        got = transformer._gqa(tq, tk, tv, causal=causal, q_offset=off,
                               kv_len=kv_len, fp32_logits=fp32_logits)
        assert got.dtype == tdt and got.shape == want.shape
        _close(_f(got), want, dtype, f"_gqa case {i}")
        if fp32_logits:
            want = _np(ref_layers.gqa_attention(jq, jk, jv, causal=causal,
                                                q_offset=off, kv_len=kv_len))
            got = layers.gqa_attention(tq, tk, tv, causal=causal,
                                       q_offset=off, kv_len=kv_len)
            _close(_f(got), want, dtype, f"gqa_attention case {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_reference(dtype):
    tdt, jdt = DT[dtype]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    ws = [rng.normal(size=sh).astype(np.float32) * 0.125
          for sh in ((64, 128), (64, 128), (128, 64))]
    want = _np(ref_layers.swiglu(jnp.asarray(x, jdt),
                                 *map(jnp.asarray, ws)))
    got = layers.swiglu(_t(x, tdt), *map(_t, ws))
    _close(_f(got), want, dtype, "swiglu")


# ----------------------------------------------------------------- models

@functools.lru_cache(maxsize=None)
def _ref_world(name: str, dtype: str, remat: bool = False, seed: int = 1):
    """The reference's smoke config (compute ``dtype``), batch and weights
    (``PRNGKey(seed)``), built once a file."""
    ref_arch = ref_get_arch(name)
    cfg, jbatch = ref_arch.smoke()
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, remat=remat)
    jparams = jax.jit(ref_tf.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)
    return ref_arch, cfg, jbatch, jparams


def _world(name: str, dtype: str, remat: bool = False, seed: int = 1):
    """The reference's world, and the port's smoke batch and a module
    holding the same weights."""
    ref_arch, cfg, jbatch, jparams = _ref_world(name, dtype, remat, seed)
    arch = get_arch(name)
    pcfg, tbatch = arch.smoke()
    pcfg = dataclasses.replace(pcfg, compute_dtype=dtype, remat=remat)
    model = model_for(arch, pcfg, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(name, _np(jparams)))
    return ref_arch, cfg, jbatch, jparams, arch, model, tbatch


def test_smoke_configs_and_batches_equal_reference():
    for name in LMS:
        ref_cfg, jbatch = ref_get_arch(name).smoke()
        cfg, tbatch = get_arch(name).smoke()
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), \
                (name, f.name)
        for k in jbatch:
            np.testing.assert_array_equal(tbatch[k].numpy(),
                                          np.asarray(jbatch[k]))


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(name: str, dtype: str):
    ref_arch, cfg, _, _ = _ref_world(name, dtype)
    return jax.jit(jax.value_and_grad(ref_arch.loss_fn), static_argnums=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LMS)
def test_forward_loss_and_grads_match_reference(name, dtype):
    ref_arch, cfg, jbatch, jparams, arch, model, tbatch = _world(name, dtype)
    jlogits, _ = jax.jit(ref_tf.forward, static_argnums=2)(
        jparams, jbatch["tokens"], cfg)
    logits, aux = transformer.forward(model, tbatch["tokens"])
    assert logits.dtype == DT[dtype][0] and float(aux) == 0.0
    _close(_f(logits), _np(jlogits), dtype, f"{name} logits")
    jloss, jgrads = _ref_value_and_grad(name, dtype)(jparams, jbatch, cfg)
    loss = arch.loss_fn(model, tbatch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               err_msg=f"{name} loss",
                               **(F32 if dtype == "float32" else BF16_LOSS))
    params = named_params(model)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    want = params_from_jax(name, _np(jgrads))
    assert sorted(grads) == sorted(want)
    if dtype == "float32":
        for k, w in want.items():
            _close_grad(_f(grads[k]), w.numpy(), f"{name} grad {k}")
        return
    _, cfg32, _, _ = _ref_world(name, "float32")
    _, g32 = _ref_value_and_grad(name, "float32")(jparams, jbatch, cfg32)
    g32 = params_from_jax(name, _np(g32))
    for k, w in want.items():
        g, w, t = _f(grads[k]), w.numpy(), g32[k].numpy()
        ref_err = np.linalg.norm(w - t)
        assert np.linalg.norm(g - t) <= BF16_GRAD_TO_F32 * ref_err, (name, k)
        assert np.linalg.norm(g - w) <= BF16_GRAD_PAIR * ref_err, (name, k)


# ------------------------------------------------------------------ decode

@functools.lru_cache(maxsize=None)
def _ref_decode(name: str, dtype: str):
    _, cfg, _, _ = _ref_world(name, dtype)
    return jax.jit(ref_tf.decode_step, static_argnums=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LMS)
def test_decode_matches_reference_and_forward(name, dtype):
    """Token by token into a cache of 20 (16 tokens), then the first 6
    tokens as one chunk (which attends to its own later tokens, as the
    reference's ``causal=False`` does): logits and caches against the
    reference's; and within the port, decode against forward."""
    _, cfg, jbatch, jparams, _, model, tbatch = _world(name, dtype)
    step = _ref_decode(name, dtype)
    jtok, tok = jbatch["tokens"], tbatch["tokens"]
    jcache = ref_tf.init_cache(cfg, 2, 20)
    cache = transformer.init_cache(model.cfg, 2, 20)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in cache.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
    outs = []
    for t in range(tok.shape[1]):
        jl, jcache = step(jparams, jcache, jtok[:, t:t + 1], cfg)
        lg, cache = transformer.decode_step(model, cache, tok[:, t:t + 1])
        _close(_f(lg), _np(jl), dtype, f"{name} decode logits at {t}")
        outs.append(lg[:, 0])
    want = cache_from_jax(jcache)
    assert int(cache["pos"]) == int(want["pos"]) == tok.shape[1]
    for k in ("k", "v"):
        assert cache[k].dtype == want[k].dtype
        _close(_f(cache[k]), _f(want[k]), dtype, f"{name} cache {k}")
    # decode against forward, within the port
    full, _ = transformer.forward(model, tok)
    _close(_f(torch.stack(outs, 1)), _f(full), dtype,
           f"{name} decode against forward")
    # a chunk of 6 tokens into a fresh cache
    jl, jc = step(jparams, ref_tf.init_cache(cfg, 2, 20), jtok[:, :6], cfg)
    lg, c = transformer.decode_step(model, transformer.init_cache(
        model.cfg, 2, 20), tok[:, :6])
    _close(_f(lg), _np(jl), dtype, f"{name} chunk logits")
    want = cache_from_jax(jc)
    for k in ("k", "v"):
        _close(_f(c[k]), _f(want[k]), dtype, f"{name} chunk cache {k}")
    assert int(c["pos"]) == 6


def test_decode_clamps_a_write_past_the_cache_like_reference():
    """A chunk written at ``pos`` past ``max_len - s`` lands at ``max_len -
    s`` (``dynamic_update_slice`` clamps), with ``kv_len = pos + s``."""
    name = "qwen2-1.5b"
    _, cfg, jbatch, jparams, _, model, tbatch = _world(name, "float32")
    jcache = dict(ref_tf.init_cache(cfg, 2, 8), pos=jnp.asarray(6, jnp.int32))
    cache = transformer.init_cache(model.cfg, 2, 8)
    cache["pos"] = torch.tensor(6, dtype=torch.int32)
    jl, jc = _ref_decode(name, "float32")(jparams, jcache,
                                          jbatch["tokens"][:, :4], cfg)
    lg, c = transformer.decode_step(model, cache, tbatch["tokens"][:, :4])
    _close(_f(lg), _np(jl), "float32", "clamped chunk logits")
    want = cache_from_jax(jc)
    for k in ("k", "v"):
        _close(_f(c[k]), _f(want[k]), "float32", f"clamped cache {k}")
    assert int(c["pos"]) == int(want["pos"]) == 10


# ------------------------------------------------------------ trajectories

TRAJ_OPT = dict(lr=3e-3, warmup_steps=1, total_steps=1000, schedule="const",
                weight_decay=0.0)
# after 3 steps: Adam divides each gradient by its own running RMS, so an
# element whose gradient sits near rounding level moves by a part of lr
# that the rounding decides: each parameter within 5% of lr (measured
# 1.5%), each leaf within 2e-5 norm-wise (measured 4.0e-6); the moments
# each element within 1e-4 of its leaf's largest (measured 1.4e-5) and
# 2e-5 norm-wise (measured 5.3e-6); the gradient norm within 1e-5
# (measured 5.2e-7)
TRAJ_PARAM = 0.05 * TRAJ_OPT["lr"]
TRAJ_NORM = 2e-5
TRAJ_MOMENT = 1e-4


@pytest.mark.parametrize("remat", [True, False])
def test_adamw_trajectory_matches_reference(remat):
    """Three AdamW steps of qwen3-8b's smoke config in float32, with remat
    (``jax.checkpoint`` / ``torch.utils.checkpoint``) and without."""
    name = "qwen3-8b"
    ref_arch, cfg, jbatch, jparams, arch, model, tbatch = _world(
        name, "float32", remat=remat)
    assert model.cfg.remat is remat
    jstep = jax.jit(ref_make_train_step(ref_arch.loss_fn, cfg,
                                        RefOptConfig(**TRAJ_OPT)))
    jstate = ref_adamw_init(jparams, RefOptConfig(**TRAJ_OPT))
    opt_cfg = OptConfig(**TRAJ_OPT)
    step = make_train_step(arch.loss_fn, model, opt_cfg)
    state = adamw_init(named_params(model), opt_cfg)
    for i in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        _, state, tm = step(model, state, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   err_msg=f"loss at {i}", **F32)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   err_msg=f"grad norm at {i}")
    want = params_from_jax(name, _np(jparams))
    for k, p in named_params(model).items():
        np.testing.assert_allclose(_f(p), want[k].numpy(), rtol=0,
                                   atol=TRAJ_PARAM, err_msg=k)
        assert _norm_rel(_f(p), want[k].numpy()) <= TRAJ_NORM, k
    wstate = adam_state_from_jax(_np(jstate))
    assert int(state.step) == int(wstate.step) == 3
    for which in ("mu", "nu"):
        for k, w in getattr(wstate, which).items():
            got, w = getattr(state, which)[k].numpy(), w.numpy()
            np.testing.assert_allclose(got, w, rtol=0,
                                       atol=TRAJ_MOMENT * np.abs(w).max(),
                                       err_msg=f"{which} {k}")
            assert _norm_rel(got, w) <= TRAJ_NORM, (which, k)


# ----------------------------------------------------------- data, specs

def test_token_stream_matches_reference_at_lm_vocab():
    ours = TokenStream(vocab=151936, batch=3, seq=257, seed=5)
    theirs = ref_data.TokenStream(vocab=151936, batch=3, seq=257, seed=5)
    for step in (0, 1, 2, 9, 1000):
        got, want = ours.batch_at(step), theirs.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", LMS)
def test_meta_params_and_input_specs_match_reference(name):
    """The full config on ``meta``: every parameter's name and shape (the
    reference's layer stacks split), the total count, and the four
    ``LM_SHAPES`` cells' input specs."""
    arch = get_arch(name)
    model = arch.abstract_params(
        lambda cfg, device: model_for(arch, cfg, device, None))
    assert all(p.device.type == "meta" for p in model.parameters())
    ref_tree = _named_leaves(ref_get_arch(name).abstract_params(
        ref_tf.init_params))
    want = {}
    for k, s in ref_tree.items():
        if k.startswith("dense_layers."):
            for i in range(s.shape[0]):
                want[f"dense_layers.{i}.{k[13:]}"] = tuple(s.shape[1:])
        else:
            want[k] = tuple(s.shape)
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == want
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in ref_tree.values())
    if name == "qwen2-1.5b":  # embedding and head untied
        assert n == 1_777_088_000
    assert arch.config.param_count() == ref_get_arch(name).config.param_count()
    assert arch.config.active_param_count() == \
        ref_get_arch(name).config.active_param_count()
    assert sorted(arch.cells) == sorted(LM_SHAPES)
    for cell in LM_SHAPES:
        specs = arch.input_specs(cell)
        ref_specs = ref_get_arch(name).input_specs(cell)
        got = {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
               for k, t in _named_leaves(specs).items()}
        assert got == {k: (tuple(t.shape), str(t.dtype))
                       for k, t in _named_leaves(ref_specs).items()}, cell
        assert all(t.device.type == "meta"
                   for t in _named_leaves(specs).values())


# ------------------------------------------------------------- launch CLI

def test_launch_train_lm_on_cpu(tmp_path, capsys):
    tr = launch_train.main(["--arch", "qwen3-8b", "--device", "cpu",
                            "--steps", "3", "--ckpt-dir", str(tmp_path)])
    assert "final step=3 loss=" in capsys.readouterr().out
    assert np.isfinite(tr.metrics_log[-1]["loss"])
    assert isinstance(tr.params, transformer.TransformerLM)
    assert tr.stream.batch_at(0)["tokens"].shape == (2, 16)
    assert tr.ckpt.latest_step() == 3
    # --batch, --seq and --microbatches on the smoke geometry
    tr = launch_train.main(["--arch", "qwen2-1.5b", "--device", "cpu",
                            "--steps", "2", "--batch", "4", "--seq", "8",
                            "--microbatches", "2",
                            "--ckpt-dir", str(tmp_path)])
    assert tr.stream.batch_at(0)["tokens"].shape == (4, 8)
    assert int(tr.opt_state.step) == 2


@pytest.mark.parametrize("argv", [[], ["--batch", "4"], ["--seq", "4096"]])
def test_launch_train_full_lm_needs_batch_and_seq(argv):
    with pytest.raises(SystemExit, match="needs --batch and --seq"):
        launch_train.main(["--arch", "qwen2-1.5b", "--preset", "full",
                           "--device", "cpu"] + argv)


@pytest.mark.parametrize("change", [dict(remat_policy="dots")])
def test_unported_variants_raise(change):
    """The variants the port once refused (``remat_policy="dots"``, ported
    with the dry run) now raise nothing: they build, make a cache, and
    their loss and gradients equal the default's (float32, remat on)."""
    arch = get_arch("qwen3-8b")
    base, batch = arch.smoke()
    base = dataclasses.replace(base, compute_dtype="float32", remat=True)
    cfg = dataclasses.replace(base, **change)
    transformer.TransformerLM(cfg, device="meta")
    assert transformer.init_cache(cfg, 1, 4)["k"].shape[:3] == (
        cfg.n_layers, 1, 4)
    runs = []
    for c in (cfg, base):
        model = model_for(arch, c, "cpu", torch.Generator().manual_seed(0))
        loss = transformer.loss_fn(model, batch)
        runs.append((float(loss), torch.autograd.grad(
            loss, list(model.parameters()))))
    (got, g_got), (want, g_want) = runs
    assert got == want
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
