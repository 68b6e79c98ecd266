"""The port's training substrate against the reference: LR schedules,
AdamW with clipping and int8 compression, the data streams batch for
batch, the straggler tracker, the checkpointer (round trip, keep-k,
atomicity, async writer, shape mismatch), the fault-tolerant loop and the
``launch.train`` CLI on the CPU.

Inputs come from numpy seeds; the reference's functions run eagerly on
the CPU on the same numbers.  Tolerances are stated where used.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro.train import straggler as ref_straggler
from repro_torch.launch import train as launch_train
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.data import (RecsysStream, SampledGraphStream,
                                    TokenStream)
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optimizer import (AdamWState, OptConfig, adamw_init,
                                         adamw_update, compress_int8, lr_at)
from repro_torch.train.straggler import ChunkRebalancer, StepTimeTracker
from repro_torch.train.trainstep import make_eval_step, make_train_step

# float32 element-wise arithmetic in the same order on both sides, but
# XLA may fuse a multiply and an add: a few ulps
ULPS = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one torch thread keeps the suite's
    parallel workers from oversubscribing the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- optimizer

@pytest.mark.parametrize("schedule", ["const", "linear", "cosine"])
def test_lr_at_matches_reference_over_100_steps(schedule):
    kw = dict(lr=0.3, warmup_steps=10, total_steps=80, schedule=schedule)
    steps = np.arange(100, dtype=np.int32)
    want = np.asarray(ref_opt.lr_at(ref_opt.OptConfig(**kw),
                                    jnp.asarray(steps)))
    got = lr_at(OptConfig(**kw), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **ULPS)
    assert got[0] < got[9] <= 0.3  # warmup


def _tree(rng, scale=1.0):
    return {"w": (rng.normal(size=(5, 4)) * scale).astype(np.float32),
            "b": (rng.normal(size=4) * scale).astype(np.float32),
            "t": (rng.normal(size=(7, 3)) * scale).astype(np.float32)}


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_reference(compress):
    """Five steps with weight decay, a cosine schedule past its warmup and
    gradients large enough that the global-norm clip scales them (then
    small ones that it leaves), with and without int8 compression."""
    rng = np.random.default_rng(5)
    kw = dict(lr=0.05, warmup_steps=2, total_steps=8, weight_decay=0.1,
              clip_norm=1.0, grad_compress=compress)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = ref_opt.adamw_init(jp, ref_opt.OptConfig(**kw))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = adamw_init(tp, OptConfig(**kw))
    for i in range(5):
        g = _tree(rng, scale=10.0 if i < 3 else 0.01)
        jp, jstate, jgn = ref_opt.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate,
            ref_opt.OptConfig(**kw))
        tp2, state, gn = adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, state,
            OptConfig(**kw))
        assert tp2 is tp  # in place
        # the norm: a sum of squares in another order
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        assert int(state.step) == int(jstate.step) == i + 1
        for k in p0:
            # parameters and moments: the same float32 terms; a rounding
            # difference in g shifts m / sqrt(v) by a few ulps
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(state.mu[k].numpy(),
                                       np.asarray(jstate.mu[k]), rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(state.nu[k].numpy(),
                                       np.asarray(jstate.nu[k]), rtol=1e-5,
                                       atol=1e-9)
            if compress:
                np.testing.assert_allclose(state.err[k].numpy(),
                                           np.asarray(jstate.err[k]),
                                           rtol=1e-5, atol=1e-6)


def test_grad_clipping():
    params = {"w": torch.ones(4)}
    cfg = OptConfig(lr=1e-9, clip_norm=1.0, weight_decay=0.0)
    state = adamw_init(params, cfg)
    _, _, gn = adamw_update(params, {"w": torch.full((4,), 100.0)}, state,
                            cfg)
    assert float(gn) == pytest.approx(200.0)
    # the data-parallel mean over a group of one rank changes nothing
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        p1 = {"w": torch.ones(4)}
        p2 = {"w": torch.ones(4)}
        g = {"w": torch.tensor([3.0, -1.0, 0.5, 2.0])}
        adamw_update(p1, g, adamw_init(p1, cfg), cfg)
        _, _, gn2 = adamw_update(p2, g, adamw_init(p2, cfg), cfg,
                                 group=dist.group.WORLD)
        torch.testing.assert_close(p2["w"], p1["w"], rtol=0, atol=0)
        assert float(gn2) == pytest.approx(float(torch.linalg.norm(g["w"])))
    finally:
        dist.destroy_process_group()


def test_compress_int8_matches_reference_and_rounds_half_even():
    rng = np.random.default_rng(0)
    g = rng.normal(size=512).astype(np.float32)
    err = (rng.normal(size=512) * 0.01).astype(np.float32)
    deq, res = compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    jdeq, jres = ref_opt.compress_int8(jnp.asarray(g), jnp.asarray(err))
    # one add, one max, one divide, one round on the same float32 values
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    # scale 1: halves round to the even neighbour, as jnp.round's
    t = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    deq, _ = compress_int8(torch.from_numpy(t), torch.zeros(6))
    np.testing.assert_array_equal(deq.numpy(), [0, 2, 2, 0, -2, 127])
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(ref_opt.compress_int8(jnp.asarray(t),
                                                      jnp.zeros(6))[0]))


def test_int8_error_feedback_bounds_drift():
    rng = np.random.default_rng(0)
    err = torch.zeros(512)
    total_true = torch.zeros(512)
    total_deq = torch.zeros(512)
    for _ in range(50):
        gi = torch.from_numpy(rng.normal(size=512).astype(np.float32))
        total_true += gi
        deq, err = compress_int8(gi, err)
        total_deq += deq
    # the residual is carried, so the drift stays bounded by one quantum
    drift = float(torch.max(torch.abs(total_true - total_deq)))
    assert drift <= float(torch.max(torch.abs(err))) + 1e-5


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.0]), "b": torch.tensor(4.0)}
    cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                    total_steps=500, schedule="const")
    state = adamw_init(params, cfg)

    def loss(p, _batch):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    for p in params.values():
        p.requires_grad_()
    step = make_train_step(loss, params, cfg)
    for _ in range(300):
        _, state, m = step(params, state, {})
    assert float(loss(params, {}).detach()) < 1e-3
    assert float(make_eval_step(loss, params)(params, {})) < 1e-3


def test_microbatch_accumulation_equivalence():
    rng = np.random.default_rng(1)
    batch = {"x": rng.normal(size=(8, 4)).astype(np.float32),
             "y": rng.normal(size=(8,)).astype(np.float32)}

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    cfg = OptConfig(lr=0.1, weight_decay=0.0, schedule="const",
                    warmup_steps=1)
    outs = []
    for m in (1, 4):
        p = {"w": torch.ones(4, requires_grad=True)}
        step = make_train_step(loss, p, cfg, microbatches=m)
        _, _, metrics = step(p, adamw_init(p, cfg), batch)
        outs.append((p["w"].detach().numpy(), float(metrics["loss"])))
        with pytest.raises(ValueError):  # a step trains its own model
            step({"w": torch.ones(4, requires_grad=True)}, None, batch)
    # microbatched grads are means of means over equal splits = same here
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------------- data

def test_streams_match_reference_batch_for_batch():
    pairs = [
        (TokenStream(vocab=128, batch=4, seq=16, seed=7),
         ref_data.TokenStream(vocab=128, batch=4, seq=16, seed=7)),
        (RecsysStream(n_dense=4, n_sparse=3, hotness=2,
                      vocab_sizes=(50, 20, 10), batch=8, seed=1),
         ref_data.RecsysStream(n_dense=4, n_sparse=3, hotness=2,
                               vocab_sizes=(50, 20, 10), batch=8, seed=1)),
        (SampledGraphStream(n_nodes=500, avg_degree=5, d_feat=8, n_classes=3,
                            batch_nodes=16, fanout=[4, 3], seed=2),
         ref_data.SampledGraphStream(n_nodes=500, avg_degree=5, d_feat=8,
                                     n_classes=3, batch_nodes=16,
                                     fanout=[4, 3], seed=2)),
    ]
    for ours, theirs in pairs:
        for step in (0, 3, 42):
            got, want = ours.batch_at(step), theirs.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    tok = pairs[0][0].batch_at(42)
    np.testing.assert_array_equal(tok["tokens"][:, 1:], tok["labels"][:, :-1])


# -------------------------------------------------------------- straggler

def test_straggler_tracker_and_rebalancer_match_reference():
    rng = np.random.default_rng(4)
    times = rng.uniform(0.08, 0.12, 60)
    times[[20, 41]] = [0.5, 0.9]
    ours, theirs = StepTimeTracker(factor=2.0), \
        ref_straggler.StepTimeTracker(factor=2.0)
    for i, t in enumerate(times):
        assert ours.record(i, float(t)) == theirs.record(i, float(t))
    assert ours.flagged == theirs.flagged and ours.flagged[0][0] == 20
    assert ours.median == theirs.median
    rb, rrb = ChunkRebalancer(n_shards=4), \
        ref_straggler.ChunkRebalancer(n_shards=4)
    for c in range(16):
        rb.observe(c, 1.0 + 10.0 * (c == 0))
        rrb.observe(c, 1.0 + 10.0 * (c == 0))
    assert rb.assign(list(range(20))) == rrb.assign(list(range(20)))


# ------------------------------------------------------------ checkpoints

def _opt_tree():
    return AdamWState(step=torch.tensor(7, dtype=torch.int32),
                      mu={"a": torch.ones(2, 3)}, nu={"a": torch.zeros(2, 3)},
                      err=None)


def test_checkpoint_roundtrip_and_keep(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nested": {"b": torch.ones(4, dtype=torch.bfloat16)},
              "list": [torch.full((2,), 3, dtype=torch.int64)]}
    for s in (10, 20, 30):
        ck.save(s, {"params": {"a": params["a"] * s,
                               "nested": params["nested"],
                               "list": params["list"]},
                    "opt": _opt_tree()}, extra={"why": s})
    assert ck.all_steps() == [20, 30]  # keep=2 pruned step 10
    step, trees, extra = ck.restore({"params": params, "opt": _opt_tree()})
    assert step == 30 and extra == {"why": 30}
    torch.testing.assert_close(trees["params"]["a"], params["a"] * 30)
    assert trees["params"]["nested"]["b"].dtype == torch.bfloat16
    assert trees["params"]["list"][0].tolist() == [3, 3]
    opt = trees["opt"]
    assert isinstance(opt, AdamWState) and opt.err is None
    assert int(opt.step) == 7 and opt.step.dtype == torch.int32
    meta = json.loads((tmp_path / "step_000000000030" / "meta.json")
                      .read_text())
    assert meta["step"] == 30 and meta["names"] == ["opt", "params"]


def test_checkpoint_atomic_no_partial(tmp_path):
    ck = Checkpointer(tmp_path, keep=5)
    ck.save(1, {"params": {"w": torch.ones(3)}})
    # a stale staging dir must not be visible as a checkpoint
    (tmp_path / "step_000000000099.tmp.abc").mkdir()
    assert ck.all_steps() == [1]
    # a failed write leaves neither a checkpoint nor its staging dir
    with pytest.raises(Exception):
        ck.save(2, {"params": {"w": object()}})
    assert ck.all_steps() == [1]


def test_checkpoint_async_snapshots_at_save(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    w = torch.ones(1000)
    ck.save(5, {"params": {"w": w}}, blocking=False)
    w.mul_(3)  # the step goes on updating in place while the writer runs
    ck.wait()
    assert ck.all_steps() == [5]
    _, trees, _ = ck.restore({"params": {"w": w}})
    assert float(trees["params"]["w"].max()) == 1.0


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"params": {"w": torch.ones(3)}})
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"params": {"w": torch.ones(4)}})


# ------------------------------------------------------------------- loop

def _toy_setup(tmp_path, total=30, fail_at=None):
    cfg = OptConfig(lr=0.05, weight_decay=0.0, schedule="const",
                    warmup_steps=1)
    params = {"w": torch.zeros(4, requires_grad=True)}
    opt = adamw_init(params, cfg)
    calls = {"n": 0}

    def loss(p, batch):
        return torch.mean((p["w"] - batch["target"]) ** 2)

    raw = make_train_step(loss, params, cfg)

    def step_fn(p, s, b):
        calls["n"] += 1
        if fail_at is not None and calls["n"] == fail_at:
            raise RuntimeError("injected transient failure")
        return raw(p, s, b)

    class Stream:
        def batch_at(self, step):
            return {"target": np.full(4, 3.0, np.float32)}

    loop_cfg = LoopConfig(total_steps=total, ckpt_every=10,
                          ckpt_dir=str(tmp_path), log_every=10)
    return Trainer(step_fn, Stream(), loop_cfg, params, opt), calls


def test_loop_runs_and_checkpoints(tmp_path):
    trainer, _ = _toy_setup(tmp_path)
    end = trainer.fit()
    assert end == 30
    assert trainer.ckpt.all_steps()[-1] == 30
    assert float(trainer.params["w"].detach().mean()) > 1.0  # moved toward 3
    assert [r["step"] for r in trainer.metrics_log] == [10, 20, 30]


def test_loop_restores_signal_handlers_after_fit(tmp_path):
    """The preemption handlers hold the trainer: once ``fit`` returns,
    the process's earlier handlers are back, and nothing keeps the
    finished trainer (and its tensors) alive."""
    import gc
    import signal
    import weakref

    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    trainer, _ = _toy_setup(tmp_path, total=3)
    assert trainer.fit() == 3
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before
    ref = weakref.ref(trainer)
    del trainer
    gc.collect()
    assert ref() is None


def test_loop_retries_from_checkpoint(tmp_path):
    trainer, calls = _toy_setup(tmp_path, total=25, fail_at=17)
    end = trainer.fit()
    assert end == 25
    # one failure -> restored from step 10 and replayed
    assert calls["n"] > 25
    # the replay is exact: the same weights as a run without the failure
    clean, _ = _toy_setup(tmp_path / "clean", total=25)
    clean.fit()
    torch.testing.assert_close(trainer.params["w"], clean.params["w"])


def test_loop_resumes_after_restart(tmp_path):
    trainer, _ = _toy_setup(tmp_path, total=20)
    trainer.fit()
    # new trainer instance (fresh params) resumes from the checkpoint
    trainer2, _ = _toy_setup(tmp_path, total=40)
    w_before = trainer2.params["w"]
    end = trainer2.fit()
    assert end == 40
    assert trainer2.ckpt.latest_step() == 40
    assert trainer2.params["w"] is w_before  # restored in place


# ------------------------------------------------------------- launch CLI

@pytest.mark.parametrize("arch", ["dlrm-rm2", "gcn-cora"])
def test_launch_train_cpu_then_resume(arch, tmp_path, capsys):
    base = ["--arch", arch, "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--batch", "16"]
    first = launch_train.main(base + ["--steps", "4"])
    assert "final step=4 loss=" in capsys.readouterr().out
    loss = first.metrics_log[-1]["loss"]
    assert np.isfinite(loss)
    assert first.ckpt.all_steps() == [2, 4]
    resumed = launch_train.main(base + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "final step=6 loss=" in out
    assert resumed.ckpt.all_steps() == [2, 4, 6]  # keep=3
    # the second run started from the first one's step-4 checkpoint
    assert int(resumed.opt_state.step) == 6


def test_launch_train_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "gcn-cora", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
    assert not (tmp_path / "gcn-cora").exists()
