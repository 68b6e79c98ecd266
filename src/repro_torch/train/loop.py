"""Fault-tolerant training loop.

- checkpoint every ``ckpt_every`` steps (async, atomic, keep-k);
- SIGTERM/SIGINT → flush a final checkpoint before exiting (preemption
  handling, the behavior a borg/k8s eviction needs);
- step-level retry: a transient step failure (device OOM, io hiccup)
  restores the last checkpoint and replays — data streams are stateless in
  ``step`` so replay is exact;
- straggler tracking feeds metrics.

``params`` is the model the step trains (an ``nn.Module``, or a dict of
tensors), updated in place by the step; a restore copies the checkpoint
into it in place, so the step keeps training the same object.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.straggler import StepTimeTracker
from repro_torch.utils import get_logger

log = get_logger("train.loop")


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 100
    ckpt_dir: str = "runs/ckpt"
    keep: int = 3
    max_retries: int = 3
    log_every: int = 10


def _wait(t: torch.Tensor) -> None:
    """Wait until the device has computed ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclass
class Trainer:
    step_fn: Callable  # (params, opt_state, batch) -> (params, opt, metrics)
    stream: Any  # .batch_at(step) -> batch
    cfg: LoopConfig
    params: Any
    opt_state: Any
    metrics_log: list = field(default_factory=list)

    def __post_init__(self):
        self.ckpt = Checkpointer(self.cfg.ckpt_dir, keep=self.cfg.keep)
        self.tracker = StepTimeTracker()
        self._preempted = False

    # -- preemption ---------------------------------------------------------
    def _install_handlers(self):
        def handler(signum, frame):
            log.warning("signal %s: will checkpoint and stop", signum)
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass  # not main thread (tests)

    # -- main ---------------------------------------------------------------
    def fit(self, start_step: int | None = None) -> int:
        self._install_handlers()
        step = self._maybe_restore() if start_step is None else start_step
        retries = 0
        while step < self.cfg.total_steps and not self._preempted:
            batch = self.stream.batch_at(step)
            t0 = time.perf_counter()
            try:
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                _wait(metrics["loss"])
            except Exception as e:  # transient failure path
                retries += 1
                log.error("step %d failed (%s); retry %d/%d from last "
                          "checkpoint", step, e, retries,
                          self.cfg.max_retries)
                if retries > self.cfg.max_retries:
                    self._flush(step)
                    raise
                step = self._maybe_restore()
                continue
            retries = 0
            dt = time.perf_counter() - t0
            self.tracker.record(step, dt)
            step += 1
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                rec = {"step": step, "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "sec_per_step": dt}
                self.metrics_log.append(rec)
                log.info("step %(step)d loss=%(loss).4f "
                         "gnorm=%(grad_norm).3f %(sec_per_step).3fs", rec)
            if step % self.cfg.ckpt_every == 0:
                self._flush(step, blocking=False)
        self._flush(step)
        return step

    # -- checkpoint plumbing --------------------------------------------------
    def _state(self) -> dict:
        if isinstance(self.params, nn.Module):
            return self.params.state_dict()
        return self.params

    def _flush(self, step: int, blocking: bool = True) -> None:
        self.ckpt.save(step, {"params": self._state(), "opt": self.opt_state},
                       extra={"metrics": self.metrics_log[-5:]},
                       blocking=blocking)

    def _maybe_restore(self) -> int:
        got = self.ckpt.restore({"params": self._state(),
                                 "opt": self.opt_state})
        if got is None:
            return 0
        step, trees, _ = got
        if isinstance(self.params, nn.Module):
            self.params.load_state_dict(trees["params"])
        else:
            with torch.no_grad():
                for k, t in self.params.items():
                    t.copy_(trees["params"][k])
        self.opt_state = trees["opt"]
        log.info("restored checkpoint at step %d", step)
        return step
