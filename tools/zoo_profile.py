#!/usr/bin/env python3
"""Whether ``torch.profiler`` sees every ``segment_gather`` launch of a
DLRM RM-2 step, in a fresh process.

    python3 tools/zoo_profile.py

Runs on one CUDA card.  For RM-2 with each table capped at 100,000 rows
and at its full 19,107,700 rows (batch 65,536 of ``RecsysStream``, seed
0, already on the card), it profiles: the 26 bag launches alone (twice),
a no-grad forward, a train step (twice), a step with only CUDA activity,
a step with a device sync after each bag launch, and two steps under a
schedule (warm-up 1, active 1) with ``acc_events``; and prints, for
each, the launch counter's count beside the device events the profiler
returned, in all and of ``segment_gather`` (``prof.events()`` and the
raw Kineto events).  ``chip_smoke.py`` phase 9 profiles the same step
late in a long process, where it sees fewer.  The report goes to
``chiprun_out/zoo_profile.json``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.train import model_for
    from repro_torch.train.data import RecsysStream
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainstep import (batch_to, make_train_step,
                                             named_params)

    if not torch.cuda.is_available():
        print("zoo_profile: CUDA is not available", file=sys.stderr)
        return 2
    cuda = torch.autograd.DeviceType.CUDA
    _build.build_all()
    report = {}

    def seen(prof, launched):
        dev = [e for e in prof.events() if e.device_type == cuda]
        raw = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda] if prof.profiler else []
        return {"launched": launched, "device_events": len(dev),
                "segment_gather": sum("segment_gather" in e.name
                                      for e in dev),
                "raw_device_events": len(raw),
                "raw_segment_gather": sum("segment_gather" in e.name()
                                          for e in raw)}

    def run(label, fn, acts=(ProfilerActivity.CPU, ProfilerActivity.CUDA)):
        torch.cuda.synchronize()
        n0 = ops.launches["segment_gather"]
        with profile(activities=list(acts)) as prof:
            fn()
            torch.cuda.synchronize()
        report[label] = seen(prof, ops.launches["segment_gather"] - n0)
        print(label, report[label], flush=True)

    arch = get_arch("dlrm-rm2")
    for cap in (100_000, None):
        cfg = arch.config if cap is None else dataclasses.replace(
            arch.config, vocab_sizes=tuple(min(v, cap) for v in
                                           arch.config.vocab_sizes))
        tag = "full" if cap is None else "capped"
        model = model_for(arch, cfg, "cuda",
                          torch.Generator(device="cuda").manual_seed(1))
        batch = batch_to(RecsysStream(
            cfg.n_dense, cfg.n_sparse, cfg.hotness, cfg.vocab_sizes,
            batch=65_536, seed=0).batch_at(0), "cuda")
        opt_cfg = OptConfig(lr=3e-3, warmup_steps=10, total_steps=3)
        state = adamw_init(named_params(model), opt_cfg)
        step = make_train_step(arch.loss_fn, model, opt_cfg)
        by_field = batch["sparse"].permute(1, 0, 2).contiguous()

        def bags():
            for t, table in enumerate(model.tables):
                ops.segment_gather_fixed(table.detach(), by_field[t])

        def one_step():
            step(model, state, batch)

        def forward():
            with torch.no_grad():
                model(batch)

        one_step()  # warm
        run(f"{tag}_bags_1", bags)
        run(f"{tag}_bags_2", bags)
        run(f"{tag}_forward", forward)
        run(f"{tag}_step_1", one_step)
        run(f"{tag}_step_2", one_step)
        run(f"{tag}_step_cuda_only", one_step, acts=(ProfilerActivity.CUDA,))
        orig = ops.segment_gather_fixed

        def synced(*args):
            out = orig(*args)
            torch.cuda.synchronize()
            return out

        ops.segment_gather_fixed = synced
        try:
            run(f"{tag}_step_synced", one_step)
        finally:
            ops.segment_gather_fixed = orig
        n0 = ops.launches["segment_gather"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            for _ in range(2):
                one_step()
                torch.cuda.synchronize()
                prof.step()
        report[f"{tag}_scheduled"] = seen(
            prof, ops.launches["segment_gather"] - n0)
        print(f"{tag}_scheduled", report[f"{tag}_scheduled"], flush=True)
        del model, state, step, batch, by_field
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "zoo_profile.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
