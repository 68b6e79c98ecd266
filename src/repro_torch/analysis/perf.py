"""Perf-iteration harness: trace a (arch × cell × profile) variant on the
single-pod mesh (at two small depths for an LM, differenced and
extrapolated to its full depth, as the dry run does) and report its
three-term roofline — one hypothesis → measure cycle per invocation.

  PYTHONPATH=src python -m repro_torch.analysis.perf --arch qwen3-8b \\
      --cell train_4k --profile act_replicated --device cpu

Results append to ``runs/perf/log.json``.  The trace is the dry run's
(``launch.dryrun``: a fake process group of 256 ranks and fake tensors,
on ``--device``), so run it in a process of its own.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.analysis.model_flops import model_flops
from repro_torch.analysis.roofline import (CHIPS_SINGLE, PEAK_FLOPS,
                                           _cost_tuple, roofline_terms)
from repro_torch.configs import get_arch


def measure(arch_name: str, cell: str, profile: str = "baseline",
            device: str = "cuda", depth: int | None = None) -> dict:
    """The variant's per-rank cost over every layer (an LM's ``depth``
    layers, by default its config's: ``launch.dryrun.trace_cell``'s two
    traces, extrapolated) and its roofline terms (and, outside the engine,
    MODEL_FLOPS and the two ratios)."""
    from repro_torch.launch.dryrun import production_mesh, trace_cell

    arch = get_arch(arch_name)
    mesh = production_mesh(False, device)
    t0 = time.time()
    total = _cost_tuple(trace_cell(arch_name, cell, mesh, profile=profile,
                                   device=device, depth=depth))
    terms = roofline_terms(total)
    rec = {"arch": arch_name, "cell": cell, "profile": profile, **terms,
           "flops_per_chip": total["flops"], "bytes_per_chip": total["bytes"],
           "coll_per_chip": total["coll"], "trace_s": time.time() - t0,
           "ts": time.time()}
    if arch.family != "engine":
        mf = model_flops(arch_name, cell)
        step_s = max(terms["compute_s"], terms["memory_s"],
                     terms["collective_s"])
        rec["model_flops"] = mf
        rec["useful_ratio"] = mf / max(total["flops"] * CHIPS_SINGLE, 1.0)
        rec["roofline_frac"] = (mf / CHIPS_SINGLE / PEAK_FLOPS) / step_s \
            if step_s else 0.0
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--profile", default="baseline")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the fake tensors lie on")
    ap.add_argument("--out", default="runs/perf/log.json")
    args = ap.parse_args(argv)
    rec = measure(args.arch, args.cell, args.profile, args.device)
    print(json.dumps(rec, indent=1))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    log = json.loads(out.read_text()) if out.exists() else []
    log.append(rec)
    out.write_text(json.dumps(log, indent=1))


if __name__ == "__main__":
    main()
