#!/usr/bin/env python3
"""Device time of each pass of the ragged ``segment_gather_sum`` call.

    python3 tools/gather_profile.py --src SRC --label NAME \
        [--out chiprun_out/gather_profile.jsonl]

Loads the ``repro_torch`` package of ``SRC`` (this checkout's ``src``, or a
parent commit's unpacked beside it), builds its kernels, and runs
``ops.segment_gather_sum`` at the ``ogb_products`` shape of
``chip_smoke.py`` (``OGB``, inputs from ``gather_inputs``, seed 0) under
``torch.profiler``: one warm call after two unprofiled ones.  It prints
each CUDA kernel, copy and fill of that call in launch order with its
device time, their sum, the call's wall time (host clock to a device sync)
and the device's busy share of it.  One JSON line per run is appended to
``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, required=True,
                    help="the src directory whose repro_torch is profiled")
    ap.add_argument("--label", required=True, help="name of this tree")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "gather_profile.jsonl")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("gather_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import OGB, gather_inputs
    from repro_torch.kernels import _build, ops

    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    feat, src, dst, ew = gather_inputs(torch)["ragged"]

    def call():
        return ops.segment_gather_sum(feat, src, dst, OGB["nodes"], ew)

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    passes = [{"name": e.name[:160],
               "us": e.time_range.end - e.time_range.start} for e in dev]
    busy = sum(p["us"] for p in passes)
    rec = {"label": args.label, "src": str(args.src), "card": card,
           "shape": OGB, "passes": passes, "device_us": busy,
           "wall_us": wall_us,
           "busy_share": busy / wall_us if wall_us else None}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"{args.label} on {card}: {len(passes)} device passes, "
          f"{busy:.1f} us of device time in {wall_us:.1f} us")
    for p in passes:
        print(f"  {p['us']:10.1f} us  {p['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
