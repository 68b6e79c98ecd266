#!/usr/bin/env python3
"""Time saved main-path kernel calls against the kernels of one source tree.

    python3 chip_smoke.py --save-calls build/ab_calls.pt
    python3 tools/kernel_ab.py --src SRC --label NAME build/ab_calls.pt \
        [--out chiprun_out/kernel_ab.jsonl]

``chip_smoke.py --save-calls`` keeps the largest and the smallest call that
the main path gave ``expand_filter_compact`` and ``signature_filter``.
This script loads the ``repro_torch`` package of ``SRC`` (this checkout's
``src``, or a parent commit's unpacked beside it), builds its kernels,
holds each saved call bit-equal against that tree's plain version and
times the kernel and the plain version as ``chip_smoke.py`` phase 6 does
(median of 20 runs, CUDA events, L2 flushed and the host given a head
start before each).  It also times the kernel with its inputs left in L2
(``warm_ms``) and without the head start (``events_ms``, the method of
``chip_smoke.py`` before the head start, which counts the wrapper's host
time wherever it exceeds the flush), the wrapper's host time per call
(``host_ms``), and first one launch that does almost nothing
(``launch_floor_ms``).  Run it for both trees on one card, in turns
(parent, change, change, parent), to compare two commits' kernels on the
same inputs.  One JSON line per call is appended to
``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("calls", type=Path, help="file saved by chip_smoke.py "
                                             "--save-calls")
    ap.add_argument("--src", type=Path, required=True,
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", required=True, help="name of this tree")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "kernel_ab.jsonl")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import host_ms, launch_floor_ms, max_abs_err, time_ms
    from repro_torch.kernels import _build, ops, ref

    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    calls = torch.load(args.calls, map_location="cuda")
    plains = {"expand_filter_compact": ref.expand_filter_compact_ref,
              "signature_filter": ref.signature_filter_ref}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        floor = {"label": args.label, "card": card,
                 "launch_floor_ms": launch_floor_ms(torch)}
        f.write(json.dumps(floor) + "\n")
        print(json.dumps(floor), flush=True)
        for name, by_size in calls.items():
            kern, plain = getattr(ops, name), plains[name]
            for size, cargs in by_size.items():
                err = max_abs_err(torch, kern(*cargs), plain(*cargs))
                if err != 0:
                    raise SystemExit(f"kernel_ab: {args.label} {name} "
                                     f"{size}: kernel differs from its plain "
                                     f"version")
                rec = {"label": args.label, "src": str(args.src),
                       "card": card, "name": name, "call": size,
                       "shapes": [list(a.shape) for a in cargs
                                  if isinstance(a, torch.Tensor)],
                       "ms": time_ms(torch, lambda: kern(*cargs)),
                       "warm_ms": time_ms(torch, lambda: kern(*cargs),
                                          flush_l2=False),
                       "events_ms": time_ms(torch, lambda: kern(*cargs),
                                            head_start=False),
                       "host_ms": host_ms(torch, lambda: kern(*cargs)),
                       "plain_ms": time_ms(torch, lambda: plain(*cargs))}
                f.write(json.dumps(rec) + "\n")
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
