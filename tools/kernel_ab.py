#!/usr/bin/env python3
"""Time saved main-path kernel calls against the kernels of one source tree.

    python3 chip_smoke.py --save-calls build/ab_calls.pt
    python3 tools/kernel_ab.py --src SRC --label NAME build/ab_calls.pt \
        [--queries SCALE] [--out chiprun_out/kernel_ab.jsonl]

``chip_smoke.py --save-calls`` keeps the largest and the smallest call that
the main path gave each kernel of its ``SMALLEST``.  This script loads the
``repro_torch`` package of ``SRC`` (this checkout's ``src``, or a parent
commit's unpacked beside it), builds its kernels, and times each saved call
as ``chip_smoke.py`` phase 6 does (median of 20 runs, CUDA events, L2
flushed and the host given a head start before each):

* the kernel in the TPU contract's form, held bit-equal against that
  tree's plain version (``ms``), with its inputs left in L2
  (``warm_ms``), without the head start (``events_ms``), the wrapper's
  host time per call (``host_ms``) and the plain version (``plain_ms``).
  A call that used ``ids=`` (``bitmap_superset``) or ``row=``
  (``delta_merge``) is timed in this form on its inputs gathered
  beforehand;
* for those kernels and ``tile_membership`` (whose range form, ``iptr=``,
  builds the +INT check's adjacency tile itself), the step segment the
  main path runs (``segment_ms``, ``segment_host_ms``): in a tree whose
  wrapper takes ``ids`` / ``row`` / ``iptr``, the one call; in a tree whose
  wrapper does not, the gathers or the tile build the engine made before
  the call and then the call, as that tree's engine ran them
  (``segment_form``).

It first times one launch that does almost nothing (``launch_floor_ms``),
and last ``segment_gather`` at ``chip_smoke.py``'s users' shapes (inputs
from ``gather_inputs``, seed 0): the fixed call at ``RM2`` (``ms``), and
the ragged ``segment_gather_sum`` call at ``OGB`` through its wrapper
(``ms``) and as that tree's kernel alone on the sorted keys
(``kernel_ms``); each with a SHA-256 digest of the output's bytes
(``digest``), so two trees' outputs can be compared bit for bit.
``--queries SCALE`` also counts, with ``torch.profiler``, the CUDA kernels
of one warm Q2 and Q9 of that tree's engine on LUBM at SCALE universities,
static and on a live snapshot (``chip_smoke.py``'s base split, every insert
and delete applied), with the device's busy share of each query's window
and the median of 11 warm runs.
Run it for both trees on one card, in turns (parent, change, change,
parent), to compare two commits on the same inputs.  One JSON line per
timed call is appended to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# warm runs of each profiled query (host clock to a device sync); their
# median is warm_ms
WARM_RUNS = 11


def query_profiles(torch, scale: int) -> dict:
    """Warm Q2 and Q9 on a static LUBM engine and on a live snapshot of the
    same triples: ``WARM_RUNS`` warm runs each (``warm_runs_ms``, host
    clock to a device sync; their median ``warm_ms``), then one profiled
    run each."""
    from chip_smoke import _decode, _sub_store, live_split, profile_queries
    from repro_torch.core import SparqlEngine
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.workloads import LUBM_QUERIES
    from repro_torch.store import VersionedStore

    def warm(eng):
        runs = {}
        for name in ("Q2", "Q9"):
            eng.query(LUBM_QUERIES[name])
            runs[name] = []
            for _ in range(WARM_RUNS):
                t0 = time.perf_counter()
                eng.query(LUBM_QUERIES[name])
                torch.cuda.synchronize()
                runs[name].append((time.perf_counter() - t0) * 1e3)
        prof = profile_queries(torch, eng)
        for name, p in prof.items():
            p["warm_ms"] = sorted(runs[name])[WARM_RUNS // 2]
            p["warm_runs_ms"] = runs[name]
        return prof

    st = generate_lubm(scale=scale, seed=0, density=1.0).finalize()
    g, maps = type_aware_transform(st)
    out = {"static": warm(SparqlEngine(g, maps))}
    base_rows, ins_rows, del_rows = live_split(st)
    g, maps = type_aware_transform(_sub_store(st, base_rows))
    store = VersionedStore(g, maps)
    store.insert_triples(_decode(st, ins_rows))
    store.delete_triples(_decode(st, del_rows))
    out["live"] = warm(SparqlEngine(store.snapshot(), maps))
    return out


def digest(torch, out) -> str:
    torch.cuda.synchronize()
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


def gather_calls(torch, ops) -> dict:
    """``segment_gather`` at its users' shapes: the fixed call at ``RM2``
    (device time, digest) and the ragged call at ``OGB`` (wrapper and
    kernel device times, digest).  A tree whose wrapper gathers the sorted
    ids and weights before its kernel (``_gather_launch``) has them
    gathered for its kernel alone; a tree whose kernel reads the
    permutation (``_gather_sum_launch``) is given it."""
    from chip_smoke import OGB, RM2, gather_inputs, time_ms

    inputs = gather_inputs(torch)
    table, idx, w = inputs.pop("fixed")
    fixed = {"shape": RM2,
             "digest": digest(torch, ops.segment_gather_fixed(table, idx, w)),
             "ms": time_ms(torch, lambda: ops.segment_gather_fixed(table, idx,
                                                                   w))}
    del table, idx, w
    feat, src, dst, ew = inputs.pop("ragged")
    n = OGB["nodes"]
    out_digest = digest(torch, ops.segment_gather_sum(feat, src, dst, n, ew))
    seg, order = torch.sort(dst, stable=True)
    offsets = torch.searchsorted(
        seg, torch.arange(n + 1, dtype=torch.int32, device="cuda"),
        out_int32=True)
    del seg
    if hasattr(ops, "_gather_sum_launch"):
        def kernel():
            return ops._gather_sum_launch(feat, src, ew, order, offsets, n)
    else:
        idx_s, w_s = src[order].contiguous(), ew[order].contiguous()

        def kernel():
            return ops._gather_launch(feat, idx_s, w_s, offsets, 0, n)
    ragged = {"shape": OGB, "digest": out_digest,
              "ms": time_ms(torch, lambda: ops.segment_gather_sum(
                  feat, src, dst, n, ew)),
              "kernel_ms": time_ms(torch, kernel)}
    return {"fixed": fixed, "ragged": ragged}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("calls", type=Path, help="file saved by chip_smoke.py "
                                             "--save-calls")
    ap.add_argument("--src", type=Path, required=True,
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", required=True, help="name of this tree")
    ap.add_argument("--queries", type=int, default=0, metavar="SCALE",
                    help="also count the CUDA kernels of warm Q2 and Q9 on "
                         "LUBM at SCALE universities, static and live")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "kernel_ab.jsonl")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import (FUSED_GATHERS, contract_call, contract_out,
                            host_ms, launch_floor_ms, max_abs_err, time_ms,
                            unfused_segment)
    from repro_torch.kernels import _build, ops, ref

    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    calls = torch.load(args.calls, map_location="cuda")
    args.out.parent.mkdir(parents=True, exist_ok=True)

    def emit(f, rec: dict) -> None:
        f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)

    with args.out.open("a") as f:
        emit(f, {"label": args.label, "card": card,
                 "launch_floor_ms": launch_floor_ms(torch)})
        for name, by_size in calls.items():
            kern = getattr(ops, name)
            plain = getattr(ref, f"{name}_ref")
            fused = FUSED_GATHERS.get(name) in inspect.signature(
                kern).parameters
            for size, (cargs, ckw) in by_size.items():
                targs, tkw = contract_call(torch, name, cargs, ckw)
                err = max_abs_err(torch, kern(*targs, **tkw),
                                  plain(*targs, **tkw))
                if err != 0:
                    raise SystemExit(f"kernel_ab: {args.label} {name} "
                                     f"{size}: kernel differs from its plain "
                                     f"version")
                rec = {"label": args.label, "src": str(args.src),
                       "card": card, "name": name, "call": size,
                       "shapes": [list(a.shape) for a in targs
                                  if isinstance(a, torch.Tensor)],
                       "ms": time_ms(torch, lambda: kern(*targs, **tkw)),
                       "warm_ms": time_ms(torch, lambda: kern(*targs, **tkw),
                                          flush_l2=False),
                       "events_ms": time_ms(torch,
                                            lambda: kern(*targs, **tkw),
                                            head_start=False),
                       "host_ms": host_ms(torch, lambda: kern(*targs, **tkw)),
                       "plain_ms": time_ms(torch,
                                           lambda: plain(*targs, **tkw))}
                if ckw.get(FUSED_GATHERS.get(name)) is not None:
                    seg = ((lambda: kern(*cargs, **ckw)) if fused else
                           unfused_segment(torch, kern, name, cargs, ckw))
                    if max_abs_err(torch, seg(), contract_out(
                            name, kern(*targs, **tkw))) != 0:
                        raise SystemExit(f"kernel_ab: {args.label} {name} "
                                         f"{size}: the step segment differs "
                                         f"from the contract form")
                    rec["segment_form"] = ("one call" if fused
                                           else "gathers + kernel")
                    rec["segment_ms"] = time_ms(torch, seg)
                    rec["segment_host_ms"] = host_ms(torch, seg)
                emit(f, rec)
        for call, rec in gather_calls(torch, ops).items():
            emit(f, {"label": args.label, "src": str(args.src), "card": card,
                     "name": "segment_gather", "call": call, **rec})
        if args.queries:
            emit(f, {"label": args.label, "card": card,
                     "scale": args.queries,
                     "queries": query_profiles(torch, args.queries)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
