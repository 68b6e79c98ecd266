#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--scale N]

Phases, each fatal on failure (no phase's error is caught):

1. print the card's name and power limit (``nvidia-smi``);
2. build the seven Hopper kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on synthetic CUDA
   inputs (``delta_merge`` also on empty arrays, tombstone runs longer than
   256 and a base array of more than 2^20 words; ``expand_filter_compact``
   with its bound id read from a parameter vector, and on the look-back's
   hard cases of ``tests/torch_cases.py``: every slot surviving at capacity
   2^22, none, survivors only in the last tile, total = capacity +- 1, long
   zero-degree runs, a bound id matching one slot, 50 back-to-back calls at
   mixed capacities and calls on two streams in flight together;
   ``signature_filter`` on 1 to 9 ids, aligned and as a ``v[1:]`` view, and
   on its 4-byte row path; ``bitmap_superset`` with row ids (the engine's
   form) on 1 to 9 ids and 5000, aligned and as a view, at the main path's
   size and on its 8- and 4-byte row paths, and in its contract form on
   aligned and unaligned tables; ``delta_merge`` with row ids (the
   engine's form) on ``DELTA_ROW_CASES`` (each optional field absent, no
   valid slot, k % 4 != 0, runs longer than 256, a base array over 2^20
   words) and at the main path's size, row and j aligned and not, beside
   its contract form, each call one launch; ``tile_membership`` in its
   range form (the engine's) on ``TILE_RANGE_CASES`` (probes out of range,
   degree 0, degree = tb and past it, tb from 8 to 128, negative
   candidates, strided and contiguous probes) and in its contract form on
   its 16-byte and 4-byte load paths; ``expand_filter_compact`` at capacity
   2^23 with more than 2^22 survivors; ``segment_gather`` fixed
   and ragged, weighted and not, float32 and bfloat16, with negative and
   out-of-range ids and segments, and the ragged form's
   ``GATHER_RAGGED_EDGE_CASES`` (every entry dropped, E = 0, d of 1, 33,
   100, an unaligned table) on both load paths, within the tolerances it
   prints and bit-equal across the paths);
4. parity scale: LUBM (scale 8, density 0.6) and BSBM (3000 products)
   through ``SparqlEngine.query`` on the card; the counts must equal
   ``benchmarks/BENCH_exec.json``;
5. full scale: LUBM at ``--scale`` universities (default 1000, about 7.4M
   triples), all 14 LUBM queries in bindings and in count mode, cold and
   warm latency, peak device memory; every count and every binding row is
   held against the port's CPU run of the same query; after the launch
   window, one warm Q2 and Q9 each under ``torch.profiler``: the CUDA
   kernels it launched and the device's busy share of its window; then a
   synthetic graph whose last fused step binds 6,000,000 rows: the default
   ``ExecOpts.max_cap`` (2^22) must refuse it, and ``max_cap = 1 << 23``
   must answer it equal to the port's CPU run;
5b. live store at the same scale: the ``benchmarks/bench_update.py``
   stream (12.5% of the plain triples held back and inserted in 8 batches,
   a tenth as many deletes; the last batch as SPARQL UPDATE text) into a
   ``VersionedStore``, the update query mix on the card after each batch;
   then all 14 queries on the final snapshot, held against the CPU run of
   that snapshot (counts and rows), a from-scratch rebuild of the final
   triple set (counts) and the compacted store (counts and sorted rows);
   then a 64-lane batch of the F1 query family (below) on the final
   snapshot, held against its members' own runs and the CPU run; after the
   window, warm Q2 and Q9 on the final snapshot profiled as in phase 5;
5c. query families on the phase-5 graph: ``compile_param`` →
   ``execute_param_batch`` for F1 (``benchmarks/bench_serve.py``
   SAME_SHAPE_TMPL, constants a zipf(0.7) draw over the first 512
   students, seed 0), F2 and F3 (TMPL_COURSE and TMPL_TWO_CONST of
   ``tests/test_param_batch.py``), F4 and F5 (LUBM Q9 and Q2 with a hoisted
   constant, so the batch joins non-tree edges), in batches of 1, 2, 3 and
   64 lanes and both collect modes; every lane is then held against its
   own ``execute_param`` run, the CPU run and ``query`` on the text with
   the constant baked in; one lane's constant is missing, and a 64-lane
   batch run with a small capacity slack must rerun an overflowing lane
   alone;
6. each engine kernel's wrapper on the largest inputs the main path gave
   it (phases 4-5c), and the kernels of ``SMALLEST`` also on the smallest,
   held bit-equal against its plain version and timed beside it with CUDA
   events, with its byte bound (and, for ``signature_filter`` and
   ``bitmap_superset``'s ids form, the distinct 32-byte sectors its
   gathers touch); ``tile_membership``, ``bitmap_superset`` and
   ``delta_merge`` also in their contract form on the same work gathered
   beforehand, and as the step segment the engine ran before they took in
   their gathers (the gathers or the tile build, then the contract form);
   the ``expand_filter_compact`` calls of each path counted by power-of-two
   capacity; and ``segment_gather``
   at its users' shapes (DLRM RM-2's largest table looked up by a
   ``serve_bulk`` batch; GCN aggregation over ``ogb_products``), held
   against its plain version within tolerance and timed beside it and
   beside ``torch.nn.functional.embedding_bag``; the ragged form both
   through its wrapper and as its kernel alone on the sorted keys;
7. serve (run after 5b's checks, before its compaction): one
   ``DatasetRegistry`` on the card hosts phase 5's graph (``lubm``, static)
   and phase 5b's store with its final delta (``live``, updatable) behind
   a ``Scheduler`` (4 workers, batches of up to 64, a 20 ms batch window)
   and the HTTP server on 127.0.0.1; over HTTP come the 400, 404, 409 and
   504 cases (the 504 a 1 ms deadline on a query not compiled yet), the 14
   LUBM queries to both datasets with an alpha-renamed duplicate of each
   from 8 client threads, phase 5c's 64 F1 members with a duplicate of each
   all at once (a parameterized batch of 2 or more and coalesced requests
   must be seen), an INSERT DATA on ``live`` that a re-query shows and a
   DELETE DATA that reverts it, a misestimated query repeated until the
   workload feedback replans it (``feedback_min_runs=2``,
   ``qerror_threshold=1.5``), a forced trace (its step spans name the
   step kernels the run reports, each with a positive ``model_ms`` from the
   roofline's ``cuda`` row), and ``/healthz``, ``/metrics``,
   ``/debug/workload``, ``/debug/slow`` and the small-plan probe's
   verdicts; every answer's count and sorted decoded rows equal phase 5's
   or 5b's (F1's: the CPU run's); requests, QPS and the scheduler's p50 /
   p99 are printed beside the card's name and power limit;
8. sharded (run after 5c, on phase 5's engine): (a) one NCCL rank, a
   ``(pod, data, model) = (1, 1, 1)`` mesh: every LUBM query with steps
   through ``run_sharded``, equal to ``Executor.run`` on the card and to
   phase 5's CPU count, its warm time beside ``Executor.run``'s; (b)
   ``engine_chunk_step`` over a one-label random graph the size of LUBM
   1000 (seed 0) in chunks of its start candidates: the sum equals
   ``Executor.run`` of the path plan, and one chunk equals its CPU run;
   (c) "ranks share one card": two gloo ranks
   (``repro_torch.launch.sharded.spawn_ranks``, mesh (1, 2, 1)) at parity
   scale, each rank's counts equal ``Executor.run``'s on the card.  It
   verifies nothing multi-card.  The window holds only (a)'s
   ``run_sharded`` and (b)'s ``engine_chunk_step`` calls; after it, each
   kernel's largest call in it is held bit for bit against its plain
   version, the gap between a one-chunk ``run_sharded`` and
   ``Executor.run`` is profiled, and ``GreedyChunker`` is held to and
   timed against the reference's loop;
9. zoo (run after phase 6's gather window): (a) ``repro_torch.launch.
   train.main`` trains DLRM RM-2 at its published size (26 tables,
   19,107,700 rows, embed 64, bottom MLP 13-512-256-64, top MLP
   512-256-1, hotness 8; 1,223,392,321 parameters) for 3 steps at the
   ``train_batch`` cell's 65,536 on the card and writes its 14.7 GB final
   checkpoint (the phase first checks that 30 GB are free under its
   directory in ``build/``); ``final step=3`` is printed, the loss is
   finite, every table moved, each step launched ``segment_gather`` once a
   table, and the window's largest call (the 10M-row table) is bit-equal
   to its plain version; the checkpoint's step and a table's rows are read
   back, then it is removed; one step is split into host batch
   generation, host-to-device copy, forward, backward and AdamW (CUDA
   events; the 26 bag launches and their 26 backward calls each between
   events of their own), one runs under ``torch.profiler`` (the device's
   busy share and device time by kernel, with the bag kernels it saw),
   and the ``train_batch`` call and its backward are timed beside
   ``embedding_bag``; (b) one step on the card against
   the same step on the CPU at RM-2's widths with each table capped at
   100,000 rows (907,700 rows): loss, gradient norm and every gradient
   within the tolerances stated at ``ZOO_*``, each table's gradient also
   row by row against the exact sum of the card's own terms, and a
   ``Checkpointer`` round trip at that size; (c) ``forward`` at ``serve_p99`` (512) and
   ``serve_bulk`` (262,144) and ``retrieval_score`` against 1,000,000
   candidates on (a)'s tables, each equal to the CPU run within
   tolerance; (d) ``gcn-cora`` at its published widths (d_feat 1433,
   hidden 16, 7 classes) for 20 steps on the card and on the CPU from the
   same weights: the loss trajectories agree.

The run drives seven paths, each in its own launch-counting window: the
static path (phases 4-5), the parameterized path (phase 5c's family
batches; the lanes' checks and the solo timings come after the window
closes), the sharded path (phase 8's ``run_sharded`` and
``engine_chunk_step`` calls; its set-up and checks come before and after
the window), the live
path (phase 5b's stream, its queries and its family
batch on the final snapshot; its checks against the members' own runs, the
CPU run, the rebuild and the compacted store come after the window
closes), the serve path (phase 7, its checks included: they read only
host data), the gather path (phase 6's one
call of each ``segment_gather`` entry point at its users' shapes), and the
zoo path (phase 9 (a): ``launch.train.main``'s three RM-2 steps, its
model build and final checkpoint; 78 ``segment_gather`` launches).  The
kernels' launch counters are set to 0 just before a window and read just
after it; a kernel of a path launched no time in that path's window fails
the run.  The last lines are the ``kernels`` JSON object (``launches`` is
the sum of the windows, ``launches_by_path`` each window's count), then
the device line.  Details go to ``chiprun_out/chip_smoke.json``.
``--save-calls FILE`` also saves the recorded calls of the kernels of
``SMALLEST`` for ``tools/kernel_ab.py``, which times them against another
tree's kernels.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet):
# HBM bytes/s, and the float32 non-tensor rate used for the kernels' few
# 32-bit integer operations per byte
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

KERNEL_INFO = {
    "expand_filter_compact": ("src/repro_torch/kernels/csrc/expand_filter.cu",
                              "src/repro/kernels/expand_filter.py:113"),
    "edge_exists": ("src/repro_torch/kernels/csrc/edge_exists.cu",
                    "src/repro/kernels/edge_exists.py:46"),
    "tile_membership": ("src/repro_torch/kernels/csrc/tile_membership.cu",
                        "src/repro/kernels/sorted_intersect.py:34"),
    "bitmap_superset": ("src/repro_torch/kernels/csrc/bitmap_superset.cu",
                        "src/repro/kernels/bitmap_filter.py:27"),
    "signature_filter": ("src/repro_torch/kernels/csrc/signature_filter.cu",
                         "src/repro/kernels/signature_filter.py:35"),
    "delta_merge": ("src/repro_torch/kernels/csrc/delta_merge.cu",
                    "src/repro/kernels/delta_merge.py:64"),
    "segment_gather": ("src/repro_torch/kernels/csrc/segment_gather.cu",
                       "src/repro/kernels/segment_gather.py:39"),
}
# the engine's kernels (each behind the ops wrapper of its name); the
# recorder keeps their largest calls for phase 6
ENGINE_KERNELS = ("expand_filter_compact", "edge_exists", "tile_membership",
                  "bitmap_superset", "signature_filter", "delta_merge")
# the redesigned kernels, also timed at their smallest main-path call (and
# saved for tools/kernel_ab.py by --save-calls)
SMALLEST = ("expand_filter_compact", "tile_membership", "signature_filter",
            "bitmap_superset", "delta_merge")
# the kernels that take in the gathers the main path ran before them: with
# ids= / row= / iptr= each call is one launch where an earlier tree made a
# torch gather (bitmap_superset), five gathers and a fill (delta_merge), or
# the probe clamp, two iptr gathers and the adjacency tile's build
# (tile_membership) first
FUSED_GATHERS = {"bitmap_superset": "ids", "delta_merge": "row",
                 "tile_membership": "iptr"}
# the warm queries whose CUDA kernels phases 5 and 5b count with
# torch.profiler
PROFILED = ("Q2", "Q9")
# the kernels each path must launch: the static path has no delta, and in
# delta mode non-tree joins take edge_exists, never tile_membership; the
# params path's non-tree joins are F4's and F5's, and its fused steps are
# the batches of one and the lanes rerun alone; the serve path hosts both
PATH_KERNELS = {
    "static": ("expand_filter_compact", "edge_exists", "tile_membership",
               "bitmap_superset", "signature_filter"),
    "params": ("expand_filter_compact", "edge_exists", "tile_membership",
               "bitmap_superset", "signature_filter"),
    "live": ("expand_filter_compact", "edge_exists", "bitmap_superset",
             "signature_filter", "delta_merge"),
    "gather": ("segment_gather",),
    # phase 7: the static dataset's five and the live dataset's delta_merge
    "serve": ENGINE_KERNELS,
    # phase 8: run_sharded's chunk programs on the static graph, and
    # engine_chunk_step's filter and join
    "sharded": ("expand_filter_compact", "edge_exists", "tile_membership",
                "bitmap_superset", "signature_filter"),
    # phase 9: DLRM's embedding bags, one fixed-form launch a table a step
    "zoo": ("segment_gather",),
}
PARITY = {  # BENCH_exec.json keys checked at parity scale
    "lubm": ("Q2", "Q8", "Q9", "Q13"),
    "bsbm": ("B1", "B3", "B5", "B8"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


# --------------------------------------------------------------- recording


class Recorder:
    """Wraps the kernel entry points of ``repro_torch.kernels.ops`` and keeps
    the arguments of the largest call of each kernel (and of the smallest
    call of each of ``SMALLEST``), so phase 6 can rerun them at the main
    path's own shapes; it also counts ``expand_filter_compact`` calls by
    power-of-two capacity in each path.  The wrapped call is the original
    wrapper, so launch counts are unchanged."""

    def __init__(self, ops):
        self.ops = ops
        self.calls: dict[str, tuple] = {}
        self.smallest: dict[str, tuple] = {}
        self.cap_hist: dict[str, dict[int, int]] = {}
        self.orig = {name: getattr(ops, name) for name in ENGINE_KERNELS}

    @staticmethod
    def rows(name, args, kw) -> tuple[int, ...]:
        """A call's size: its input rows (then, for the fused step, its
        capacity), read from shapes only so recording adds no sync."""
        if name == "expand_filter_compact":
            return (int(args[4].shape[0]), int(args[7]))  # offs rows, cap
        if name in ("signature_filter", "edge_exists"):
            return (int(args[1].shape[0]),)
        if name == "delta_merge":
            return (int(args[8].shape[0]),)  # slots
        if kw.get("ids") is not None:  # bitmap_superset's ids form
            return (int(kw["ids"].shape[0]),)
        return (int(args[0].shape[0]),)  # tile_membership, bitmap_superset

    def install(self, path: str) -> None:
        hist = self.cap_hist.setdefault(path, {})
        for name, fn in self.orig.items():
            def wrapped(*args, _name=name, _fn=fn, **kw):
                if args[0].is_cuda:
                    r = self.rows(_name, args, kw)
                    best = self.calls.get(_name)
                    if best is None or r > best[0]:
                        self.calls[_name] = (r, args, kw)
                    low = self.smallest.get(_name)
                    if _name in SMALLEST and (low is None or r < low[0]):
                        self.smallest[_name] = (r, args, kw)
                    if _name == "expand_filter_compact":
                        b = 1 << (int(args[7]) - 1).bit_length()
                        hist[b] = hist.get(b, 0) + 1
                return _fn(*args, **kw)
            setattr(self.ops, name, wrapped)

    def remove(self) -> None:
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


# ------------------------------------------------------------------ timing


# device cycles the card idles (torch.cuda._sleep, about a millisecond)
# before a timed call, while the host enqueues it
HEAD_START_CYCLES = 2_000_000


def time_ms(torch, fn, reps: int = 20, flush_l2: bool = True,
            head_start: bool = True) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events around
    each.  Before each run the 50 MB L2 is flushed (unless ``flush_l2`` is
    False), as the main path finds its inputs after other steps' traffic,
    and the card is held busy for about a millisecond (unless
    ``head_start`` is False) while the host enqueues the run, so the events
    time the device, not the wrapper's host work (which exceeds a small
    kernel's device time several times over).  A call that takes the host
    longer than the head start counts its host time beyond it."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush_l2:
            flush.zero_()
        if head_start:
            torch.cuda._sleep(HEAD_START_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def host_ms(torch, fn, reps: int = 100) -> float:
    """The host's time per call of ``fn`` (its wrapper's Python and the
    launch), over ``reps`` calls enqueued back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def bound(torch, ref, name, args, kw) -> tuple[float, float, str]:
    """(bytes, ops, bound_by) the call must at least move / do on these
    inputs: each input read once and each output written once, counting
    only the rows and words this data touches."""
    def nb(t):
        return t.numel() * t.element_size()

    if name == "bitmap_superset" and kw.get("ids") is not None:
        # the ids, each distinct row they touch, req, one byte out a probe
        bm, req = args
        ids = kw["ids"]
        uniq = torch.unique(ids.clamp(0, bm.shape[0] - 1)).numel()
        byts = nb(ids) + uniq * bm.shape[1] * 4 + nb(req) + ids.shape[0]
        ops = 2 * ids.shape[0] * bm.shape[1]
    elif name == "bitmap_superset":
        bm, req = args
        byts = nb(bm) + nb(req) + bm.shape[0]
        ops = 2 * bm.numel()
    elif name == "signature_filter":
        sig, v, req = args
        uniq = torch.unique(v.clamp(0, sig.shape[0] - 1)).numel()
        byts = nb(v) + uniq * sig.shape[1] * 4 + nb(req) + v.shape[0]
        ops = 2 * v.shape[0] * sig.shape[1]
    elif name == "tile_membership" and kw.get("iptr") is not None:
        # the range form: probe and v a row, the distinct iptr sectors the
        # probes touch, the distinct nbr words of the rows whose v >= 0
        # (lo to min(hi, lo + tb)), one byte out a row
        v, nbr = args
        iptr, probe, tb = kw["iptr"], kw["probe"], kw["tb"]
        p = probe.long().clamp(0, iptr.shape[0] - 2)
        lo = iptr[p].long()
        end = torch.minimum(iptr[p + 1].long(), lo + tb)
        ln = (end - lo).clamp(min=0) * (v >= 0)
        word = iptr.data_ptr() % 32 // 4
        sectors = torch.unique(torch.cat([(p + word) // 8,
                                          (p + 1 + word) // 8])).numel()
        runs = torch.zeros(nbr.shape[0] + 1, dtype=torch.int32,
                           device=v.device)
        live = ln > 0
        runs.index_add_(0, lo[live], torch.ones_like(lo[live],
                                                     dtype=torch.int32))
        runs.index_add_(0, end[live], -torch.ones_like(lo[live],
                                                       dtype=torch.int32))
        words = int((runs.cumsum(0) > 0).sum().item())
        byts = 9 * v.shape[0] + 32 * sectors + 4 * words
        ops = 2 * int(ln.sum().item())
    elif name == "tile_membership":
        a, b = args
        byts = nb(a) + nb(b) + a.numel()
        ops = 2 * a.numel() * b.shape[1]
    elif name == "edge_exists":
        nbr, lo, hi, tgt = args
        ln = (hi - lo).clamp(min=0).double()
        words = torch.ceil(torch.log2(ln + 1)).sum().item()
        words = min(words, float(nbr.numel()))
        byts = nb(lo) + nb(hi) + nb(tgt) + 4 * words + lo.shape[0]
        ops = 3 * words
    elif name == "delta_merge":
        # every slot: the valid byte in, v and ok out.  A valid slot also
        # reads j (and, in the row form, its row id) and b_deg; a base slot
        # b_start, t_lo, t_hi and about log2(run) tombstone words; a delta
        # slot d_start; and each distinct base / delta word a valid slot
        # resolves to.  Per-slot fields count once a slot that needs them;
        # row-level fields (row=) once a distinct row that needs them.
        base, delta, tomb, b_start, b_deg, d_start, t_lo, t_hi, j, valid = \
            args
        row = kw.get("row")
        k = j.shape[0]
        r = None if row is None else \
            row.long().clamp(0, b_start.shape[0] - 1)
        zero = torch.zeros_like(j)

        def at(f):
            return zero if f is None else (f if r is None else f[r])

        def words(f, mask) -> int:
            if f is None:
                return 0
            return int(mask.sum()) if r is None else \
                torch.unique(r[mask]).numel()

        bs, bd, ds, tl, th = map(at, (b_start, b_deg, d_start, t_lo, t_hi))
        is_base = (j < bd) & valid
        is_delta = (j >= bd) & valid
        n_valid = int(valid.sum())
        pb = (bs + j)[is_base].clamp(0, base.shape[0] - 1)
        pd = (ds + j - bd)[is_delta].clamp(0, delta.shape[0] - 1)
        run = (th - tl)[is_base].clamp(min=0).double()
        tomb_words = min(torch.ceil(torch.log2(run + 1)).sum().item(),
                         float(tomb.numel()))
        field_words = (words(b_deg, valid) + words(b_start, is_base)
                       + words(t_lo, is_base) + words(t_hi, is_base)
                       + words(d_start, is_delta))
        byts = (1 + 4 + 1) * k + 4 * n_valid * (1 if row is None else 2) \
            + 4 * field_words \
            + 4 * (torch.unique(pb).numel() + torch.unique(pd).numel()) \
            + 4 * tomb_words
        ops = 2 * n_valid + 3 * tomb_words
    else:  # expand_filter_compact
        nbr, bitmap, start, deg, offs, mask = args[:6]
        cap = int(args[7])
        row, j, valid = ref.ragged_expand_ref(offs, deg, cap)
        pos = (start[row] + j)[valid]
        v = nbr[pos.clamp(0, nbr.shape[0] - 1)]
        n_valid = int(valid.sum().item())
        byts = (nb(start) + nb(deg) + nb(offs) + nb(mask)
                + 4 * torch.unique(pos).numel()
                + bitmap.shape[1] * 4 * torch.unique(v).numel()
                + 2 * 4 * cap + 4)
        ops = cap * (max(1, offs.shape[0]).bit_length() + 4) \
            + 2 * n_valid * bitmap.shape[1]
    by = "bytes" if byts / PEAK_BYTES_S >= ops / PEAK_OPS_S else "operations"
    return float(byts), float(ops), by


def max_abs_err(torch, got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g_, w_ in zip(got, want):
        check(g_.shape == w_.shape and g_.dtype == w_.dtype,
              f"shape/dtype {tuple(g_.shape)} {g_.dtype} vs "
              f"{tuple(w_.shape)} {w_.dtype}")
        if g_.is_floating_point():
            d = (g_.double() - w_.double()).abs()
        else:
            d = (g_.long() - w_.long()).abs()
        err = max(err, float(d.max().item()) if d.numel() else 0.0)
    return err


def adjacency_tile(torch, nbr, iptr, probe, tb):
    """The executor's ``adj_tile`` as the engine built it before the range
    form of ``tile_membership``: the probe clamped, its ``iptr`` range,
    then the ``[rows, tb]`` tile of its adjacency, -2 past the range."""
    psafe = probe.clamp(0, iptr.shape[0] - 2)
    lo = iptr[psafe]
    hi = iptr[psafe + 1]
    pos = lo[:, None] + torch.arange(tb, dtype=torch.int32,
                                     device=lo.device)[None, :]
    return torch.where(pos < hi[:, None],
                       nbr[pos.clamp(0, nbr.shape[0] - 1)], -2)


def contract_out(name, out):
    """A contract-form result in the fused form's shape (``tile_membership``
    answers ``[rows, 1]`` for the range form's ``[rows]``)."""
    return out[:, 0] if name == "tile_membership" else out


def contract_call(torch, name, args, kw):
    """The TPU-contract form of a recorded call that used ``ids=``,
    ``row=`` or ``iptr=``: ``(args, kw)`` with the rows, the per-slot fields
    or the adjacency tile gathered beforehand (absent fields as zeros, as
    the main path filled them before), so the kernel is timed on the same
    work without the gathers."""
    if name == "tile_membership" and kw.get("iptr") is not None:
        v, nbr = args
        return (v[:, None], adjacency_tile(torch, nbr, kw["iptr"],
                                           kw["probe"], kw["tb"])), {}
    if name == "bitmap_superset" and kw.get("ids") is not None:
        table, req = args
        ids = kw["ids"].long().clamp(0, table.shape[0] - 1)
        return (table[ids], req), {}
    if name == "delta_merge" and kw.get("row") is not None:
        row = kw["row"].long().clamp(0, args[3].shape[0] - 1)
        zero = torch.zeros_like(kw["row"])
        fields = [zero if f is None else f[row] for f in args[3:8]]
        return (*args[:3], *fields, *args[8:]), {"n_iters": kw["n_iters"]}
    return args, kw


def unfused_segment(torch, kern, name, args, kw):
    """The step segment as the engine ran it before ``ids=`` / ``row=`` /
    ``iptr=``: the gathers it made before the call (the label filter's
    ``bitmap_src[vsafe]``; the merged step's ``zeros_like`` fill and its
    five field gathers; the +INT check's probe clamp, ``iptr`` gathers and
    tile build), then the contract-form kernel ``kern``.  Runs against any
    tree's kernels, the parent's included."""
    if name == "tile_membership":
        v, nbr = args

        def segment():
            tile = adjacency_tile(torch, nbr, kw["iptr"], kw["probe"],
                                  kw["tb"])
            return kern(v[:, None], tile)[:, 0]
    elif name == "bitmap_superset":
        table, req = args
        ids = kw["ids"]

        def segment():
            return kern(table[ids], req)
    else:
        row = kw["row"]
        base, delta, tomb, bs, bd, ds, tl, th, j, valid = args

        def segment():
            zero = torch.zeros_like(row)
            return kern(base, delta, tomb, bs[row], bd[row],
                        ds[row] if ds is not None else zero,
                        tl[row] if tl is not None else zero,
                        th[row] if th is not None else zero, j, valid,
                        n_iters=kw["n_iters"])
    return segment


def profile_query(torch, fn, parts: tuple[str, ...] = ()) -> dict:
    """One run of ``fn`` (a warm query, a train step) under
    ``torch.profiler``: the CUDA kernels it launched, its device copies and
    fills, the share of its window (host clock from the call to a device
    sync) in which the device was busy (the union of those intervals), and
    the device time and count by kernel name (the 12 largest) and of the
    kernels whose name holds each of ``parts``.  ``None`` counts where the
    profiler saw no device activity (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"cuda_kernels": None, "copies_fills": None,
                "device_busy_share": None, "window_us": window_us,
                "parts": {part: {"us": 0.0, "calls": 0} for part in parts}}
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in dev:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"cuda_kernels": len(dev) - len(copies),
            "copies_fills": len(copies), "device_busy_us": busy,
            "window_us": window_us, "device_busy_share": busy / window_us,
            "kernels_by_name": dict(sorted(
                ((n, c) for n, (_, c) in by_name.items()
                 if not n.startswith(("Memcpy", "Memset"))),
                key=lambda kv: -kv[1])),
            "device_us_by_name": {n[:120]: {"us": us, "calls": c}
                                  for n, (us, c) in top},
            "parts": {part: {
                "us": sum(us for n, (us, _) in by_name.items() if part in n),
                "calls": sum(c for n, (_, c) in by_name.items()
                             if part in n)} for part in parts}}


def gather_tol(dtype: str, hot: int) -> float:
    """``segment_gather``'s tolerance (rtol = atol), stated because its
    sums run in another order than its plain version's: float32 1e-5 for
    runs of at most 32 entries and 1e-4 for longer runs, bfloat16 2e-2
    (the plain version rounds its float32 sum once, as the kernel does)."""
    if dtype == "bfloat16":
        return 2e-2
    return 1e-5 if hot <= 32 else 1e-4


def gather_close(torch, got, want, dtype: str, hot: int, what: str) -> float:
    """Hold a ``segment_gather`` result against its plain version within
    ``gather_tol``; returns the largest absolute difference."""
    tol = gather_tol(dtype, hot)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    g_, w_ = got.float(), want.float()
    check(bool(torch.isfinite(g_).all()), f"{what}: non-finite output")
    check(bool(torch.allclose(g_, w_, rtol=tol, atol=tol)),
          f"{what}: kernel differs from its plain version beyond "
          f"rtol=atol={tol}")
    return float((g_ - w_).abs().max().item()) if g_.numel() else 0.0


# ------------------------------------------------------------------ phases


def synthetic_checks(torch, ops, ref) -> None:
    """Phase 3: each kernel against its plain version on synthetic
    inputs."""
    rng = np.random.default_rng(0)
    dev = "cuda"

    def t(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.copy()).to(dev)

    nbr = np.sort(rng.integers(0, 5000, 20000)).astype(np.int32)
    lo = rng.integers(0, 20000, 5000).astype(np.int32)
    hi = np.minimum(20000, lo + rng.integers(0, 40, 5000)).astype(np.int32)
    tgt = np.where(rng.random(5000) < 0.5, nbr[lo], rng.integers(0, 5000, 5000)).astype(np.int32)
    a = (t(nbr), t(lo), t(hi), t(tgt))
    cases = [("edge_exists", lambda: ops.edge_exists(*a, n_iters=8),
              lambda: ref.edge_exists_ref(*a, n_iters=8))]
    ta = t(rng.integers(-1, 50, (3000, 1)).astype(np.int32))
    tb = t(rng.integers(-2, 50, (3000, 64)).astype(np.int32))
    cases.append(("tile_membership", lambda: ops.tile_membership(ta, tb),
                  lambda: ref.tile_membership_ref(ta, tb)))
    for w in (1, 2, 5):
        bm = t(rng.integers(0, 2**32, (4000, w), dtype=np.uint64).astype(np.uint32))
        req = t(np.full(w, 0x80000003, np.uint32))
        cases.append((f"bitmap_superset w={w}",
                      lambda bm=bm, req=req: ops.bitmap_superset(bm, req),
                      lambda bm=bm, req=req: ref.bitmap_superset_ref(bm, req)))
        sig = t(rng.integers(0, 2**32, (3000, 2 * w), dtype=np.uint64).astype(np.uint32))
        vv = t(rng.integers(-2, 3003, 4000).astype(np.int32))
        sreq = t(np.full(2 * w, 0x00010001, np.uint32))
        cases.append((f"signature_filter w={2 * w}",
                      lambda sig=sig, vv=vv, sreq=sreq: ops.signature_filter(sig, vv, sreq),
                      lambda sig=sig, vv=vv, sreq=sreq: ref.signature_filter_ref(sig, vv, sreq)))
        deg = rng.integers(0, 9, 5000).astype(np.int32)
        deg[::4] = 0
        m = int(deg.sum()) + 3
        enbr = t(rng.integers(0, 3000, m).astype(np.int32))
        start = t((np.cumsum(deg) - deg).astype(np.int32))
        offs = start.clone()
        emask = t(np.array([5] + [0] * (w - 1), np.uint32))
        ebm = t(rng.integers(0, 2**32, (3000, w), dtype=np.uint64).astype(np.uint32))
        tdeg = t(deg)
        for cap, bid, slot in ((1 << 15, [-1], 0), (1 << 12, [-1], 0),
                               (1 << 15, [7], 0), (1 << 15, [3, 7, -1], 1),
                               (1 << 15, [3, 7, -1], 2)):
            # a parameter vector's element is a view at its slot
            args = (enbr, ebm, start, tdeg, offs, emask,
                    t(np.array(bid, np.int32))[slot], cap)
            cases.append((f"expand_filter_compact w={w} cap={cap} "
                          f"bound={bid}[{slot}]",
                          lambda args=args: ops.expand_filter_compact(*args),
                          lambda args=args: ref.expand_filter_compact_ref(*args)))
    def delta_case(k, mb, md, mt, run, mode):
        """``delta_merge`` inputs: sorted base, tombstones drawn from the
        base values (hits and misses), 20% invalid slots; ``mode`` makes
        every slot a base slot, a delta slot, or either."""
        vmax = max(64, mb // 2)
        base = np.sort(rng.integers(0, vmax, mb)).astype(np.int32)
        delta = rng.integers(0, vmax, md).astype(np.int32)
        tomb = np.sort(base[rng.integers(0, max(mb, 1), mt)] if mb
                       else np.zeros(mt, np.int32)).astype(np.int32)
        b_start = rng.integers(0, max(mb, 1), k).astype(np.int32)
        b_deg = rng.integers(0 if mode == "mixed" else 1, 7, k).astype(np.int32)
        d_start = rng.integers(0, max(md, 1), k).astype(np.int32)
        t_lo = rng.integers(0, max(mt, 1), k).astype(np.int32)
        t_hi = np.minimum(mt, t_lo + rng.integers(0, run, k)).astype(np.int32)
        j = rng.integers(0, 9, k).astype(np.int32)
        if mode == "base":
            j = (j % b_deg).astype(np.int32)
        elif mode == "delta":
            j = (j + b_deg).astype(np.int32)
        valid = torch.from_numpy(rng.random(k) < 0.8).to(dev)
        arrs = [t(a) for a in (base, delta, tomb, b_start, b_deg, d_start,
                               t_lo, t_hi, j)]
        # the plain version sees empty arrays as the wrapper pads them
        plain = [a if a.shape[0] or i > 2 else
                 torch.full((1,), -1, dtype=torch.int32, device=dev)
                 for i, a in enumerate(arrs)]
        return (*arrs, valid), (*plain, valid)

    for k, mb, md, mt, run, mode, it in (
            (20000, 50000, 4096, 8000, 8, "mixed", 32),
            (20000, 50000, 4096, 8000, 8, "base", 32),
            (20000, 50000, 4096, 8000, 8, "delta", 32),
            (20000, 50000, 0, 8000, 8, "mixed", 32),     # empty delta
            (20000, 50000, 4096, 0, 8, "mixed", 32),     # empty tombstones
            (20000, 50000, 4096, 20000, 2000, "base", 32),  # runs > 256
            (20000, 50000, 4096, 20000, 2000, "mixed", 8),
            (1 << 20, 1_500_000, 1 << 14, 200_000, 600, "mixed", 32)):
        args, pargs = delta_case(k, mb, md, mt, run, mode)
        cases.append((f"delta_merge k={k} base={mb} delta={md} tomb={mt} "
                      f"run<{run} {mode} n_iters={it}",
                      lambda a=args, it=it: ops.delta_merge(*a, n_iters=it),
                      lambda a=pargs, it=it: ref.delta_merge_ref(
                          *a, n_iters=it)))
    for label, kern, plain in cases:
        got = kern()
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, plain())
        check(err == 0, f"{label}: kernel differs from its plain version")
    log(f"phase 3: {len(cases)} kernel checks bit-equal to the plain versions")
    edge_checks(torch, ops, ref)
    fused_checks(torch, ops, ref)
    range_checks(torch, ops, ref)
    gather_checks(torch, ops, ref, rng)


def edge_checks(torch, ops, ref) -> None:
    """Phase 3, the hard cases of the two redesigned kernels, from
    ``tests/torch_cases.py``: ``expand_filter_compact`` on
    ``EFC_EDGE_CASES`` (one launch each), 50 back-to-back calls at mixed
    capacities on one stream, and calls on two streams in flight together,
    each look-back ticket word then counting its stream's calls;
    ``signature_filter`` on 1 to 9 ids, aligned and as a ``v[1:]`` view,
    and on rows of an odd word count and a table that is not 8-byte
    aligned."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import (EFC_BACK_TO_BACK_CAPS, EFC_EDGE_CASES,
                             EFC_STREAM_SETS, SIG_EDGE_CASES,
                             efc_edge_inputs, efc_inputs,
                             efc_tickets_settled, sig_inputs, tt)

    dev = "cuda"
    n = 0

    def equal(got, want, what: str) -> None:
        nonlocal n
        torch.cuda.synchronize()
        check(max_abs_err(torch, got, want) == 0,
              f"{what}: kernel differs from its plain version")
        n += 1

    for kind, cap in EFC_EDGE_CASES:
        args, bid = efc_edge_inputs(kind, cap)
        targs = [tt(a, dev) for a in args]
        tbid = tt(np.int32(bid), dev)
        before = ops.launches["expand_filter_compact"]
        got = ops.expand_filter_compact(*targs, tbid, cap)
        check(ops.launches["expand_filter_compact"] == before + 1,
              f"expand_filter_compact {kind}: not one launch")
        equal(got, ref.expand_filter_compact_ref(*targs, tbid, cap),
              f"expand_filter_compact {kind} cap={cap}")
    sets = []
    for r, v, w, bid0 in EFC_STREAM_SETS:
        args, bid, _ = efc_inputs(r, v, w, r + v, True, bid0)
        sets.append(([tt(a, dev) for a in args], tt(np.int32(bid), dev)))
    torch.cuda.synchronize()
    runs = [(i % 3, cap, ops.expand_filter_compact(*sets[i % 3][0],
                                                   sets[i % 3][1], cap))
            for i, cap in enumerate(EFC_BACK_TO_BACK_CAPS)]
    s2 = torch.cuda.Stream()
    for i in range(10):
        cap = (1 << 20, 1 << 14, 5000)[i % 3]
        runs.append((0, cap, ops.expand_filter_compact(*sets[0][0],
                                                       sets[0][1], cap)))
        with torch.cuda.stream(s2):
            k = 1 + i % 2
            runs.append((k, 4096, ops.expand_filter_compact(
                *sets[k][0], sets[k][1], 4096)))
    torch.cuda.synchronize()
    for k, cap, got in runs:
        equal(got, ref.expand_filter_compact_ref(*sets[k][0], sets[k][1],
                                                 cap),
              f"expand_filter_compact back to back, set {k} cap={cap}")
    check(efc_tickets_settled(ops),
          "a look-back ticket word does not count its stream's calls")
    for n_ids, w2 in SIG_EDGE_CASES:
        sig, ids, req = sig_inputs(50, w2, n_ids + 1, n_ids * 11 + w2)
        tsig, tids, treq = tt(sig, dev), tt(ids, dev), tt(req, dev)
        for view in (tids[:n_ids], tids[1:]):
            equal(ops.signature_filter(tsig, view, treq),
                  ref.signature_filter_ref(tsig, view, treq),
                  f"signature_filter n={n_ids} w2={w2} "
                  f"at {view.data_ptr() % 16}")
    for w2, offset in ((3, 0), (2, 1), (10, 1)):
        sig, ids, req = sig_inputs(3000, w2, 100_003, w2 + offset)
        flat = torch.empty(sig.size + offset, dtype=torch.int32, device=dev)
        flat[offset:] = tt(sig, dev).reshape(-1)
        tsig = flat[offset:].view(sig.shape)
        tids, treq = tt(ids, dev), tt(req, dev)
        for view in (tids, tids[1:]):
            equal(ops.signature_filter(tsig, view, treq),
                  ref.signature_filter_ref(tsig, view, treq),
                  f"signature_filter 4-byte rows w2={w2} offset={offset}")
    log(f"phase 3: {n} look-back and alignment edge checks of "
        f"expand_filter_compact and signature_filter bit-equal to the plain "
        f"versions; ticket words settled")


def launched_once(torch, ops, name, kern, plain, what):
    """``kern()``, which must launch kernel ``name`` once and equal
    ``plain()`` bit for bit; returns its result."""
    before = ops.launches[name]
    got = kern()
    torch.cuda.synchronize()
    check(ops.launches[name] == before + 1, f"{what}: not one launch")
    check(max_abs_err(torch, got, plain()) == 0,
          f"{what}: kernel differs from its plain version")
    return got


def fused_checks(torch, ops, ref) -> None:
    """Phase 3, the forms that take in the main path's gathers, from
    ``tests/torch_cases.py``, each call one launch and bit-equal to its
    plain version: ``bitmap_superset`` with ``ids`` on ``BITMAP_EDGE_CASES``
    (aligned and as an ``ids[1:]`` view) and at the main path's size, on
    8-byte and 4-byte row paths; its contract form on aligned tables (4
    rows a thread as 16-byte loads) and on views that are not; and
    ``delta_merge`` with ``row`` on ``DELTA_ROW_CASES`` and at the main
    path's size, row and j aligned and not, beside its contract form on the
    per-slot arrays."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import (BITMAP_EDGE_CASES, DELTA_FIELDS,
                             DELTA_ROW_CASES, bitmap_ids_inputs,
                             bitmap_inputs, delta_row_inputs, tt)

    dev = "cuda"
    n = 0

    def at(a, offset=0):
        """``a`` on the card, ``offset`` int32 words into its buffer."""
        flat = torch.empty(a.size + offset, dtype=torch.int32, device=dev)
        flat[offset:] = tt(a, dev).reshape(-1)
        return flat[offset:].view(a.shape)

    def one_launch(name, kern, plain, what):
        nonlocal n
        n += 1
        return launched_once(torch, ops, name, kern, plain, what)

    for n_ids, w in BITMAP_EDGE_CASES:
        bm, req, ids = bitmap_ids_inputs(50, w, n_ids + 1, n_ids * 13 + w)
        tbm, treq, tids = tt(bm, dev), tt(req, dev), tt(ids, dev)
        for view in (tids[:n_ids], tids[1:]):
            one_launch("bitmap_superset",
                       lambda: ops.bitmap_superset(tbm, treq, ids=view),
                       lambda: ref.bitmap_superset_ref(tbm, treq, ids=view),
                       f"bitmap_superset ids n={n_ids} w={w} "
                       f"at {view.data_ptr() % 16}")
    for v, w, n_ids, offset in ((2_641_315, 1, 1 << 20, 0),
                                (200_000, 2, 100_003, 0),
                                (200_000, 2, 100_003, 1),
                                (200_000, 3, 100_003, 0),
                                (50_000, 5, 100_003, 2)):
        bm, req, ids = bitmap_ids_inputs(v, w, n_ids, v + n_ids)
        tbm, treq, tids = at(bm, offset), tt(req, dev), tt(ids, dev)
        one_launch("bitmap_superset",
                   lambda: ops.bitmap_superset(tbm, treq, ids=tids),
                   lambda: ref.bitmap_superset_ref(tbm, treq, ids=tids),
                   f"bitmap_superset ids V={v} w={w} n={n_ids} "
                   f"offset={offset}")
    for b, w, offset in ((1, 1, 0), (7, 1, 0), (1 << 20, 1, 0),
                         (100_003, 2, 0), (100_003, 3, 0), (100_003, 4, 0),
                         (100_001, 9, 0), (100_003, 1, 1), (100_003, 2, 2),
                         (100_003, 4, 3)):
        bm, req = bitmap_inputs(b, w, b + w)
        tbm, treq = at(bm, offset), tt(req, dev)
        one_launch("bitmap_superset",
                   lambda: ops.bitmap_superset(tbm, treq),
                   lambda: ref.bitmap_superset_ref(tbm, treq),
                   f"bitmap_superset contract B={b} w={w} offset={offset}")
    for case in DELTA_ROW_CASES + [
            (1 << 20, 1 << 16, 5_185_880, 65_536, 16_384, 40, (), False),
            (1 << 20, 1 << 16, 5_185_880, 65_536, 0, 4, ("t_lo", "t_hi"),
             False)]:
        k, r, mb, md, mt, run, absent, none_valid = case
        arrays, fields, row, j, valid, n_iters = delta_row_inputs(
            k, r, mb, md, mt, run, seed=k + r + mb, none_valid=none_valid)
        arrs = [tt(a, dev) for a in arrays]
        padded = [a if a.shape[0] else torch.full(
            (1,), -1, dtype=torch.int32, device=dev) for a in arrs]
        given = [None if name in absent else tt(f, dev)
                 for name, f in zip(DELTA_FIELDS, fields)]
        rc = np.clip(row, 0, r - 1)
        per_slot = [tt(np.zeros(k, np.int32) if name in absent else f[rc],
                       dev) for name, f in zip(DELTA_FIELDS, fields)]
        tvalid = tt(valid, dev)
        for offset in (0, 1):
            trow, tj = at(row, offset), at(j, offset)
            one_launch("delta_merge",
                       lambda: ops.delta_merge(*arrs, *given, tj, tvalid,
                                               n_iters=n_iters, row=trow),
                       lambda: ref.delta_merge_ref(*padded, *given, tj,
                                                   tvalid, n_iters=n_iters,
                                                   row=trow),
                       f"delta_merge row form {case} offset={offset}")
            one_launch("delta_merge",
                       lambda: ops.delta_merge(*arrs, *per_slot, tj, tvalid,
                                               n_iters=n_iters),
                       lambda: ref.delta_merge_ref(*padded, *per_slot, tj,
                                                   tvalid, n_iters=n_iters),
                       f"delta_merge contract form {case} offset={offset}")
    log(f"phase 3: {n} checks of the ids / row forms and the contract forms "
        f"of bitmap_superset and delta_merge bit-equal to the plain "
        f"versions, one launch each")


def range_checks(torch, ops, ref) -> None:
    """Phase 3, ``tile_membership`` and the compaction kernel's capacity,
    from ``tests/torch_cases.py``, each call one launch and bit-equal to its
    plain version: the range form on ``TILE_RANGE_CASES`` and at the main
    path's size, with the probe as a strided column and contiguous; the
    contract form on 16-byte rows (tb = 4 to 128), on 4-byte words (an
    unaligned b, tb of 12 and 129) and with several results a row; and
    ``expand_filter_compact`` at capacity 2^23 with every slot surviving
    (8,388,608 survivors, past the 2^22 it once refused)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import (TILE_RANGE_CASES, efc_edge_inputs,
                             tile_inputs, tile_range_inputs, tt)

    dev = "cuda"
    n = 0

    def one_launch(name, kern, plain, what):
        nonlocal n
        n += 1
        return launched_once(torch, ops, name, kern, plain, what)

    for case in TILE_RANGE_CASES + [(1 << 15, 2_641_315 // 16, 32, 32)]:
        rows, nv, max_deg, tb = case
        nbr, iptr, table, v = tile_range_inputs(rows, nv, max_deg, tb,
                                                rows + tb)
        ttable = tt(table, dev)
        args = (tt(v, dev), tt(nbr, dev))
        for probe in (ttable[:, 1], ttable[:, 1].contiguous()):
            kw = dict(iptr=tt(iptr, dev), probe=probe, tb=tb)
            one_launch("tile_membership",
                       lambda: ops.tile_membership(*args, **kw),
                       lambda: ref.tile_membership_ref(*args, **kw),
                       f"tile_membership range form {case} "
                       f"stride={probe.stride(0)}")
    for rows, ta, tb, offset in ((5000, 1, 4, 0), (32768, 1, 32, 0),
                                 (5000, 1, 128, 0), (5000, 1, 32, 1),
                                 (5000, 1, 12, 0), (5000, 1, 129, 0),
                                 (3001, 3, 8, 0), (1000, 65, 8, 0)):
        a, b = tile_inputs(rows, ta, tb, rows + ta + tb)
        flat = torch.empty(b.size + offset, dtype=torch.int32, device=dev)
        flat[offset:] = tt(b, dev).reshape(-1)
        targs = (tt(a, dev), flat[offset:].view(b.shape))
        one_launch("tile_membership", lambda: ops.tile_membership(*targs),
                   lambda: ref.tile_membership_ref(*targs),
                   f"tile_membership contract form R={rows} TA={ta} "
                   f"TB={tb} offset={offset}")
    cap = 1 << 23
    args, bid = efc_edge_inputs("all_survive", cap)
    targs = [tt(a, dev) for a in args]
    tbid = tt(np.int32(bid), dev)
    got = one_launch("expand_filter_compact",
                     lambda: ops.expand_filter_compact(*targs, tbid, cap),
                     lambda: ref.expand_filter_compact_ref(*targs, tbid, cap),
                     f"expand_filter_compact at capacity {cap}")
    check(int(got[2]) == cap, f"expand_filter_compact at capacity {cap}: "
                              f"{int(got[2])} survivors, expected {cap}")
    log(f"phase 3: {n} checks of tile_membership's range and contract forms "
        f"and of expand_filter_compact at capacity 2^23 ({cap} survivors) "
        f"bit-equal to the plain versions, one launch each")


def gather_checks(torch, ops, ref, rng) -> None:
    """Phase 3, ``segment_gather``: fixed and ragged, weighted and not,
    float32 and bfloat16, against the plain versions within
    ``gather_tol``.  Fixed ids lie in [-3, V + 3) (negative = padding,
    >= V reads row V-1) with every third segment all padding; ragged ids in
    [-V - 3, V + 3) and segments in [-2, S + 2) (negative ids count from
    the end, outside segments are dropped) with every fourth segment
    empty."""
    dev = "cuda"
    n = 0
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for v, d, s, k, weighted in ((1, 1, 1, 1, False),
                                     (1000, 64, 5000, 8, True),
                                     (1000, 64, 5000, 8, False),
                                     (3000, 100, 4000, 32, True),
                                     (500, 200, 300, 5, True),
                                     (200, 16, 100, 300, True)):
            table = torch.from_numpy(rng.random((v, d), dtype=np.float32)) \
                .to(dev, dt)
            idx = rng.integers(-3, v + 3, size=(s, k)).astype(np.int32)
            idx[::3] = -1
            idx = torch.from_numpy(idx).to(dev)
            w = (torch.from_numpy(rng.random((s, k), dtype=np.float32) + 0.5)
                 .to(dev, dt) if weighted else None)
            got = ops.segment_gather_fixed(table, idx, w)
            torch.cuda.synchronize()
            gather_close(torch, got,
                         ref.segment_gather_fixed_ref(table, idx, w), dtype,
                         k, f"segment_gather_fixed {dtype} V={v} D={d} "
                         f"S={s} K={k} weighted={weighted}")
            n += 1
        for v, d, e, s, weighted in ((4, 3, 6, 3, False),
                                     (2000, 64, 200000, 8000, True),
                                     (2000, 100, 200000, 8000, False),
                                     (500, 64, 300000, 1000, True),
                                     (500, 128, 0, 10, True)):
            table = torch.from_numpy(rng.random((v, d), dtype=np.float32)) \
                .to(dev, dt)
            idx = torch.from_numpy(
                rng.integers(-v - 3, v + 3, size=e).astype(np.int32)).to(dev)
            seg = rng.integers(-2, s + 2, size=e).astype(np.int32)
            seg[(seg >= 0) & (seg % 4 == 1)] = s + 1
            seg = torch.from_numpy(seg).to(dev)
            w = (torch.from_numpy(rng.random(e, dtype=np.float32) + 0.5)
                 .to(dev, dt) if weighted else None)
            got = ops.segment_gather_sum(table, idx, seg, s, w)
            torch.cuda.synchronize()
            hot = -(-e // s)
            gather_close(torch, got,
                         ref.segment_gather_sum_ref(table, idx, seg, s, w),
                         dtype, hot, f"segment_gather_sum {dtype} V={v} D={d} "
                         f"E={e} S={s} weighted={weighted}")
            n += 1
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import GATHER_RAGGED_EDGE_CASES, gather_ragged_edge_inputs

    for v, d, e, s, kind, dtype, offset in GATHER_RAGGED_EDGE_CASES:
        dt = getattr(torch, dtype)
        table, idx, seg, w = gather_ragged_edge_inputs(v, d, e, s, kind,
                                                       e + d)
        targs = (torch.from_numpy(idx).to(dev), torch.from_numpy(seg).to(dev),
                 s, torch.from_numpy(w).to(dev, dt))

        def placed(off):
            flat = torch.zeros(table.size + off, dtype=dt, device=dev)
            flat[off:] = torch.from_numpy(table).to(dev, dt).reshape(-1)
            return flat[off:].view(table.shape)

        what = (f"segment_gather_sum {kind} {dtype} V={v} D={d} E={e} S={s} "
                f"offset={offset}")
        before = ops.launches["segment_gather"]
        got = ops.segment_gather_sum(placed(offset), *targs)
        torch.cuda.synchronize()
        check(ops.launches["segment_gather"] == before + 1,
              f"{what}: not one launch")
        gather_close(torch, got,
                     ref.segment_gather_sum_ref(placed(offset), *targs),
                     dtype, max(1, -(-e // s)), what)
        other = ops.segment_gather_sum(placed(0 if offset else 1), *targs)
        check(torch.equal(got, other),
              f"{what}: the 16-byte and 4-byte load paths differ")
        check(kind == "mixed" or not bool(got.float().any()),
              f"{what}: a dropped entry was summed")
        n += 1
    log(f"phase 3: {n} segment_gather checks within tolerance "
        f"(rtol = atol: float32 1e-5 for runs <= 32 entries, 1e-4 for "
        f"longer runs; bfloat16 2e-2)")


def run_parity(torch, bench: dict) -> dict:
    """Phase 4: BENCH_exec.json counts on the card."""
    from repro_torch.core import SparqlEngine
    from repro_torch.rdf.generator import generate_bsbm, generate_lubm
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.workloads import BSBM_QUERIES, LUBM_QUERIES

    out = {}
    for ds, make, queries in (
            ("lubm", lambda: generate_lubm(scale=8, seed=0, density=0.6),
             LUBM_QUERIES),
            ("bsbm", lambda: generate_bsbm(n_products=3000, seed=1),
             BSBM_QUERIES)):
        g, maps = type_aware_transform(make().finalize())
        eng = SparqlEngine(g, maps)
        for name in PARITY[ds]:
            want = bench[f"{ds}.{name}"]["count"]
            got = eng.query(queries[name]).count
            got_c = eng.count(queries[name])
            check(got == want == got_c,
                  f"{ds}.{name}: count {got} (count mode {got_c}), "
                  f"BENCH_exec.json {want}")
            out[f"{ds}.{name}"] = got
    log(f"phase 4: parity counts equal BENCH_exec.json: {out}")
    return out


def run_full(torch, ops, scale: int):
    """Phase 5: all LUBM queries at full scale on the card, held against
    the port's CPU run.  Returns the phase's record and the generated
    triple store (phase 5b streams it into a live store)."""
    from repro_torch.core import SparqlEngine
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.workloads import LUBM_QUERIES

    t0 = time.perf_counter()
    st = generate_lubm(scale=scale, seed=0, density=1.0).finalize()
    t1 = time.perf_counter()
    g, maps = type_aware_transform(st)
    t2 = time.perf_counter()
    info = {"scale": scale, "triples": int(st.s.shape[0]),
            "vertices": int(g.n_vertices), "edges": int(g.n_edges),
            "generate_s": t1 - t0, "transform_s": t2 - t1}
    log(f"phase 5: LUBM scale {scale}: {info}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t3 = time.perf_counter()
    eng = SparqlEngine(g, maps)
    torch.cuda.synchronize()
    info["engine_build_s"] = time.perf_counter() - t3

    def timed(fn):
        s = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - s) * 1e3

    queries = {}
    gpu_rows, kinds = {}, {}
    for name, q in LUBM_QUERIES.items():
        res, cold = timed(lambda: eng.query(q))
        before = dict(ops.launches)
        warm = []
        for _ in range(3):
            r2, ms = timed(lambda: eng.query(q))
            warm.append(ms)
            check(r2.count == res.count and np.array_equal(r2.rows, res.rows),
                  f"{name}: warm run differs from cold run")
        per_query = {k: (ops.launches[k] - before[k]) // 3 for k in before}
        cres, count_cold = timed(lambda: eng.query(q, collect="count"))
        count_warm = []
        for _ in range(3):
            c2, ms = timed(lambda: eng.query(q, collect="count"))
            count_warm.append(ms)
            check(c2.count == cres.count, f"{name}: count run differs")
        check(cres.count == res.count,
              f"{name}: count mode {cres.count} != bindings {res.count}")
        rows = res.rows
        check(rows.shape == (res.count, len(res.variables)),
              f"{name}: rows shape {rows.shape}")
        check(bool(((rows >= -1) & (rows < g.n_vertices)).all()),
              f"{name}: row ids outside the vertex range")
        gpu_rows[name] = rows
        kinds[name] = list(res.kinds)
        queries[name] = {"count": int(res.count), "cold_ms": cold,
                         "warm_ms": sorted(warm)[1],
                         "count_cold_ms": count_cold,
                         "count_warm_ms": sorted(count_warm)[1],
                         "launches_per_query": per_query}
        log(f"  {name}: count {res.count} cold {cold:.1f} ms warm "
            f"{sorted(warm)[1]:.1f} ms count-mode warm "
            f"{sorted(count_warm)[1]:.1f} ms launches {per_query}")
    info["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    info["queries"] = queries

    t4 = time.perf_counter()
    cpu = SparqlEngine(g, maps, device="cpu")
    info["cpu_counts"] = {}
    for name, q in LUBM_QUERIES.items():
        want = cpu.query(q)
        info["cpu_counts"][name] = int(want.count)
        check(want.count == queries[name]["count"],
              f"{name}: card count {queries[name]['count']} != "
              f"CPU count {want.count}")
        check(np.array_equal(want.rows, gpu_rows[name]),
              f"{name}: card rows differ from the CPU run")
    info["cpu_check_s"] = time.perf_counter() - t4
    info["cpu_checked"] = list(LUBM_QUERIES)
    log(f"phase 5: all {len(LUBM_QUERIES)} counts and rows equal the CPU "
        f"run; peak device memory {info['peak_device_bytes']} B")
    answers = {name: (kinds[name], gpu_rows[name]) for name in gpu_rows}
    return info, st, (g, maps, eng, cpu), answers


# the capacity graph: hubs typed ub:Hub, each linked to every mid, each mid
# holding its own leaves, so the query below binds hubs x mids x leaves =
# 6,000,000 rows, past the default ExecOpts.max_cap of 2^22
CAP_GRAPH = dict(hubs=2000, mids=100, leaves=30)
CAP_QUERY = ("SELECT ?x ?y ?z WHERE { ?x rdf:type ub:Hub . "
             "?x ub:link ?y . ?y ub:leaf ?z . }")


def run_capacity(torch) -> dict:
    """Phase 5, the capacity bound: on ``CAP_GRAPH`` the default options
    must refuse ``CAP_QUERY`` (its step passes 2^22 rows), and
    ``ExecOpts(max_cap=1 << 23)`` must answer it on the card, every row
    equal to the port's CPU run."""
    from repro_torch.core import ExecOpts, SparqlEngine
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.triples import TripleStore

    hubs, mids, leaves = (CAP_GRAPH[k] for k in ("hubs", "mids", "leaves"))
    st = TripleStore()
    st.add_many((f"ub:Hub{i}", "rdf:type", "ub:Hub") for i in range(hubs))
    st.add_many((f"ub:Hub{i}", "ub:link", f"ub:Mid{j}")
                for i in range(hubs) for j in range(mids))
    st.add_many((f"ub:Mid{j}", "ub:leaf", f"ub:Leaf{j}_{k}")
                for j in range(mids) for k in range(leaves))
    g, maps = type_aware_transform(st.finalize())
    want_rows = hubs * mids * leaves
    try:
        SparqlEngine(g, maps).query(CAP_QUERY)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and "max_cap" in refused,
          f"capacity query: the default max_cap did not refuse it "
          f"({refused})")
    opts = ExecOpts(max_cap=1 << 23)
    t0 = time.perf_counter()
    res = SparqlEngine(g, maps, opts=opts).query(CAP_QUERY)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    want = SparqlEngine(g, maps, opts=opts, device="cpu").query(CAP_QUERY)
    check(res.count == want.count == want_rows,
          f"capacity query: card {res.count}, CPU {want.count}, expected "
          f"{want_rows}")
    check(np.array_equal(res.rows, want.rows),
          "capacity query: card rows differ from the CPU run")
    base = res.stats["exec"]["branches"][0]["base"]
    big = [i for i, r in enumerate(base["step_rows"]) if r > 1 << 22]
    check(bool(big) and all(base["caps"][i] > 1 << 22
                            and base["step_kernels"][i] == "expand_filter"
                            for i in big),
          f"capacity query: no fused step past 2^22 rows ({base})")
    out = {"graph": CAP_GRAPH, "rows": int(res.count), "card_ms": card_ms,
           "refused_at_default": refused,
           **{k: base[k] for k in ("step_rows", "caps", "step_kernels")}}
    log(f"phase 5: capacity query: {res.count} rows at max_cap 2^23 equal "
        f"the CPU run ({card_ms:.1f} ms cold); the default max_cap refused "
        f"it: {refused}")
    return out


# ------------------------------------------------------- query families

# benchmarks/bench_serve.py:137 SAME_SHAPE_TMPL (its start is the constant)
TMPL_F1 = """SELECT ?c ?t WHERE {{
  {c} ub:takesCourse ?c .
  ?t ub:teacherOf ?c .
  ?t ub:worksFor ?d .
}}"""
# tests/test_param_batch.py TMPL_COURSE and TMPL_TWO_CONST
TMPL_F2 = """SELECT ?x WHERE {{
  ?x rdf:type ub:GraduateStudent .
  ?x ub:takesCourse {c} .
}}"""
TMPL_F3 = """SELECT ?x ?y WHERE {{
  ?x rdf:type ub:Student .
  ?x ub:memberOf {d} .
  ?x ub:takesCourse ?y .
  ?y rdf:type ub:Course .
  ?z ub:teacherOf ?y .
  ?z ub:worksFor {d2} .
}}"""
# tests/test_torch_param.py TMPL_CYCLE_Q9 and TMPL_CYCLE_Q2: LUBM Q9 and Q2
# with a hoisted constant; each keeps its triangle, so the batch joins a
# non-tree edge (Q9's through tile_membership, Q2's into a university's
# in-adjacency through edge_exists)
TMPL_F4 = """SELECT ?x ?y ?z WHERE {{
  ?x rdf:type ub:Student .
  ?y rdf:type ub:Faculty .
  ?z rdf:type ub:Course .
  ?x ub:advisor ?y .
  ?y ub:teacherOf ?z .
  ?x ub:takesCourse ?z .
  ?y ub:worksFor {d} .
}}"""
TMPL_F5 = """SELECT ?x ?y ?z WHERE {{
  ?x rdf:type ub:GraduateStudent .
  ?y rdf:type ub:University .
  ?z rdf:type ub:Department .
  ?x ub:memberOf ?z .
  ?z ub:subOrganizationOf ?y .
  ?x ub:undergraduateDegreeFrom ?y .
  {p} ub:headOf ?z .
}}"""
BATCHES = (1, 2, 3, 64)
MISSING = "ub:NoSuchStudent999"


def family_queries(maps, n: int = 64) -> dict[str, list[str]]:
    """``n`` members of each family.  F1's constants are a zipf(0.7) draw
    over the first 512 student terms, seed 0, as
    ``benchmarks/bench_serve.py:_skewed_constants`` draws them, with lane 5
    replaced by a constant missing from the dictionary; F2's are graduate
    courses, F3's departments (half the lanes with d2 = d), F4's
    departments and F5's department heads (each department's first full
    professor), drawn in that order with numpy seed 0."""
    pat = re.compile(r"ub:((Undergraduate|Graduate)Student|GraduateCourse|"
                     r"Dept|FullProfessor0\.Dept)\d")
    pools: dict[str, list[str]] = {"Student": [], "GraduateCourse": [],
                                   "Dept": [], "Chair": []}
    for t in maps.dict.terms.to_str:
        m = pat.match(t)
        if m:
            kind = "Student" if m.group(2) else \
                "Chair" if m.group(1).startswith("Full") else m.group(1)
            if kind != "Student" or len(pools["Student"]) < 512:
                pools[kind].append(t)
    students = pools["Student"]
    weights = [1.0 / (i + 1) ** 0.7 for i in range(len(students))]
    f1 = random.Random(0).choices(students, weights=weights, k=n)
    f1[5] = MISSING
    rng = np.random.default_rng(0)
    courses, depts = pools["GraduateCourse"], pools["Dept"]
    f2 = [courses[i] for i in rng.integers(0, len(courses), size=n)]
    f3 = []
    for i in rng.integers(0, len(depts), size=n):
        d2 = depts[i] if rng.random() < 0.5 else \
            depts[int(rng.integers(0, len(depts)))]
        f3.append((depts[i], d2))
    chairs = pools["Chair"]
    f4 = [depts[i] for i in rng.integers(0, len(depts), size=n)]
    f5 = [chairs[i] for i in rng.integers(0, len(chairs), size=n)]
    return {"F1": [TMPL_F1.format(c=c) for c in f1],
            "F2": [TMPL_F2.format(c=c) for c in f2],
            "F3": [TMPL_F3.format(d=d, d2=d2) for d, d2 in f3],
            "F4": [TMPL_F4.format(d=d) for d in f4],
            "F5": [TMPL_F5.format(p=c) for c in f5]}


def _base_stats(res) -> dict:
    return res.stats["exec"]["branches"][0]["base"]


def _same_answer(got, want, what: str, sort: bool = False,
                 collect: str = "bindings") -> None:
    """Equal counts and, for bindings, equal rows (in order, or sorted
    where the two plans may order them differently)."""
    check(got.count == want.count, f"{what}: {got.count} rows vs "
                                   f"{want.count}")
    if collect == "bindings":
        a, b = got.rows, want.rows
        if sort:
            a, b = np.sort(a, axis=0), np.sort(b, axis=0)
        check(np.array_equal(a, b), f"{what}: rows differ")


def run_params(torch, ops, g, maps, eng, cpu):
    """Phase 5c: the five families on the card through
    ``execute_param_batch`` alone (a batch of one is ``execute_param``).
    Returns the phase's record and ``finish``, which holds every lane
    against its own ``execute_param`` run, the CPU run and the baked query,
    and times the 64 solo runs, outside the params path's launch window."""
    from repro_torch.core import ExecOpts, SparqlEngine
    from repro_torch.serve.fingerprint import parameterize_query

    def timed(fn):
        s_ = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - s_) * 1e3

    t0 = time.perf_counter()
    fams = family_queries(maps)
    info: dict = {"families": {}}
    runs: dict = {}  # (family, lanes, collect) -> the batch's results
    compiled: dict = {}
    for fname, qs in fams.items():
        pqs = [parameterize_query(q) for q in qs]
        consts = [pq.consts for pq in pqs]
        fam = eng.compile_param(pqs[0])
        check(fam is not None, f"{fname}: the shape does not parameterize")
        compiled[fname] = (fam, consts)
        rec = {"n_params": fam.n_params,
               "param_start": fam.plan.start_param_slot >= 0,
               "nontree_steps": sum(1 for st in fam.plan.steps
                                    if st.nontree), "runs": {}}
        for b in BATCHES:
            for collect in ("bindings", "count"):
                before = dict(ops.launches)
                res, ms = timed(lambda: eng.execute_param_batch(
                    fam, consts[:b], collect))
                launches = {k: ops.launches[k] - before[k] for k in before}
                runs[fname, b, collect] = res
                batched = [bool(_base_stats(r).get("batched")) for r in res]
                # a lane rerun alone has run stats but is not batched (a
                # missing constant's lane has no stats)
                reruns = sum(1 for r, bt in zip(res, batched)
                             if not bt and _base_stats(r).get("chunks"))
                rec["runs"][f"{b}/{collect}"] = {
                    "ms": ms, "launches": launches,
                    "batched_lanes": sum(batched), "reruns": reruns,
                    "counts": [int(r.count) for r in res]}
        # warm: the 64-lane batch (its 64 solo runs are timed in finish())
        reps = []
        for _ in range(3):
            before = dict(ops.launches)
            _, ms = timed(lambda: eng.execute_param_batch(fam, consts))
            reps.append((ms, {k: ops.launches[k] - before[k]
                              for k in before}))
        reps.sort(key=lambda x: x[0])
        rec["batch64_ms"] = reps[1][0]
        rec["batch64_launches"] = reps[1][1]
        rec["sequential_fallback"] = \
            rec["runs"]["64/bindings"]["batched_lanes"] == 0
        info["families"][fname] = rec
    # an overflowing lane reruns alone: capacities at a 16th of the
    # estimate, F3's 64 lanes (held against the default engine in finish())
    ovf = SparqlEngine(g, maps, opts=ExecOpts(cap_slack=1 / 16))
    ofam = ovf.compile_param(parameterize_query(fams["F3"][0]))
    ovf_res = ovf.execute_param_batch(ofam, compiled["F3"][1])
    info["batches_s"] = time.perf_counter() - t0

    def finish() -> None:
        t1 = time.perf_counter()
        for fname, qs in fams.items():
            fam, consts = compiled[fname]
            cfam = cpu.compile_param(parameterize_query(qs[0]))
            rec = info["families"][fname]
            for (f, b, collect), res in runs.items():
                if f != fname:
                    continue
                for i, r in enumerate(res):
                    what = f"{fname} B={b} {collect} lane {i}"
                    _same_answer(r, eng.execute_param(fam, consts[i],
                                                      collect),
                                 f"{what} vs its execute_param",
                                 collect=collect)
                    _same_answer(r, cpu.execute_param(cfam, consts[i],
                                                      collect),
                                 f"{what} vs the CPU run", collect=collect)
                    _same_answer(r, eng.query(qs[i], collect=collect),
                                 f"{what} vs the baked query", sort=True,
                                 collect=collect)
                    if collect == "bindings":
                        check(r.rows.shape == (r.count, len(r.variables))
                              and bool(((r.rows >= -1)
                                        & (r.rows < g.n_vertices)).all()),
                              f"{what}: rows of the wrong shape or range")
            check(rec["runs"]["64/bindings"]["counts"][5] == 0
                  or fname != "F1",
                  "F1: the missing constant's lane is not empty")
            # a parameterized step that is fused reads its constant on the
            # device in the solo run (expand_filter_compact's bound id)
            kernels = _base_stats(eng.execute_param(fam, consts[0]))[
                "step_kernels"]
            rec["fused_param_steps"] = sum(
                1 for st, k in zip(fam.plan.steps, kernels)
                if st.param_slot >= 0 and k == "expand_filter")
            check(fname != "F3" or rec["fused_param_steps"] > 0,
                  "F3: no parameterized step ran through the fused kernel")
            solo = sorted(timed(lambda: [eng.execute_param(fam, c)
                                         for c in consts])[1]
                          for _ in range(3))
            rec["solo64_ms"] = solo[1]
            log(f"  {fname}: 64 lanes {rec['batch64_ms']:.1f} ms batched vs "
                f"{rec['solo64_ms']:.1f} ms solo; launches per batch "
                f"{ {k: v for k, v in rec['batch64_launches'].items() if v} };"
                f" batched lanes "
                f"{rec['runs']['64/bindings']['batched_lanes']}/64; "
                f"non-tree steps {rec['nontree_steps']}; sequential fallback "
                f"{rec['sequential_fallback']}")
        check(info["families"]["F4"]["nontree_steps"] > 0
              and info["families"]["F5"]["nontree_steps"] > 0,
              "F4/F5: no non-tree step in the plan")
        # one set of launches per step: a batched family's launches do not
        # grow with its lanes
        flat = [f for f, r in info["families"].items()
                if r["runs"]["64/bindings"]["batched_lanes"]
                and not r["runs"]["64/bindings"]["reruns"]
                and not r["runs"]["2/bindings"]["reruns"]
                and r["runs"]["2/bindings"]["launches"]
                == r["batch64_launches"]
                and sum(r["batch64_launches"].values())]
        check(bool(flat), "no family ran its 64 lanes in one set of "
                          "launches per step")
        info["one_launch_set_families"] = flat
        fam, consts = compiled["F3"]
        rerun = 0
        for i, r in enumerate(ovf_res):
            _same_answer(r, eng.execute_param(fam, consts[i]),
                         f"F3 slack 1/16 lane {i}")
            rerun += "batched" not in _base_stats(r)
        check(rerun > 0, "no F3 lane overflowed at a 16th of the estimate")
        info["overflow_reruns"] = rerun
        info["check_s"] = time.perf_counter() - t1
        info["total_s"] = time.perf_counter() - t0
        log(f"phase 5c: every lane of F1-F5 at B={BATCHES} equals its own "
            f"run, the CPU run and the baked query; {rerun} of 64 F3 lanes "
            f"overflowed and reran alone at slack 1/16; one launch set per "
            f"step: {flat}; {info['total_s']:.1f} s")

    return info, finish


LIVE_MIX = ("Q1", "Q2", "Q6", "Q9", "Q14")  # benchmarks/bench_update.py


def _sub_store(st, rows):
    """A finalized TripleStore of ``st``'s rows ``rows`` (sorted, so still
    deduplicated and in order), sharing ``st``'s dictionary."""
    from repro_torch.rdf.triples import TripleStore

    rows = np.sort(rows)
    return TripleStore(dict=st.dict, s=st.s[rows], p=st.p[rows],
                       o=st.o[rows], _finalized=True)


def _decode(st, rows):
    d = st.dict
    return [(d.term(int(st.s[i])), d.predicate(int(st.p[i])),
             d.term(int(st.o[i]))) for i in rows]


# a chunk program may be new on a later snapshot only where its key
# (``repro_torch.core.exec.ProgramKey``) moved in one of these fields
NEW_PROGRAM_WHY = {"caps": "capacities", "n_in": "input width",
                   "graph": "device graph key (pad bucket)"}
RESUME_WHY = {"table_input": "step window (overflow resume)",
              "start": "step window (overflow resume)",
              "stop": "step window (overflow resume)"}


def _new_programs(before: set, after: set, resumed: bool, what: str) -> list:
    """Why the chunk programs built between two reads of the executor's
    program keys are new: for each, the key fields in which it differs from
    the nearest program built before for the same plan and mode.  A field
    outside ``NEW_PROGRAM_WHY`` (or ``RESUME_WHY`` when the query resumed
    after an overflow) fails the run."""
    allowed = NEW_PROGRAM_WHY | (RESUME_WHY if resumed else {})
    why = set()
    for key in after - before:
        peers = [o for o in before
                 if o.plan == key.plan and o.collect == key.collect]
        check(bool(peers), f"{what}: a chunk program for a plan never run")
        diff = min((frozenset(f for f in key._fields
                              if getattr(key, f) != getattr(o, f))
                    for o in peers), key=len)
        check(bool(diff) and diff <= allowed.keys(),
              f"{what}: a new chunk program whose key moved in "
              f"{sorted(diff)}")
        why |= {allowed[f] for f in diff}
    return sorted(why)


def live_split(st):
    """``benchmarks/bench_update.py:_dataset``'s split of a triple store
    (seed 5), as row numbers: the base keeps every rdf:type /
    rdf:subClassOf triple and 87.5% of the others; the other 12.5% are the
    inserts, and a tenth as many base triples the deletes."""
    from repro_torch.rdf.dictionary import RDF_TYPE, RDFS_SUBCLASSOF

    d = st.dict
    onto = np.isin(st.p, [d.predicate_id(RDF_TYPE),
                          d.predicate_id(RDFS_SUBCLASSOF)])
    plain = np.flatnonzero(~onto)
    rng = np.random.default_rng(5)
    idx = rng.permutation(plain.shape[0])
    n_base = int(plain.shape[0] * (1.0 - 0.125))
    base_rows = np.concatenate([np.flatnonzero(onto), plain[idx[:n_base]]])
    ins_rows = plain[idx[n_base:]]
    del_rows = plain[idx[rng.choice(n_base, size=max(1, len(ins_rows) // 10),
                                    replace=False)]]
    return base_rows, ins_rows, del_rows


def run_live(torch, ops, st, scale: int) -> dict:
    """Phase 5b: the live store at full scale.  The stream follows
    ``benchmarks/bench_update.py:_dataset`` (seed 5) at the id level: the
    base keeps every rdf:type / rdf:subClassOf triple and 87.5% of the
    others; the other 12.5% arrive as inserts in 8 batches with a tenth as
    many deletes of base triples, so the final delta sits near half the
    store's auto-compaction threshold (25% of base edges).  Returns the
    phase's record and ``finish``, which holds the final snapshot against
    the CPU run and the rebuild (outside the live path's launch window),
    ``compacted``, which compacts the store and holds it against the final
    snapshot (after phase 7 has served the store), and what phase 7 hosts:
    the store, its base graph, its maps and the final snapshot's answers
    (name -> (column kinds, rows))."""
    from repro_torch.core import SparqlEngine
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.workloads import LUBM_QUERIES
    from repro_torch.store import VersionedStore, parse_update

    t0 = time.perf_counter()
    base_rows, ins_rows, del_rows = live_split(st)
    ins, dels = _decode(st, ins_rows), _decode(st, del_rows)
    g, maps = type_aware_transform(_sub_store(st, base_rows))
    info = {"scale": scale, "base_triples": int(base_rows.shape[0]),
            "inserts": len(ins), "deletes": len(dels),
            "base_edges": int(g.n_edges), "setup_s": time.perf_counter() - t0}
    log(f"phase 5b: live store base {info['base_triples']} triples "
        f"({g.n_edges} edges), stream {len(ins)} inserts + {len(dels)} "
        f"deletes in 8 batches")

    def timed(fn):
        s_ = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - s_) * 1e3

    store = VersionedStore(g, maps)
    eng = SparqlEngine(store.snapshot(), maps)

    batches = []
    n_b = 8
    for b in range(n_b + 1):
        rec = {"batch": b}
        if b:
            bi = ins[(b - 1) * len(ins) // n_b: b * len(ins) // n_b]
            bd = dels[(b - 1) * len(dels) // n_b: b * len(dels) // n_b]
            s_ = time.perf_counter()
            if b < n_b:
                rec["inserted"] = store.insert_triples(bi)
                rec["deleted"] = store.delete_triples(bd)
                rec["writes_ms"] = (time.perf_counter() - s_) * 1e3
            else:  # the last batch goes through the SPARQL UPDATE parser
                text = ("INSERT DATA { " + " ".join(
                    f"{x} {y} {z} ." for x, y, z in bi) + " } DELETE DATA { "
                    + " ".join(f"{x} {y} {z} ." for x, y, z in bd) + " }")
                t_p = time.perf_counter()
                parsed = parse_update(text)
                rec["parse_ms"] = (time.perf_counter() - t_p) * 1e3
                check([op.triples for op in parsed] == [bi, bd],
                      "UPDATE text does not parse back to its triples")
                out = store.apply_update(text)
                rec["writes_ms"] = (time.perf_counter() - s_) * 1e3
                check(not out["compacted"], "the stream crossed the "
                      "auto-compaction threshold")
                rec["inserted"], rec["deleted"] = out["inserted"], \
                    out["deleted"]
            t_s = time.perf_counter()
            snap = store.snapshot()
            rec["snapshot_ms"] = (time.perf_counter() - t_s) * 1e3
            eng.set_graph(snap)
            rec["ingest_ms"] = (time.perf_counter() - s_) * 1e3
            check(rec["inserted"] == len(bi) and rec["deleted"] == len(bd),
                  f"batch {b}: applied {rec['inserted']} inserts / "
                  f"{rec['deleted']} deletes of {len(bi)} / {len(bd)}")
        rec["delta"] = store.delta_size()
        rec["queries"] = {}
        for name in LIVE_MIX:
            keys = eng.executor.program_keys()
            res, ms = timed(lambda: eng.query(LUBM_QUERIES[name]))
            base = [br["base"] for br in res.stats["exec"]["branches"]]
            compiles = sum(x.get("compiles", 0) for x in base)
            resumes = sum(x.get("resumes", 0) for x in base)
            rec["queries"][name] = {"count": int(res.count), "ms": ms,
                                    "compiles": compiles,
                                    "resumes": resumes,
                                    "kernels": base[0].get("step_kernels")}
            if b >= 2 and compiles:
                why = _new_programs(keys, eng.executor.program_keys(),
                                    resumes > 0, f"batch {b} {name}")
                rec["queries"][name]["new_programs_why"] = why
                log(f"  batch {b} {name}: {compiles} new chunk programs: "
                    f"{', '.join(why)}")
        batches.append(rec)
        log(f"  batch {b}: ingest {rec.get('ingest_ms', 0.0):.1f} ms (writes "
            f"{rec.get('writes_ms', 0.0):.1f}, snapshot "
            f"{rec.get('snapshot_ms', 0.0):.1f}), delta "
            f"{rec['delta']}, " + ", ".join(
                f"{n} {q['count']} in {q['ms']:.1f} ms"
                for n, q in rec["queries"].items()))
    info["batches"] = batches

    # the final snapshot: every query, cold and warm, both modes
    snap = store.snapshot()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    queries, gpu_rows = {}, {}
    for name, q in LUBM_QUERIES.items():
        res, cold = timed(lambda: eng.query(q))
        before = dict(ops.launches)
        warm = []
        for _ in range(3):
            r2, ms = timed(lambda: eng.query(q))
            warm.append(ms)
            check(r2.count == res.count and np.array_equal(r2.rows, res.rows),
                  f"live {name}: warm run differs from cold run")
        per_query = {k: (ops.launches[k] - before[k]) // 3 for k in before}
        cres, count_cold = timed(lambda: eng.query(q, collect="count"))
        count_warm = []
        for _ in range(3):
            c2, ms = timed(lambda: eng.query(q, collect="count"))
            count_warm.append(ms)
            check(c2.count == cres.count, f"live {name}: count run differs")
        check(cres.count == res.count,
              f"live {name}: count mode {cres.count} != bindings {res.count}")
        check(res.rows.shape == (res.count, len(res.variables)) and bool(
            ((res.rows >= -1) & (res.rows < snap.n_vertices)).all()),
            f"live {name}: rows of the wrong shape or range")
        gpu_rows[name] = res.rows
        queries[name] = {
            "count": int(res.count), "cold_ms": cold,
            "column_kinds": list(res.kinds),
            "warm_ms": sorted(warm)[1], "count_cold_ms": count_cold,
            "count_warm_ms": sorted(count_warm)[1],
            "launches_per_query": per_query,
            "kernels": [br["base"].get("step_kernels")
                        for br in res.stats["exec"]["branches"]]}
        log(f"  live {name}: count {res.count} cold {cold:.1f} ms warm "
            f"{sorted(warm)[1]:.1f} ms count-mode warm "
            f"{sorted(count_warm)[1]:.1f} ms launches {per_query}")
    info["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    info["queries"] = queries

    # the F1 family on the final snapshot: one 64-lane batch, held against
    # its members' own runs and against the CPU run in finish()
    from repro_torch.serve.fingerprint import parameterize_query

    pqs = [parameterize_query(q) for q in family_queries(maps)["F1"]]
    fam = eng.compile_param(pqs[0])
    check(fam is not None, "live F1: the shape does not parameterize")
    batch, ms = timed(lambda: eng.execute_param_batch(
        fam, [pq.consts for pq in pqs]))
    batched = [r for r in batch if _base_stats(r).get("batched")]
    check(bool(batched), "live F1: no lane was batched")
    info["family_batch"] = {
        "ms": ms, "counts": [int(r.count) for r in batch],
        "batched_lanes": len(batched),
        "kernels": _base_stats(batched[0]).get("step_kernels")}
    log(f"  live F1 batch of 64: {ms:.1f} ms, {len(batched)} lanes batched, "
        f"step kernels {info['family_batch']['kernels']}")
    info["stream_s"] = time.perf_counter() - t0

    def finish() -> None:
        info["profiles"] = profile_queries(torch, eng)
        # held against the CPU run of the same snapshot: counts and rows
        t1 = time.perf_counter()
        cpu = SparqlEngine(snap, maps, device="cpu")
        for name, q in LUBM_QUERIES.items():
            want = cpu.query(q)
            check(want.count == queries[name]["count"] and
                  np.array_equal(want.rows, gpu_rows[name]),
                  f"live {name}: card answer differs from the CPU run")
        cfam = cpu.compile_param(pqs[0])
        for i, (r, pq) in enumerate(zip(batch, pqs)):
            _same_answer(r, eng.execute_param(fam, pq.consts),
                         f"live F1 lane {i} vs its execute_param")
            _same_answer(r, cpu.execute_param(cfam, pq.consts),
                         f"live F1 lane {i} vs the CPU run")
        info["cpu_check_s"] = time.perf_counter() - t1

        # held against a from-scratch transform of the final triple set
        t2 = time.perf_counter()
        keep = base_rows[~np.isin(base_rows, del_rows)]
        g2, maps2 = type_aware_transform(
            _sub_store(st, np.concatenate([keep, ins_rows])))
        fresh = SparqlEngine(g2, maps2)
        for name, q in LUBM_QUERIES.items():
            n = fresh.count(q)
            check(n == queries[name]["count"],
                  f"live {name}: snapshot count {queries[name]['count']} "
                  f"!= rebuild count {n}")
        info["rebuild_check_s"] = time.perf_counter() - t2
        info["total_s"] = time.perf_counter() - t0

    def compacted() -> None:
        # held against the compacted store (ids survive compaction)
        t3 = time.perf_counter()
        eng.set_graph(store.compact())
        info["compact_s"] = time.perf_counter() - t3
        for name, q in LUBM_QUERIES.items():
            res = eng.query(q)
            check(res.count == queries[name]["count"] and np.array_equal(
                np.sort(res.rows, axis=0), np.sort(gpu_rows[name], axis=0)),
                f"live {name}: compacted answer differs from the snapshot's")
        info["compacted_check_s"] = time.perf_counter() - t3
        log(f"phase 5b: all {len(LUBM_QUERIES)} queries on the final "
            f"snapshot equal the CPU run (rows), the rebuild (counts) and the "
            f"compacted store (rows); peak device memory "
            f"{info['peak_device_bytes']} B; {info['total_s']:.1f} s before "
            f"phase 7, compaction {info['compact_s']:.1f} s")

    answers = {name: (queries[name]["column_kinds"], gpu_rows[name])
               for name in gpu_rows}
    return info, finish, compacted, (store, g, maps, answers)


# ------------------------------------------------------------------- serve

SERVE_WORKERS = 4
SERVE_CLIENTS = 8
SERVE_BATCH_MAX = 64
SERVE_BATCH_WINDOW_MS = 20.0
# the edge phase 7 inserts into the live dataset and deletes again (a
# graduate student taking one more course: the store deletes edges, not
# type triples, so the revert leaves the data as it was), and the query
# that must show the new binding in between
SERVE_UPDATE = "{s} ub:takesCourse {c} ."
SERVE_PROBE = ("SELECT ?x WHERE {{ ?x rdf:type ub:GraduateStudent . "
               "?x ub:takesCourse {c} . }}")
# the replan loop: a plan is replanned after 2 runs whose median worst-step
# q-error passes 1.5, and the loop stops after this many repeats
SERVE_FEEDBACK = dict(feedback_min_runs=2, qerror_threshold=1.5)
SERVE_REPLAN_TRIES = 8


def _renamed(text: str) -> str:
    """An alpha-renamed duplicate: the same query (and fingerprint) with
    every variable renamed."""
    return re.sub(r"\?(\w+)", r"?dup_\1", text)


class Decoder:
    """A result's rows as the multiset of tuples of the terms the server's
    JSON carries (``value``: the term without its quotes; ``None``
    unbound): two results with equal multisets have equal sorted rows."""

    def __init__(self, maps):
        self.maps = maps
        self.terms = np.asarray(maps.dict.terms.to_str, dtype=object)
        self.preds = np.asarray(maps.dict.predicates.to_str, dtype=object)

    def rows(self, kinds, rows) -> list[tuple]:
        cols = []
        for c, kind in enumerate(kinds):
            ids = np.asarray(rows[:, c], np.int64)
            lut, to_term = ((self.terms, self.maps.vertex_to_term)
                            if kind == "vertex"
                            else (self.preds, self.maps.elabel_to_pred))
            terms = lut[to_term[np.maximum(ids, 0)]] if ids.size else []
            cols.append([None if i < 0 else t.strip('"')
                         for i, t in zip(ids.tolist(), list(terms))])
        return Counter(zip(*cols) if cols else [()] * int(rows.shape[0]))


def _served_rows(body: dict) -> Counter:
    head = body["head"]["vars"]
    return Counter(tuple(b[v]["value"] if v in b else None for v in head)
                   for b in body["results"]["bindings"])


def _http(base: str, method: str, path: str, body: str | None = None,
          ctype: str | None = None) -> tuple[int, dict | str, float]:
    """One request: (status, JSON body or text, client-side ms).  An error
    status is returned, not raised, and nothing is retried."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else body.encode(),
        headers={"Content-Type": ctype} if ctype else {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, ctype_out, raw = r.status, r.headers["Content-Type"], \
                r.read()
    except urllib.error.HTTPError as e:
        status, ctype_out, raw = e.code, e.headers["Content-Type"], e.read()
    ms = (time.perf_counter() - t0) * 1e3
    return (status, json.loads(raw) if "json" in (ctype_out or "")
            else raw.decode(), ms)


def _sparql_path(text: str, dataset: str, **params) -> str:
    from urllib.parse import urlencode

    return "/sparql?" + urlencode({"query": text, "dataset": dataset,
                                   **params})


def _in_threads(n: int, work) -> list:
    """Run ``work(k)`` for k < n on n threads released together; returns
    their results and raises the first error one of them raised."""
    import threading

    out: list = [None] * n
    errors: list = []
    start = threading.Barrier(n)

    def run(k):
        try:
            start.wait(timeout=120)
            out[k] = work(k)
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    if errors:
        raise errors[0]
    return out


def _steps(span: dict) -> list[dict]:
    out = [span] if span["name"] == "step" else []
    for c in span.get("children", ()):
        out += _steps(c)
    return out


def run_serve(torch, ops, static, live, card: str) -> dict:
    """Phase 7: the serving path at full scale.  One ``DatasetRegistry`` on
    the card hosts ``lubm`` (phase 5's graph, static) and ``live`` (phase
    5b's store with its final delta, updatable), behind a ``Scheduler``
    (``SERVE_WORKERS`` workers, batches of up to ``SERVE_BATCH_MAX``) and the
    HTTP server on 127.0.0.1, port 0.  Clients send, over HTTP: the error
    cases (504 first, on a query not compiled yet), the 14 LUBM queries to
    both datasets with an alpha-renamed duplicate of each
    (``SERVE_CLIENTS`` threads), phase 5c's 64 F1 members with a duplicate
    of each all at once (so they batch and coalesce), an update that is
    seen and reverted, the feedback loop until a replan, a forced trace,
    and the debug endpoints.  Every answer's count and sorted decoded rows
    equal phase 5's or 5b's answers (F1's: the CPU run's)."""
    from repro_torch.rdf.workloads import LUBM_QUERIES
    from repro_torch.serve.fingerprint import fingerprint_query
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.server import (DatasetRegistry, make_server,
                                          serve_in_thread)

    g, maps, answers, cpu = static
    store, live_g, live_maps, live_answers = live
    t0 = time.perf_counter()
    dec = {"lubm": Decoder(maps), "live": Decoder(live_maps)}
    want = {}
    for ds, ans in (("lubm", answers), ("live", live_answers)):
        for name, (kinds, rows) in ans.items():
            want[ds, name] = dec[ds].rows(kinds, rows)
    f1 = family_queries(maps)["F1"]
    f1_want = {}
    for q in f1:
        if q not in f1_want:
            r = cpu.query(q)
            f1_want[q] = dec["lubm"].rows(r.kinds, r.rows)
    info: dict = {"workers": SERVE_WORKERS, "clients": SERVE_CLIENTS,
                  "batch_max": SERVE_BATCH_MAX,
                  "batch_window_ms": SERVE_BATCH_WINDOW_MS,
                  "expected_s": time.perf_counter() - t0}

    reg = DatasetRegistry(feedback=True, **SERVE_FEEDBACK)
    reg.register("lubm", g, maps)
    reg.register("live", live_g, live_maps, updatable=True, store=store)
    sched = Scheduler(reg, workers=SERVE_WORKERS, max_queue=512,
                      default_timeout_s=300.0, metrics=reg.metrics,
                      batch_max=SERVE_BATCH_MAX,
                      batch_window_ms=SERVE_BATCH_WINDOW_MS)
    srv = make_server(reg, "127.0.0.1", 0, scheduler=sched)
    http_thread = serve_in_thread(srv)
    base = "http://%s:%d" % srv.server_address[:2]
    t_traffic = time.perf_counter()
    try:
        # errors, the deadline first: Q5 is not compiled yet
        codes = {}
        errors = (
            ("deadline", 504, ("GET", _sparql_path(
                LUBM_QUERIES["Q5"], "lubm", timeout_ms=1))),
            ("bad query", 400, ("GET", _sparql_path(
                "SELECT nonsense {{{", "lubm"))),
            ("unknown dataset", 404, ("GET", _sparql_path(
                LUBM_QUERIES["Q1"], "nope"))),
            ("unknown endpoint", 404, ("GET", "/bogus")),
            ("static update", 409, ("POST", "/update?dataset=lubm",
                                    "INSERT DATA { ub:a ub:p ub:b . }",
                                    "application/sparql-update")),
            ("bad update", 400, ("POST", "/update?dataset=live",
                                 "DELETE WHERE { ?s ?p ?o }",
                                 "application/sparql-update")))
        for what, want_code, args in errors:
            status, body, _ = _http(base, *args)
            check(status == want_code and "error" in body,
                  f"phase 7: {what}: status {status}, want {want_code}")
            codes[what] = status
        info["error_codes"] = codes

        # the 14 queries to both datasets, each with a renamed duplicate
        work = [(ds, name, dup) for ds in ("lubm", "live")
                for name in LUBM_QUERIES for dup in (False, True)]

        def client(k):
            out = []
            for ds, name, dup in work[k::SERVE_CLIENTS]:
                text = LUBM_QUERIES[name]
                status, body, ms = _http(base, "GET", _sparql_path(
                    _renamed(text) if dup else text, ds))
                check(status == 200, f"phase 7: {ds} {name}: status "
                                     f"{status}: {body}")
                rows = _served_rows(body)
                n_want = want[ds, name].total()
                check(body["stats"]["count"] == n_want
                      and rows == want[ds, name],
                      f"phase 7: {ds} {name}{' (renamed)' if dup else ''}: "
                      f"{body['stats']['count']} rows differ from phase "
                      f"{'5' if ds == 'lubm' else '5b'}'s {n_want}")
                out.append(ms)
            return out

        t1 = time.perf_counter()
        mix_ms = sum(_in_threads(SERVE_CLIENTS, client), [])
        info["mix"] = {"requests": len(work),
                       "s": time.perf_counter() - t1,
                       "client_ms_max": max(mix_ms)}
        log(f"phase 7: {len(work)} LUBM requests (14 queries x 2 datasets x "
            f"2 names) from {SERVE_CLIENTS} clients equal phases 5 and 5b "
            f"in {info['mix']['s']:.1f} s")

        # F1's 64 members and a renamed duplicate of each, all at once
        burst = []
        for q in f1:
            burst += [q, _renamed(q)]

        def member(k):
            q = burst[k]
            status, body, _ = _http(base, "POST", "/sparql", json.dumps(
                {"query": q, "dataset": "lubm"}), "application/json")
            check(status == 200, f"phase 7: F1 member {k}: status {status}")
            orig = f1[k // 2]
            check(_served_rows(body) == f1_want[orig],
                  f"phase 7: F1 member {k} differs from the CPU run")
            return body["stats"]["count"]

        t1 = time.perf_counter()
        _in_threads(len(burst), member)
        batches = reg.journal.snapshot(kind="batch")
        sizes = [e["size"] for e in batches if e.get("parameterized")]
        check(any(n >= 2 for n in sizes),
              f"phase 7: no parameterized batch of 2 or more: {sizes}")
        coalesced = reg.metrics.coalesced.total()
        check(coalesced > 0, "phase 7: no request coalesced")
        info["burst"] = {"requests": len(burst),
                         "s": time.perf_counter() - t1,
                         "parameterized_batch_sizes": sorted(sizes),
                         "coalesced": coalesced}
        log(f"phase 7: F1 burst of {len(burst)}: parameterized batches "
            f"{sorted(sizes, reverse=True)[:8]}, coalesced {coalesced}")

        # an update on live, seen and then reverted
        terms = live_maps.dict.terms.to_str
        course = next(t for t in terms
                      if re.match(r"ub:GraduateCourse\d", t))
        probe = _sparql_path(SERVE_PROBE.format(c=course), "live")
        status, before, _ = _http(base, "GET", probe)
        check(status == 200, f"phase 7: probe status {status}")
        taking = set(_served_rows(before))
        student = next(t for t in terms
                       if re.match(r"ub:GraduateStudent\d", t)
                       and (t,) not in taking)
        edge = SERVE_UPDATE.format(s=student, c=course)
        status, up, _ = _http(base, "POST", "/update?dataset=live",
                              f"INSERT DATA {{ {edge} }}",
                              "application/sparql-update")
        check(status == 200 and up["inserted"] == 1,
              f"phase 7: insert: {status} {up}")
        status, seen, _ = _http(base, "GET", probe)
        check(status == 200 and _served_rows(seen)
              == _served_rows(before) + Counter([(student,)]),
              "phase 7: the inserted binding is not served")
        status, down, _ = _http(base, "POST", "/update", json.dumps(
            {"dataset": "live", "update": f"DELETE DATA {{ {edge} }}"}),
            "application/json")
        check(status == 200 and down["deleted"] == 1,
              f"phase 7: delete: {status} {down}")
        status, after, _ = _http(base, "GET", probe)
        check(status == 200 and _served_rows(after) == _served_rows(before),
              "phase 7: the reverted probe differs from before the insert")
        for name in ("Q2", "Q9"):
            status, body, _ = _http(base, "GET", _sparql_path(
                LUBM_QUERIES[name], "live"))
            check(status == 200 and _served_rows(body) == want["live", name],
                  f"phase 7: live {name} after the revert differs")
        info["update"] = {"edge": edge,
                          "probe_count": before["stats"]["count"],
                          "inserted": up, "deleted": down}
        log(f"phase 7: live update: probe {before['stats']['count']} -> "
            f"{seen['stats']['count']} -> {after['stats']['count']} rows, "
            f"version {down['version']}")

        # feedback: repeat a misestimated, not yet replanned solo shape
        # until the registry replans it
        names = {fingerprint_query(q): n for n, q in LUBM_QUERIES.items()}
        profiles = [p for p in reg.workload.snapshot(limit=None)
                    if p["dataset"] == "lubm" and p["plan_key"] in names
                    and not p["replans"]
                    and p["q_error_median"] > SERVE_FEEDBACK[
                        "qerror_threshold"]]
        replans_before = len(reg.journal.snapshot(kind="replan"))
        fb = {"replans_in_mix": replans_before}
        if profiles:
            fp = profiles[0]["plan_key"]
            name = names[fp]
            fb.update(query=name, q_error_median=profiles[0]["q_error_median"])
            for tries in range(1, SERVE_REPLAN_TRIES + 1):
                status, body, _ = _http(base, "GET", _sparql_path(
                    LUBM_QUERIES[name], "lubm"))
                check(status == 200 and _served_rows(body) ==
                      want["lubm", name],
                      f"phase 7: {name} differs during the feedback loop")
                if any(e["fingerprint"] == fp
                       for e in reg.journal.snapshot(kind="replan")):
                    break
            replanned = [e for e in reg.journal.snapshot(kind="replan")
                         if e["fingerprint"] == fp]
            check(bool(replanned), f"phase 7: {name} was not replanned in "
                                   f"{SERVE_REPLAN_TRIES} repeats")
            status, body, _ = _http(base, "GET", _sparql_path(
                LUBM_QUERIES[name], "lubm"))
            check(status == 200 and _served_rows(body) == want["lubm", name],
                  f"phase 7: {name} differs after its replan")
            prof = [p for p in reg.workload.snapshot(limit=None)
                    if p["dataset"] == "lubm" and p["plan_key"] == fp]
            fb.update(tries=tries, replan=replanned[0],
                      search=prof[0]["search"])
        check(len(reg.journal.snapshot(kind="replan")) > 0,
              "phase 7: the feedback loop never replanned")
        info["feedback"] = fb
        log(f"phase 7: feedback: {fb}")

        # one forced trace over HTTP, one through the scheduler itself
        status, body, _ = _http(base, "GET", _sparql_path(
            LUBM_QUERIES["Q9"], "lubm", trace=1))
        check(status == 200 and body["trace"]["profiled"]
              and _served_rows(body) == want["lubm", "Q9"],
              f"phase 7: forced trace: status {status}")
        http_steps = _steps(body["trace"]["root"])
        res = sched.submit("lubm", LUBM_QUERIES["Q2"], trace=True)
        kernels = [k for br in res.stats["exec"]["branches"]
                   for k in br["base"]["step_kernels"]]
        steps = _steps(res.stats["trace"]["root"])
        check([s["meta"]["kernel"] for s in steps] == kernels,
              f"phase 7: traced step kernels {steps} != {kernels}")
        for s in steps + http_steps:
            check(s["meta"]["model_ms"] > 0 and s["dur_ms"] > 0,
                  f"phase 7: a traced step without model or time: {s}")
        info["trace"] = {"http_steps": [s["meta"] for s in http_steps],
                         "steps": [{**s["meta"], "dur_ms": s["dur_ms"]}
                                   for s in steps]}
        log(f"phase 7: forced traces: Q9 over HTTP "
            f"{[s['meta']['kernel'] for s in http_steps]}, Q2 "
            + ", ".join(f"{s['meta']['kernel']} {s['dur_ms']:.3f} ms "
                        f"(model {s['meta']['model_ms']:.4f})"
                        for s in steps))

        # the debug endpoints
        status, health, _ = _http(base, "GET", "/healthz")
        check(status == 200 and set(health["datasets"]) == {"lubm", "live"}
              and "store" in health["datasets"]["live"],
              f"phase 7: /healthz {status}")
        status, text, _ = _http(base, "GET", "/metrics")
        metrics = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                   for ln in text.splitlines() if ln and ln[0] != "#"}
        check(status == 200 and metrics["repro_coalesced_total"] > 0,
              "phase 7: /metrics shows no coalesced request")
        status, workload, _ = _http(base, "GET", "/debug/workload?limit=100")
        check(status == 200 and workload["profiles"],
              f"phase 7: /debug/workload {status}")
        status, slow, _ = _http(base, "GET", "/debug/slow")
        check(status == 200 and slow["slow"]["lubm"],
              f"phase 7: /debug/slow {status}")
        status, probes, _ = _http(base, "GET",
                                  "/debug/decisions?kind=small_probe&"
                                  "limit=1000")
        check(status == 200, f"phase 7: /debug/decisions {status}")
        info["small_probe"] = [
            {k: e.get(k) for k in ("dataset", "fingerprint", "legacy_wins",
                                   "t_pipelined_ms", "t_legacy_ms")}
            for e in probes["decisions"]]
        info["decisions"] = workload["decisions"]
        info["replans"] = reg.journal.snapshot(kind="replan")
    finally:
        srv.shutdown()
        sched.stop()
        srv.server_close()
        http_thread.join(timeout=60)
    check(not http_thread.is_alive(), "phase 7: the HTTP thread hung")
    traffic_s = time.perf_counter() - t_traffic
    lat = reg.metrics.latency
    n = int(reg.metrics.requests.total())
    info.update(requests=n, traffic_s=traffic_s, qps=n / traffic_s,
                p50_ms=lat.percentile(50), p99_ms=lat.percentile(99),
                card=card, total_s=time.perf_counter() - t0)
    log(f"phase 7: {card}: {n} requests in {traffic_s:.2f} s, "
        f"{n / traffic_s:.2f} QPS, p50 {info['p50_ms']:.3f} ms, p99 "
        f"{info['p99_ms']:.3f} ms (the scheduler's latency histogram); "
        f"small-plan probe verdicts {len(info['small_probe'])}")
    return info


# ----------------------------------------------------------------- sharded

# the reference's mesh axes; (c)'s gloo ranks, which share the one card
MESH_AXES = ("pod", "data", "model")
SHARED_RANKS = 2
# (b): a one-label random graph the size of LUBM 1000 (its vertices and
# edges), dealt to engine_chunk_step in chunks of STEP_CHUNK starting
# vertices at capacity STEP_CAP (about 2.8 times the rows a chunk's third
# step expects at a mean out-degree of 2.24)
RANDOM_GRAPH = dict(vertices=2_641_315, edges=5_926_720, seed=0)
STEP_CHUNK = 1 << 16
STEP_CAP = 1 << 21


def lubm_plans(g, maps, device) -> dict:
    """Each LUBM query's plan (its basic graph pattern, the reference's
    sharded test's way), those with steps only."""
    from repro_torch.core import build_plan, build_query_graph
    from repro_torch.rdf.sparql import parse_sparql
    from repro_torch.rdf.workloads import LUBM_QUERIES

    plans = {}
    for name, text in LUBM_QUERIES.items():
        q = build_query_graph(parse_sparql(text).where.triples, maps)
        plan = build_plan(g, q, device=device)
        if plan.steps:
            plans[name] = plan
    return plans


def path_graph(n: int, m: int, seed: int):
    """A random graph with one edge label and every vertex labeled 0, and
    the path plan ``x0 -> x1 -> x2 -> x3`` in its forced forward order,
    the shape ``engine_chunk_step`` runs (the reference test's)."""
    from repro_torch.core import build_plan
    from repro_torch.core.query import QEdge, QueryGraph, QVertex
    from repro_torch.rdf.graph import LabeledGraph

    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    g = LabeledGraph.build(n, src, np.zeros(m, np.int64), dst, 1, [(0,)] * n,
                           1)
    q = QueryGraph()
    for i in range(4):
        q.vertices.append(QVertex(f"v{i}", labels=(0,)))
        q.var_to_vertex[f"v{i}"] = i
    q.edges = [QEdge(0, 1, 0), QEdge(1, 2, 0), QEdge(2, 3, 0)]
    return g, build_plan(g, q, estimate="static", force_order=[0, 1, 2, 3],
                         device="cpu")


class _Warnings(logging.Handler):
    """Counts the warnings a logger emits (``run_sharded``'s overflow)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.n = 0

    def emit(self, record) -> None:
        self.n += 1


def reference_partition(n_shards: int, candidates, degree):
    """The reference's ``GreedyChunker.partition``, verbatim (a Python
    argmin a candidate): phase 8 holds the port's chunker to it and times
    both at (a)'s largest candidate set."""
    est = degree[candidates].astype(np.float64) + 1.0
    order = np.argsort(-est)  # heaviest first
    loads = np.zeros(n_shards)
    shard_of = np.zeros(candidates.shape[0], dtype=np.int32)
    for idx in order:
        s = int(np.argmin(loads))
        shard_of[idx] = s
        loads[s] += est[idx]
    shards = [candidates[shard_of == s] for s in range(n_shards)]
    width = max(1, max(s.shape[0] for s in shards))
    out = np.full((n_shards, width), -1, dtype=np.int32)
    counts = np.zeros(n_shards, dtype=np.int32)
    for s, arr in enumerate(shards):
        out[s, : arr.shape[0]] = arr
        counts[s] = arr.shape[0]
    return out, counts, loads


def host_ops(prof) -> dict[str, tuple[float, int]]:
    """Each operation's self host time (us) and calls in a profile."""
    return {e.key: (e.self_cpu_time_total, e.count)
            for e in prof.key_averages()}


def profile_gap(torch, sharded, host) -> dict:
    """One warm ``run_sharded`` and one warm ``Executor.run`` of a query
    under ``torch.profiler`` (a first profiled run of each is dropped):
    each one's window, device busy time and kernels, and the host
    operations whose self time grew most from the second to the first."""
    from torch.profiler import ProfilerActivity, profile

    out, ops_of = {}, {}
    for label, fn in (("run_sharded", sharded), ("executor", host)):
        for _ in range(2):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        out[label] = {"window_us": window_us,
                      "device_us": sum(e.time_range.elapsed_us()
                                       for e in dev),
                      "device_events": len(dev)}
        ops_of[label] = host_ops(prof)
    grew = []
    for name, (us, n) in ops_of["run_sharded"].items():
        was, m = ops_of["executor"].get(name, (0.0, 0))
        grew.append((us - was, name, n, m))
    out["host_ops_grown"] = [
        {"op": name, "self_us_more": d, "calls": n, "executor_calls": m}
        for d, name, n, m in sorted(grew, reverse=True)[:8]]
    return out


def plain_kernels(ref) -> dict:
    """Each engine kernel's plain PyTorch version."""
    return {"expand_filter_compact": ref.expand_filter_compact_ref,
            "edge_exists": ref.edge_exists_ref,
            "tile_membership": ref.tile_membership_ref,
            "bitmap_superset": ref.bitmap_superset_ref,
            "signature_filter": ref.signature_filter_ref,
            "delta_merge": ref.delta_merge_ref}


def sharded_phase(torch, ops, ref, static, full: dict, card: str):
    """Phase 8: sharded execution, in three parts.  Set-up, run here: (c)
    two gloo ranks in subprocesses share the card at parity scale while
    the host builds (b)'s graph; the plans, ``Executor.run``'s counts and
    warm times, and a world-size-1 NCCL group and its mesh.  ``drive``,
    the launch window's whole content: (a) every LUBM query with steps
    through ``run_sharded`` (cold, then three warm), and (b)
    ``engine_chunk_step`` over the random graph's start candidates (two
    sweeps, then chunk 0).  ``finish(rec)``, after the window: every count
    against ``Executor.run`` and phase 5's CPU count, chunk 0 against its
    CPU run, each kernel's largest call in the window (``rec``) against
    its plain version, the gap between ``run_sharded`` and
    ``Executor.run`` under ``torch.profiler``, and the port's chunker
    against the reference's loop.  Returns ``(drive, finish)``."""
    import threading

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import (Executor, GreedyChunker, engine_chunk_step,
                                  run_sharded)
    from repro_torch.core import distributed as tdist
    from repro_torch.launch.sharded import free_port, spawn_ranks
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.rdf.transform import type_aware_transform

    g, maps, eng, _ = static
    t0 = time.perf_counter()
    info = {"card": card}

    # (c) ranks share one card: the parity-scale graph's plans and host
    # counts here, the ranks' run_sharded in subprocesses
    g8, maps8 = type_aware_transform(
        generate_lubm(scale=8, seed=0, density=0.6).finalize())
    plans8 = lubm_plans(g8, maps8, "cuda")
    ex8 = Executor(g8)
    host8 = {k: ex8.run(p, collect="count").count for k, p in plans8.items()}
    ranks: dict = {}

    def run_ranks():
        try:
            ranks["outs"] = spawn_ranks(g8, plans8, SHARED_RANKS,
                                        (1, SHARED_RANKS, 1), "cuda",
                                        backend="gloo", timeout=300)
        except Exception as e:  # noqa: BLE001 - reported by check below
            ranks["error"] = f"{type(e).__name__}: {e}"

    t_c = time.perf_counter()
    thread = threading.Thread(target=run_ranks, name="sharded-ranks")
    thread.start()
    t_b = time.perf_counter()
    bg, bplan = path_graph(RANDOM_GRAPH["vertices"], RANDOM_GRAPH["edges"],
                           RANDOM_GRAPH["seed"])
    info["step_graph_build_s"] = time.perf_counter() - t_b
    thread.join(timeout=360)
    check(not thread.is_alive(), "phase 8 (c): the ranks' thread hung")
    check("error" not in ranks, f"phase 8 (c): {ranks.get('error')}")
    for out in ranks["outs"]:
        check(out["counts"] == host8,
              f"phase 8 (c): rank {out['rank']} counts {out['counts']} != "
              f"the host counts {host8}")
    info["shared_card"] = {
        "check": "ranks share one card", "ranks": SHARED_RANKS,
        "mesh": [1, SHARED_RANKS, 1], "backend": "gloo", "counts": host8,
        "rank_ms": [out["ms"] for out in ranks["outs"]],
        "wall_s": time.perf_counter() - t_c}
    log(f"phase 8 (c), ranks share one card (verifies nothing multi-card): "
        f"{SHARED_RANKS} gloo ranks, mesh (1, {SHARED_RANKS}, 1), LUBM 8: "
        f"counts equal Executor.run's {host8}")
    del g8, maps8, plans8, ex8

    # (b)'s inputs and the executor's count of the path plan
    host_b = Executor(bg).run(bplan, collect="count").count
    cands = bplan.start_candidates
    n_chunks = -(-cands.shape[0] // STEP_CHUNK)
    padded = np.full(n_chunks * STEP_CHUNK, -1, np.int32)
    padded[: cands.shape[0]] = cands
    lens = [min(STEP_CHUNK, cands.shape[0] - i * STEP_CHUNK)
            for i in range(n_chunks)]
    step_args = [np.ascontiguousarray(bg.out.nbr_el, np.int32),
                 np.stack([bg.out.indptr_el[0]] * 3).astype(np.int32),
                 bg.label_bitmap.view(np.int32)]
    nbr, iptr, bm = (torch.from_numpy(a).cuda() for a in step_args)
    chunks = torch.from_numpy(padded.reshape(n_chunks, STEP_CHUNK)).cuda()
    del bg, bplan

    # (a)'s plans and Executor.run's counts and warm times on the card
    ex = eng.executor
    plans = lubm_plans(g, maps, "cuda")
    queries = {}
    for name, plan in plans.items():
        host = ex.run(plan, collect="count").count
        host_ms = []
        for _ in range(3):
            s = time.perf_counter()
            ex.run(plan, collect="count")
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - s) * 1e3)
        queries[name] = {"executor_count": host,
                         "executor_ms": sorted(host_ms)[1],
                         "start_candidates": int(plan.start_candidates
                                                 .shape[0])}
    warned = _Warnings()
    tdist.log.addHandler(warned)
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=MESH_AXES)
    got: dict = {}

    def sweep():
        total = torch.zeros((), dtype=torch.int64, device="cuda")
        ovf = torch.zeros((), dtype=torch.bool, device="cuda")
        for i in range(n_chunks):
            c, o = engine_chunk_step(nbr, iptr, bm, chunks[i], lens[i],
                                     cap=STEP_CAP, n_steps=3)
            total += c
            ovf |= o
        return int(total), bool(ovf)

    def drive() -> None:
        """(a) and (b): only ``run_sharded`` and ``engine_chunk_step``."""
        for name, plan in plans.items():
            n_warn = warned.n
            q = queries[name]
            q["count"] = run_sharded(ex, plan, mesh)
            sharded_ms = []
            for _ in range(3):
                s = time.perf_counter()
                again = run_sharded(ex, plan, mesh)
                sharded_ms.append((time.perf_counter() - s) * 1e3)
                check(again == q["count"], f"phase 8 (a): {name} differs "
                                           f"warm")
            q["sharded_ms"] = sorted(sharded_ms)[1]
            q["overflowed"] = warned.n > n_warn
        got["sweep"] = sweep()
        s = time.perf_counter()
        got["sweep2"] = sweep()
        got["sweep_s"] = time.perf_counter() - s
        c, o = engine_chunk_step(nbr, iptr, bm, chunks[0], lens[0],
                                 cap=STEP_CAP, n_steps=3)
        got["chunk0"] = (int(c), bool(o))

    def finish(rec) -> dict:
        try:
            return checks(rec)
        finally:
            dist.destroy_process_group()
            tdist.log.removeHandler(warned)

    def checks(rec) -> dict:
        for name, q in queries.items():
            want = full["cpu_counts"][name]
            check(q["count"] == q["executor_count"] == want,
                  f"phase 8 (a): {name}: run_sharded {q['count']}, "
                  f"Executor.run {q['executor_count']}, phase 5's CPU "
                  f"count {want}")
            log(f"phase 8 (a) {card}: {name}: count {q['count']} "
                f"run_sharded {q['sharded_ms']:.3f} ms, Executor.run "
                f"{q['executor_ms']:.3f} ms (warm medians)"
                + (" (overflowed: host loop)" if q["overflowed"] else ""))
        info["nccl"] = {"mesh": [1, 1, 1], "queries": queries}

        total, ovf = got["sweep"]
        check(got["sweep2"] == got["sweep"], "phase 8 (b): a second sweep "
                                             "differs")
        check(not ovf and total == host_b,
              f"phase 8 (b): engine_chunk_step total {total} (overflow "
              f"{ovf}) != Executor.run {host_b}")
        one_cpu = engine_chunk_step(*(torch.from_numpy(a) for a in step_args),
                                    torch.from_numpy(padded[:STEP_CHUNK]),
                                    lens[0], cap=STEP_CAP, n_steps=3)
        check(got["chunk0"] == (int(one_cpu[0]), bool(one_cpu[1])),
              f"phase 8 (b): chunk 0 on the card {got['chunk0']} != on the "
              f"CPU {one_cpu}")
        info["chunk_step"] = {
            "graph": RANDOM_GRAPH, "start_candidates": int(cands.shape[0]),
            "chunk": STEP_CHUNK, "cap": STEP_CAP, "chunks": n_chunks,
            "count": total, "chunk0_count": got["chunk0"][0],
            "ms_per_chunk": got["sweep_s"] / n_chunks * 1e3}
        log(f"phase 8 (b) {card}: engine_chunk_step over {n_chunks} chunks "
            f"of {STEP_CHUNK}: {total} paths equal Executor.run, "
            f"{info['chunk_step']['ms_per_chunk']:.3f} ms per chunk (warm "
            f"sweep, host clock); chunk 0 {got['chunk0'][0]} equals its CPU "
            f"run")

        # each kernel's largest call in the window against its plain
        # version, bit for bit (engine_chunk_step's are 2^21 slots)
        plains = plain_kernels(ref)
        info["largest_calls"] = {}
        for name in PATH_KERNELS["sharded"]:
            check(name in rec.calls, f"phase 8: no {name} call recorded")
            rows, args, kw = rec.calls[name]
            err = max_abs_err(torch, getattr(ops, name)(*args, **kw),
                              plains[name](*args, **kw))
            check(err == 0, f"phase 8: {name} differs from its plain "
                            f"version at the sharded path's largest call "
                            f"{rows}")
            info["largest_calls"][name] = {"rows": list(rows),
                                           "max_abs_err": err}
        log(f"phase 8: the largest call of each kernel in the window equals "
            f"its plain version: {info['largest_calls']}")

        # where a one-chunk query's extra time goes: the three largest gaps
        gaps = sorted((q["sharded_ms"] - q["executor_ms"], name)
                      for name, q in queries.items() if not q["overflowed"])
        info["gap_profiles"] = {}
        for _, name in gaps[-3:]:
            plan = plans[name]
            prof = profile_gap(torch, lambda: run_sharded(ex, plan, mesh),
                               lambda: ex.run(plan, collect="count"))
            d = GreedyChunker(1)
            cand = plan.start_candidates
            part = []
            for _ in range(5):
                s = time.perf_counter()
                d.partition(cand, ex.graph.out.degree)
                part.append((time.perf_counter() - s) * 1e3)
            prof["partition_ms"] = sorted(part)[2]
            info["gap_profiles"][name] = prof
            log(f"phase 8 (a) {card}: {name} profiled: run_sharded window "
                f"{prof['run_sharded']['window_us']:.0f} us, device "
                f"{prof['run_sharded']['device_us']:.0f} us; Executor.run "
                f"{prof['executor']['window_us']:.0f} us, device "
                f"{prof['executor']['device_us']:.0f} us; partition "
                f"{prof['partition_ms']:.3f} ms; host ops grown most: "
                + ", ".join(f"{o['op']} +{o['self_us_more']:.0f} us "
                            f"({o['calls']} vs {o['executor_calls']})"
                            for o in prof["host_ops_grown"][:4]))

        # the port's chunker against the reference's loop at (a)'s largest
        # candidate set
        big = max(plans, key=lambda k: plans[k].start_candidates.shape[0])
        cand, deg = plans[big].start_candidates, ex.graph.out.degree
        info["chunker"] = {"query": big, "candidates": int(cand.shape[0])}
        for n in (1, 8):
            s = time.perf_counter()
            want = reference_partition(n, cand, deg)
            loop_ms = (time.perf_counter() - s) * 1e3
            s = time.perf_counter()
            mine = GreedyChunker(n).partition(cand, deg)
            port_ms = (time.perf_counter() - s) * 1e3
            for a, b in zip(mine, want):
                check(a.dtype == b.dtype and np.array_equal(a, b),
                      f"phase 8: GreedyChunker({n}) differs from the "
                      f"reference's loop on {big}'s candidates")
            info["chunker"][f"shards_{n}"] = {"reference_loop_ms": loop_ms,
                                              "port_ms": port_ms}
            log(f"phase 8 (a): partition of {big}'s {cand.shape[0]} "
                f"candidates over {n} shard(s): the reference's loop "
                f"{loop_ms:.3f} ms, the port's {port_ms:.3f} ms (host "
                f"clock; equal outputs)")
        info["total_s"] = time.perf_counter() - t0
        log(f"phase 8: {info['total_s']:.1f} s")
        return info

    return drive, finish


def profile_queries(torch, eng) -> dict:
    """Phases 5 and 5b, outside the launch windows: the CUDA kernels one
    warm run of each of ``PROFILED`` launches on ``eng``, and the device's
    busy share of its window (``profile_query``; a first profiled run
    warms the profiler up and is dropped)."""
    from repro_torch.rdf.workloads import LUBM_QUERIES

    out = {}
    for name in PROFILED:
        q = LUBM_QUERIES[name]
        profile_query(torch, lambda: eng.query(q))
        out[name] = profile_query(torch, lambda: eng.query(q))
        p = out[name]
        log(f"  {name} warm: {p['cuda_kernels']} CUDA kernels, "
            f"{p['copies_fills']} copies / fills, device busy "
            + ("not measured" if p["device_busy_share"] is None else
               f"{p['device_busy_share']:.3f}")
            + f" of {p['window_us']:.0f} us")
    return out


def kernel_table(torch, ops, ref, rec: Recorder,
                 by_path: dict[str, dict]) -> list:
    """Phase 6: each kernel at the main path's largest shapes.
    ``by_path`` holds each path's launch counts."""
    plains = plain_kernels(ref)

    def timed_call(name, rows, args, kw) -> dict:
        kern = getattr(ops, name)
        got = kern(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, plains[name](*args, **kw))
        check(err == 0, f"{name}: kernel differs from its plain version at "
                        f"the main path's shapes {rows}")
        byts, nops, by = bound(torch, ref, name, args, kw)
        out = {"shape_rows": rows, "max_abs_err": err,
               "ms": time_ms(torch, lambda: kern(*args, **kw)),
               "host_ms": host_ms(torch, lambda: kern(*args, **kw)),
               "plain_ms": time_ms(torch, lambda: plains[name](*args, **kw)),
               "bound_ms": max(byts / PEAK_BYTES_S,
                               nops / PEAK_OPS_S) * 1e3,
               "bound_by": by, "bytes": byts, "ops": nops,
               "shapes": [list(a.shape) for a in args
                          if isinstance(a, torch.Tensor)]}
        gathered = {"signature_filter": lambda: (args[0], args[1], args[2]),
                    "bitmap_superset": lambda: (args[0], kw.get("ids"),
                                                args[1])}.get(name)
        if gathered is not None and gathered()[1] is not None:
            # the card moves 32-byte sectors: the rows' distinct sectors, and
            # the time they take at the peak rate beside the ids and the out
            table, v, req = gathered()
            sectors = row_sectors(torch, table, v)
            out["sectors"] = sectors
            out["sector_ms"] = (32 * sectors + 4 * v.shape[0] + v.shape[0]
                                + 4 * req.shape[0]) / PEAK_BYTES_S * 1e3
        if kw.get(FUSED_GATHERS.get(name)) is not None:
            # the same work in the TPU contract's form (inputs gathered
            # beforehand), and the segment as the engine ran it before:
            # the gathers, then the contract-form kernel
            cargs, ckw = contract_call(torch, name, args, kw)
            check(max_abs_err(torch, contract_out(name, kern(*cargs, **ckw)),
                              got) == 0,
                  f"{name}: the contract form differs from the fused form "
                  f"at {rows}")
            c_byts, c_ops, _ = bound(torch, ref, name, cargs, ckw)
            out["contract_ms"] = time_ms(torch, lambda: kern(*cargs, **ckw))
            out["contract_bound_ms"] = max(c_byts / PEAK_BYTES_S,
                                           c_ops / PEAK_OPS_S) * 1e3
            out["unfused_ms"] = time_ms(
                torch, unfused_segment(torch, kern, name, args, kw))
        log(f"phase 6: {name}: rows {rows} kernel {out['ms']:.4f} ms (host "
            f"{out['host_ms']:.4f} ms per call) plain "
            f"{out['plain_ms']:.4f} ms bound {out['bound_ms']:.4f} ms"
            + (f" ({out['sectors']} sectors: {out['sector_ms']:.4f} ms)"
               if "sectors" in out else "")
            + (f"; contract form {out['contract_ms']:.4f} ms (bound "
               f"{out['contract_bound_ms']:.4f}), gathers + contract form "
               f"{out['unfused_ms']:.4f} ms" if "contract_ms" in out else ""))
        return out

    table = []
    floor = launch_floor_ms(torch)
    log(f"phase 6: one launch of a one-element fill: {floor:.4f} ms")
    for name in ENGINE_KERNELS:
        check(name in rec.calls, f"{name}: no call recorded on the main path")
        rows, args, kw = rec.calls[name]
        if name == "delta_merge":  # slots, then the valid ones
            rows = (*rows, int(args[9].sum().item()))
        source, replaces = KERNEL_INFO[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": sum(int(c[name]) for c in by_path.values()),
               "launches_by_path": {p: int(c[name])
                                    for p, c in by_path.items()},
               "library_ms": None, **timed_call(name, rows, args, kw)}
        if name in SMALLEST:
            row["smallest"] = timed_call(name, *rec.smallest[name])
            row["launch_floor_ms"] = floor
        table.append(row)
    return table


def launch_floor_ms(torch) -> float:
    """The device time of one launch that does almost nothing (a
    one-element fill), timed as ``time_ms`` times a kernel."""
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    return time_ms(torch, lambda: one.fill_(1))


def row_sectors(torch, table, v) -> int:
    """The distinct 32-byte sectors of ``table`` that gathering the rows
    ``clamp(v)`` touches."""
    w = table.shape[1]
    rows = v.clamp(0, table.shape[0] - 1).long()
    byte = (table.data_ptr() % 32 + rows[:, None] * (4 * w)
            + 4 * torch.arange(w, device=v.device))
    return torch.unique(byte // 32).numel()


# the users' shapes of segment_gather (src/repro/configs/): DLRM RM-2's
# largest table (dlrm_rm2.py VOCABS[0] x embed_dim) looked up by a
# serve_bulk batch (common.py RECSYS_SHAPES) at hotness 8, and GCN
# aggregation over ogb_products (common.py GNN_SHAPES)
RM2 = dict(rows=10_000_000, dim=64, bags=262_144, hotness=8)
OGB = dict(nodes=2_449_029, edges=61_859_140, feat=100)


def gather_inputs(torch, seed: int = 0) -> dict:
    """Random tables and ids at the users' shapes, made on the card from
    ``seed``: uniform ids (no padding) and per-entry weights in
    [0.5, 1.5) (DLRM per-sample weights; GCN edge normalization)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev = "cuda"

    def ids(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    bags = (RM2["bags"], RM2["hotness"])
    return {
        "fixed": (rand((RM2["rows"], RM2["dim"])), ids(RM2["rows"], bags),
                  rand(bags) + 0.5),
        "ragged": (rand((OGB["nodes"], OGB["feat"])),
                   ids(OGB["nodes"], (OGB["edges"],)),
                   ids(OGB["nodes"], (OGB["edges"],)),
                   rand((OGB["edges"],)) + 0.5),
    }


def drive_gather(torch, ops, inputs) -> dict:
    """The gather path: each ``segment_gather`` entry point once at its
    users' shape."""
    table, idx, w = inputs["fixed"]
    feat, src, dst, ew = inputs["ragged"]
    out = {"fixed": ops.segment_gather_fixed(table, idx, w),
           "ragged": ops.segment_gather_sum(feat, src, dst, OGB["nodes"], ew)}
    torch.cuda.synchronize()
    return out


def gather_row(torch, ops, ref, inputs, outs, by_path) -> dict:
    """Phase 6, ``segment_gather``: both entry points held against their
    plain versions (the ragged one summed over edge chunks, since the plain
    version at once would gather a 24.7 GB ``table[indices]``) and timed
    beside them and beside ``embedding_bag``; the kernel-line row is the
    fixed call, the ragged numbers go beside it."""
    import torch.nn.functional as F

    def nb(t):
        return t.numel() * t.element_size()

    table, idx, w = inputs["fixed"]
    want = ref.segment_gather_fixed_ref(table, idx, w)
    err = gather_close(torch, outs["fixed"], want, "float32", RM2["hotness"],
                       "segment_gather_fixed at the RM-2 shape")
    lib = F.embedding_bag(idx, table, mode="sum", per_sample_weights=w)
    gather_close(torch, lib, want, "float32", RM2["hotness"],
                 "embedding_bag at the RM-2 shape")
    del want, lib
    ms = time_ms(torch, lambda: ops.segment_gather_fixed(table, idx, w))
    plain_ms = time_ms(torch, lambda: ref.segment_gather_fixed_ref(
        table, idx, w), reps=5)
    library_ms = time_ms(torch, lambda: F.embedding_bag(
        idx, table, mode="sum", per_sample_weights=w))
    rows_read = torch.unique(idx).numel()
    byts = nb(idx) + nb(w) + rows_read * RM2["dim"] * 4 \
        + RM2["bags"] * RM2["dim"] * 4
    nops = 2 * idx.numel() * RM2["dim"]
    by = "bytes" if byts / PEAK_BYTES_S >= nops / PEAK_OPS_S else "operations"

    feat, src, dst, ew = inputs["ragged"]
    n = OGB["nodes"]
    chunk = 1 << 22

    def plain_ragged():
        acc = torch.zeros((n, OGB["feat"]), device="cuda")
        for lo in range(0, src.shape[0], chunk):
            acc += ref.segment_gather_sum_ref(feat, src[lo:lo + chunk],
                                              dst[lo:lo + chunk], n,
                                              ew[lo:lo + chunk])
        return acc

    hot = int(torch.bincount(dst.long(), minlength=n).max().item())
    r_err = gather_close(torch, outs["ragged"], plain_ragged(), "float32",
                         hot, "segment_gather_sum at the ogb_products shape")
    # the kernel alone, on the keys its wrapper sorted; embedding_bag on
    # the entries in that order
    seg, order = torch.sort(dst, stable=True)
    offsets = torch.searchsorted(
        seg, torch.arange(n + 1, dtype=torch.int32, device="cuda"),
        out_int32=True)
    idx_s, w_s = src[order].contiguous(), ew[order].contiguous()
    del seg
    lib_r = F.embedding_bag(idx_s, feat, offsets[:-1].long(), mode="sum",
                            per_sample_weights=w_s)
    gather_close(torch, lib_r, outs["ragged"], "float32", hot,
                 "embedding_bag at the ogb_products shape")
    del lib_r
    r_ms = time_ms(torch, lambda: ops.segment_gather_sum(feat, src, dst, n,
                                                         ew))
    r_kernel_ms = time_ms(torch, lambda: ops._gather_sum_launch(
        feat, src, ew, order, offsets, n))
    r_plain_ms = time_ms(torch, plain_ragged, reps=3)
    r_library_ms = time_ms(torch, lambda: F.embedding_bag(
        idx_s, feat, offsets[:-1].long(), mode="sum", per_sample_weights=w_s))
    r_rows = torch.unique(src).numel()
    r_bytes = nb(src) + nb(dst) + nb(ew) + r_rows * OGB["feat"] * 4 \
        + n * OGB["feat"] * 4
    r_ops = 2 * src.numel() * OGB["feat"]
    source, replaces = KERNEL_INFO["segment_gather"]
    row = {
        "name": "segment_gather", "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(int(c["segment_gather"]) for c in by_path.values()),
        "launches_by_path": {p: int(c["segment_gather"])
                             for p, c in by_path.items()},
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(byts / PEAK_BYTES_S, nops / PEAK_OPS_S) * 1e3,
        "bound_by": by, "library_ms": library_ms,
        "shape_rows": (RM2["bags"], RM2["hotness"]), "bytes": byts,
        "ops": nops, "shapes": [list(table.shape), list(idx.shape),
                                list(w.shape)],
        "tolerance": gather_tol("float32", RM2["hotness"]),
        "ragged": {
            "shape": OGB, "max_run": hot, "max_abs_err": r_err,
            "tolerance": gather_tol("float32", hot),
            "ms": r_ms, "kernel_ms": r_kernel_ms, "plain_ms": r_plain_ms,
            "library_ms": r_library_ms,
            "bound_ms": max(r_bytes / PEAK_BYTES_S,
                            r_ops / PEAK_OPS_S) * 1e3,
            "bytes": r_bytes, "ops": r_ops},
    }
    log(f"phase 6: segment_gather fixed {RM2}: kernel {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms embedding_bag {library_ms:.4f} ms bound "
        f"{row['bound_ms']:.4f} ms; ragged {OGB}: wrapper {r_ms:.4f} ms "
        f"kernel {r_kernel_ms:.4f} ms plain {r_plain_ms:.4f} ms "
        f"embedding_bag {r_library_ms:.4f} ms bound "
        f"{row['ragged']['bound_ms']:.4f} ms")
    return row


# ------------------------------------------------------------ phase 9: zoo

# the zoo's trainer at DLRM RM-2's published size (configs/dlrm_rm2.py)
# and the train_batch cell's batch (configs/common.py RECSYS_SHAPES); (b)
# caps each table at ZOO_CAP rows; (c) runs the serving cells' sizes
ZOO_BATCH = 65_536
ZOO_STEPS = 3
ZOO_CAP = 100_000
ZOO_SERVE = {"serve_p99": 512, "serve_bulk": 262_144}
ZOO_CANDIDATES = 1_000_000
ZOO_GCN_STEPS = 20
# the final RM-2 checkpoint holds params and both moments, about 14.7 GB
ZOO_FREE_BYTES = 30e9
# (b): the card's and the CPU's step on the same weights and batch.  The
# embedding bags are bit-equal (both sum in entry order); everything else
# sums in other orders: the dense layers' float32 products, and the
# gradients' scatter-adds (float atomics on the card, in no fixed order;
# about a fifth of a table's 524,288 ids land on its hottest row).  Each
# gradient is a sum over 65,536 samples whose terms cancel, so a float32
# gradient lies up to 3.6e-4 (norm-wise, per leaf) and 4.6e-4 (an element,
# of the leaf's largest |g|) from the float64 one at this batch
# (tools/zoo_grad_precision.py on the CPU), and two float32 runs can lie
# that far apart in opposite directions.  So: the loss within rtol 1e-5,
# the gradient norm within rtol 1e-4, and each gradient leaf within 2e-3
# norm-wise, ||g_card - g_cpu|| <= 2e-3 ||g_cpu||, with no element off by
# more than 2e-3 of the leaf's largest |g| (measured: 2.9e-4 and 4.1e-4).
# Those limits hold what comes into the tables' backward, not the
# backward: they scale with a leaf's hot rows, so one id's term dropped
# from or added twice to its row passes them for every id of (b)'s batch
# (tools/zoo_grad_plant.py).  So each table's gradient on the card is also
# held row by row against the float64 sum of the card's own terms (each a
# row of the bags' gradient d_emb; the card's d_emb and the CPU's differ
# by up to a quarter of a sample's largest element, so the CPU's sum is no
# reference at this grain): an element may differ by the rounding of a
# float32 sum of its row's n terms in any order, (n-1)·2^-24·Σ|terms|,
# plus ZOO_GRAD_TERM of the sum of those terms' largest |element| for the
# float64 sum's own rounding.  That fails a dropped or doubled term on
# any row that a few thousand ids or fewer hit: 38-59% of the batch's
# ids, per table, with zipf's hot rows holding the rest.  The card's
# gradient is also taken twice: its own run-to-run spread is logged
# beside these
ZOO_LOSS_RTOL = 1e-5
ZOO_GNORM_RTOL = 1e-4
ZOO_GRAD_NORM_RTOL = 2e-3
ZOO_GRAD_ELEM = 2e-3  # of the leaf's largest |g|
ZOO_GRAD_TERM = 1e-6
# (c): logits and scores of order 1 through float32 matrix products in
# another order; (d): GCN losses over 20 steps
ZOO_SERVE_TOL = 1e-4
ZOO_GCN_RTOL = 1e-4


def zoo_batch(torch, cfg, b: int, seed: int) -> dict:
    """A serving batch made on the card from ``seed``, distributed as
    ``RecsysStream``'s: dense N(0, 1), each field's ids a discrete
    Pareto(0.2) draw (zipf(1.2)'s tail) modulo its vocabulary, 10% of the
    slots padding (-1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dense = torch.randn((b, cfg.n_dense), generator=gen, device="cuda")
    u = torch.rand((b, cfg.n_sparse, cfg.hotness), generator=gen,
                   device="cuda", dtype=torch.float64)
    ids = torch.floor(u.clamp(min=1e-300) ** -5.0).clamp(max=2.0**62).long()
    ids = ids % torch.tensor(cfg.vocab_sizes, device="cuda")[None, :, None]
    pad = torch.rand(ids.shape, generator=gen, device="cuda") < 0.1
    return {"dense": dense,
            "sparse": torch.where(pad, -1, ids).to(torch.int32)}


def step_split(torch, ops, model, opt_state, stream, step: int, opt_cfg):
    """One train step in its parts, each timed: host batch generation
    (host clock), then on the device timeline (CUDA events, one sync at the
    end) the host-to-device copy, forward, backward and AdamW, and within
    them the embedding bags' 26 forward launches and 26 backward calls
    (zero fill + ``index_add_``), each between two events of its own.
    Returns ``(split_ms, opt_state, batch)``."""
    from repro_torch.kernels.autograd import EmbeddingBagSum
    from repro_torch.models.recsys import dlrm
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.trainstep import batch_to, named_params

    def event():
        return torch.cuda.Event(enable_timing=True)

    bags: dict[str, list] = {"forward": [], "backward": []}

    def between(part, fn):
        def timed(*args):
            ev = (event(), event())
            ev[0].record()
            out = fn(*args)
            ev[1].record()
            bags[part].append(ev)
            return out
        return timed

    t0 = time.perf_counter()
    batch = stream.batch_at(step)
    host_ms = (time.perf_counter() - t0) * 1e3
    ev = [event() for _ in range(5)]
    fwd, bwd = ops.segment_gather_fixed, EmbeddingBagSum.backward
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ops.segment_gather_fixed = between("forward", fwd)
    EmbeddingBagSum.backward = staticmethod(between("backward", bwd))
    try:
        ev[0].record()
        b = batch_to(batch, "cuda")
        ev[1].record()
        loss = dlrm.loss_fn(model, b)
        ev[2].record()
        params = named_params(model)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        ev[3].record()
    finally:
        ops.segment_gather_fixed = fwd
        EmbeddingBagSum.backward = staticmethod(bwd)
    _, opt_state, _ = adamw_update(params, grads, opt_state, opt_cfg)
    ev[4].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) * 1e3
    names = ("h2d", "forward", "backward", "optimizer")
    split = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    for part, evs in bags.items():
        split[f"bags_{part}"] = sum(a.elapsed_time(z) for a, z in evs)
        split[f"bags_{part}_calls"] = len(evs)
    split.update(host_batch=host_ms, device_wall=wall,
                 loss=float(loss.detach()))
    return split, opt_state, batch


def zoo_grads(torch, model, batch) -> tuple[float, dict, object]:
    """The loss and gradients of DLRM's loss on ``batch``, and the bags'
    gradient ``d_emb [B, F, D]`` (each table's backward scatters its
    field's rows of it)."""
    from repro_torch.models.recsys import dlrm
    from repro_torch.train.trainstep import batch_to, named_params

    dev = next(model.parameters()).device
    params = named_params(model)
    kept = []
    embed = dlrm.embed_bags

    def keep(*args):
        kept.append(embed(*args))
        return kept[-1]

    dlrm.embed_bags = keep
    try:
        loss = dlrm.loss_fn(model, batch_to(batch, dev))
    finally:
        dlrm.embed_bags = embed
    *grads, d_emb = torch.autograd.grad(loss, list(params.values()) + kept)
    return float(loss.detach()), dict(zip(params, grads)), d_emb


def zoo_b_models(torch, arch):
    """(b)'s inputs: RM-2's config with each table capped at ``ZOO_CAP``
    rows, ``RecsysStream``'s batch 0 at ``ZOO_BATCH``, the model on the
    card (weights from seed 1) and its copy on the CPU."""
    import dataclasses

    from repro_torch.launch.train import model_for
    from repro_torch.models.recsys import dlrm
    from repro_torch.train.data import RecsysStream

    cfg = dataclasses.replace(arch.config, vocab_sizes=tuple(
        min(v, ZOO_CAP) for v in arch.config.vocab_sizes))
    batch = RecsysStream(cfg.n_dense, cfg.n_sparse, cfg.hotness,
                         cfg.vocab_sizes, batch=ZOO_BATCH, seed=0).batch_at(0)
    card = model_for(arch, cfg, "cuda",
                     torch.Generator(device="cuda").manual_seed(1))
    cpu = dlrm.DLRM(cfg, device="meta")
    cpu.load_state_dict({k: v.detach().cpu() for k, v in
                         card.state_dict().items()}, assign=True)
    return cfg, batch, card, cpu


def table_terms(torch, sparse, d_emb, t: int, v: int):
    """Over the ids of field ``t`` (``sparse [B, F, K]`` on the card, < 0
    padding, >= ``v`` row v-1), per row of its table: ``n``, the ids that
    hit it; ``exact [v, D]``, the float64 sum of the terms its gradient
    adds (each a row of the bags' gradient ``d_emb[:, t]``); ``s_abs [v,
    D]``, the sum of their |elements|; ``s_inf [v]``, the sum of their
    largest |element|."""
    idx = sparse[:, t, :]
    keep = idx >= 0
    rows = idx.long().clamp(max=v - 1)[keep]
    terms = d_emb[:, t, None, :].expand(-1, idx.shape[1], -1)[keep]
    dev, d = terms.device, terms.shape[1]
    exact = torch.zeros((v, d), dtype=torch.float64, device=dev).index_add_(
        0, rows, terms.double())
    s_abs = torch.zeros((v, d), device=dev).index_add_(0, rows, terms.abs())
    s_inf = torch.zeros(v, device=dev).index_add_(0, rows,
                                                  terms.abs().amax(1))
    return torch.bincount(rows, minlength=v), exact, s_abs, s_inf


def term_excess(torch, diff, n, s_abs, s_inf):
    """Per row of a table, the largest |element| of ``diff`` (a float32
    gradient less its exact sum) beyond the rounding bound of a float32
    sum of the row's ``n`` terms in any order, (n-1)·2^-24·Σ|terms|, as a
    share of ``s_inf``; a row no id hits must not differ at all."""
    over = diff.abs() - (n - 1).clamp(min=0)[:, None] * 2.0**-24 * s_abs
    return torch.where(s_inf[:, None] > 0,
                       over / s_inf.clamp(min=1e-30)[:, None],
                       torch.where(over > 0, torch.inf, 0.0)).amax(1)


def zoo_grad_gap(torch, got: dict, want: dict, sparse, d_emb) -> dict:
    """How far the card's gradients ``got`` lie from the CPU's ``want``,
    per leaf: ``norm_rel`` (||g_card - g_cpu|| / ||g_cpu||) and
    ``max_of_leaf_max`` (the largest element difference over the leaf's
    largest |g_cpu|); for a table also ``term_excess``: the card's
    gradient against the exact sum of the card's own terms
    (:func:`table_terms` of ``d_emb`` and the batch's ``sparse``, both on
    the card), by :func:`term_excess`.  ``ok``: each within its limit."""
    out = {}
    for k, w in want.items():
        d = got[k].cpu() - w
        rel = float(d.norm() / w.norm().clamp(min=1e-30))
        elem = float(d.abs().max() / w.abs().max().clamp(min=1e-30))
        row = {"norm_rel": rel, "max_abs": float(d.abs().max()),
               "max_of_leaf_max": elem}
        ok = rel <= ZOO_GRAD_NORM_RTOL and elem <= ZOO_GRAD_ELEM
        if k.startswith("tables."):
            n, exact, s_abs, s_inf = table_terms(
                torch, sparse, d_emb, int(k.split(".")[1]), w.shape[0])
            row["term_excess"] = float(term_excess(
                torch, got[k].double() - exact, n, s_abs, s_inf).max())
            ok = ok and row["term_excess"] <= ZOO_GRAD_TERM
        row["ok"] = ok
        out[k] = row
    return out


def zoo_phase(torch, ops, ref, card: str):
    """Phase 9: the model zoo's trainer on the card.  ``drive``, the launch
    window's whole content: (a) ``repro_torch.launch.train.main`` trains
    DLRM RM-2 at its published size (26 tables, 19,107,700 rows, embed 64)
    for 3 steps at batch 65,536, then writes its final checkpoint; the
    largest ``segment_gather_fixed`` call is recorded.  ``finish(out,
    launches)``, after the window (``launches``: the window's count of
    ``segment_gather``): (a)'s checks (``final step=3`` printed, a finite
    loss, every table moved, 26 · 3 launches, the largest call bit-equal to
    its plain version, the checkpoint's step and a table's rows read back),
    one step split into its parts and one under ``torch.profiler``, the
    train_batch call and its backward
    timed, (b) one step on the card against the CPU at RM-2's widths with
    each table capped at 100,000 rows (loss, gradient norm, gradients, the
    tables' row by row; a ``Checkpointer`` round trip),
    (c) ``forward`` at the serving cells' batches and ``retrieval_score``
    against 1,000,000 candidates on (a)'s tables, each against the CPU,
    and (d) ``gcn-cora`` at its published widths for 20 steps on the card
    and on the CPU from the same weights.  Returns ``(drive, finish)``."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train
    from repro_torch.models.recsys import dlrm
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.optimizer import (OptConfig, adamw_init,
                                             adamw_update)
    from repro_torch.train.trainstep import named_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_arch("dlrm-rm2")
    cfg = arch.config
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="zoo.", dir=ROOT / "build"))
    free = shutil.disk_usage(work).free
    check(free >= ZOO_FREE_BYTES,
          f"phase 9: {free / 1e9:.1f} GB free under {work}; the RM-2 "
          f"checkpoint takes about 14.7 GB and the phase asks for "
          f"{ZOO_FREE_BYTES / 1e9:.0f} GB")
    argv = ["--arch", "dlrm-rm2", "--preset", "full", "--batch",
            str(ZOO_BATCH), "--steps", str(ZOO_STEPS), "--device", "cuda",
            "--ckpt-dir", str(work)]
    largest: dict = {}
    orig = ops.segment_gather_fixed

    def recorded(table, idx, weights=None):
        size = (table.shape[0], idx.shape[0])
        if table.is_cuda and ("size" not in largest
                              or size > largest["size"]):
            largest.update(size=size, table=table, idx=idx, weights=weights)
        return orig(table, idx, weights)

    def drive():
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = io.StringIO()
        ops.segment_gather_fixed = recorded
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                trainer = launch_train.main(argv)
        finally:
            ops.segment_gather_fixed = orig
        torch.cuda.synchronize()
        return {"trainer": trainer, "printed": out.getvalue(),
                "wall_s": time.perf_counter() - t0, "base_bytes": base,
                "peak_bytes": torch.cuda.max_memory_allocated()}

    def finish(got: dict, launched: int) -> dict:
        t_start = time.perf_counter()
        trainer = got.pop("trainer")
        model = trainer.params
        info = {"card": card, "config": {
            "tables": len(cfg.vocab_sizes), "rows": sum(cfg.vocab_sizes),
            "embed_dim": cfg.embed_dim, "bot_mlp": list(cfg.bot_mlp),
            "top_mlp": list(cfg.top_mlp), "hotness": cfg.hotness,
            "batch": ZOO_BATCH, "params": sum(p.numel()
                                              for p in model.parameters())},
            "train": dict(got)}
        print(got["printed"], end="", flush=True)
        check(f"final step={ZOO_STEPS} loss=" in got["printed"],
              f"phase 9 (a): no 'final step={ZOO_STEPS}' line: "
              f"{got['printed']!r}")
        losses = [r["loss"] for r in trainer.metrics_log]
        check(bool(losses) and all(np.isfinite(losses)),
              f"phase 9 (a): loss {losses}")
        check(launched == cfg.n_sparse * ZOO_STEPS,
              f"phase 9 (a): {launched} segment_gather launches in the "
              f"window, not {cfg.n_sparse} a step")
        init = launch_train.model_for(
            arch, cfg, "cuda", torch.Generator(device="cuda").manual_seed(0))
        moved = [bool((a != b).any()) for a, b in zip(init.tables,
                                                      model.tables)]
        del init
        check(all(moved), f"phase 9 (a): tables that did not move: "
                          f"{[i for i, m in enumerate(moved) if not m]}")
        # the largest call in the window, bit for bit
        err = max_abs_err(torch, ops.segment_gather_fixed(
            largest["table"], largest["idx"], largest["weights"]),
            ref.segment_gather_fixed_ref(largest["table"], largest["idx"],
                                         largest["weights"]))
        check(err == 0, f"phase 9: segment_gather's largest zoo call "
                        f"{largest['size']} differs from its plain version")
        info["train"].update(losses=losses, largest_call=list(
            largest["size"]), largest_call_max_abs_err=err,
            launches=launched)
        # the final checkpoint read back, then removed
        ck = Checkpointer(work / "dlrm-rm2")
        step_dir = work / "dlrm-rm2" / f"step_{ZOO_STEPS:012d}"
        meta = json.loads((step_dir / "meta.json").read_text())
        saved = torch.load(step_dir / "params.pt", mmap=True,
                           weights_only=True)
        rows = saved["k:tables.0"][:4096]
        check(ck.all_steps() == [ZOO_STEPS] and meta["step"] == ZOO_STEPS
              and torch.equal(rows, model.tables[0][:4096].detach().cpu()),
              "phase 9 (a): the checkpoint does not read back")
        info["train"]["checkpoint_bytes"] = sum(
            f.stat().st_size for f in step_dir.iterdir())
        del saved, rows
        shutil.rmtree(work / "dlrm-rm2")
        log(f"phase 9 (a) {card}: RM-2 ({info['config']['params']} params) "
            f"trained {ZOO_STEPS} steps at batch {ZOO_BATCH} in "
            f"{got['wall_s']:.1f} s (losses {losses}); peak device memory "
            f"{got['peak_bytes']} B ({got['base_bytes']} B before); "
            f"checkpoint {info['train']['checkpoint_bytes']} B read back")

        # one step in its parts, then one under the profiler
        opt_cfg = OptConfig(lr=3e-3, warmup_steps=10, total_steps=ZOO_STEPS)
        split, state, batch = step_split(torch, ops, model, trainer.opt_state,
                                         trainer.stream, ZOO_STEPS, opt_cfg)
        n_bags = len(cfg.vocab_sizes)
        check(split["bags_forward_calls"] == n_bags
              and split["bags_backward_calls"] == n_bags,
              f"phase 9: the timed step made {split['bags_forward_calls']} "
              f"bag launches and {split['bags_backward_calls']} bag "
              f"backward calls, not {n_bags} each")
        step = trainer.step_fn
        # the bag kernels: segment_gather's forward launches and index_add_'s
        # (torch's indexFunc kernels) in the backward.  Late in this script
        # the profiler records only some of segment_gather's launches (10
        # to 12 of 26, also after a profiled warm-up step), so the busy
        # share is given with the missing launches added at their CUDA
        # event time, an upper bound of their kernels' time
        prof = profile_query(torch, lambda: step(model, state, batch),
                             ("segment_gather", "indexFunc"))
        missing = n_bags - prof["parts"]["segment_gather"]["calls"]
        upper = (prof["device_busy_us"] + missing / n_bags
                 * split["bags_forward"] * 1e3) / prof["window_us"]
        # a step as the loop runs it: its batch's generation, then the step
        with_batch = prof["device_busy_us"] / (
            split["host_batch"] * 1e3 + prof["window_us"])
        info["step_split_ms"] = split
        info["profile"] = {"step": prof, "busy_share_with_batch": with_batch,
                           "segment_gather_missing": missing,
                           "busy_share_upper": upper}
        log(f"phase 9 {card}: one step: host batch "
            f"{split['host_batch']:.1f} ms, h2d {split['h2d']:.2f} ms, "
            f"forward {split['forward']:.2f} ms (its {n_bags} bag launches "
            f"{split['bags_forward']:.3f} ms), backward "
            f"{split['backward']:.2f} ms (the bags' {n_bags} backward calls "
            f"{split['bags_backward']:.3f} ms), optimizer "
            f"{split['optimizer']:.2f} ms (device timeline); the device "
            f"is busy {prof['device_busy_share']} (at most {upper}) of a "
            f"step without its batch generation, {with_batch} with it; its "
            f"bag kernels (profiled): {prof['parts']}")

        # the train_batch call (the 10M table) and its backward, timed
        table, idx = largest["table"].detach(), largest["idx"]
        safe, mask = idx.clamp(min=0), (idx >= 0).to(table.dtype)
        lib = F.embedding_bag(safe, table, mode="sum",
                              per_sample_weights=mask)
        lib_err = gather_close(torch, lib, orig(table, idx), "float32",
                               cfg.hotness, "embedding_bag at train_batch")
        keep = idx >= 0
        rows_k = idx.long().clamp(max=table.shape[0] - 1)[keep]
        d_out = torch.randn((idx.shape[0], table.shape[1]), device="cuda")
        src = d_out[:, None, :].expand(*idx.shape, table.shape[1])[keep]
        n_valid = int(keep.sum())
        distinct = torch.unique(idx[keep]).numel()
        byts = (idx.numel() * 4 + distinct * table.shape[1] * 4
                + idx.shape[0] * table.shape[1] * 4)
        nops = n_valid * table.shape[1]
        info["train_batch_call"] = {
            "shape": [list(table.shape), list(idx.shape)],
            "valid": n_valid, "distinct_rows": distinct,
            "ms": time_ms(torch, lambda: orig(table, idx)),
            "plain_ms": time_ms(torch, lambda: ref.segment_gather_fixed_ref(
                table, idx), reps=5),
            "library_ms": time_ms(torch, lambda: F.embedding_bag(
                safe, table, mode="sum", per_sample_weights=mask)),
            "library_max_abs_err": lib_err,
            "bound_ms": max(byts / PEAK_BYTES_S, nops / PEAK_OPS_S) * 1e3,
            "bound_by": ("bytes" if byts / PEAK_BYTES_S >= nops / PEAK_OPS_S
                         else "operations"),
            "backward_ms": time_ms(torch, lambda: torch.zeros_like(
                table).index_add_(0, rows_k, src), reps=5),
            "backward_index_add_ms": time_ms(torch, lambda: torch.empty_like(
                table).index_add_(0, rows_k, src), reps=5),
            # the dense gradient written once, d_out and the ids read once
            "backward_bound_ms": (table.numel() * 4 + idx.numel() * 4
                                  + idx.shape[0] * table.shape[1] * 4)
            / PEAK_BYTES_S * 1e3}
        del lib, d_out, src, rows_k, keep, safe, mask
        tb = info["train_batch_call"]
        log(f"phase 9 {card}: train_batch call {tb['shape']}: kernel "
            f"{tb['ms']:.4f} ms, plain {tb['plain_ms']:.4f} ms, "
            f"embedding_bag {tb['library_ms']:.4f} ms, bound "
            f"{tb['bound_ms']:.4f} ms; its backward (zero fill + "
            f"index_add_) {tb['backward_ms']:.4f} ms, index_add_ alone "
            f"{tb['backward_index_add_ms']:.4f} ms, bound "
            f"{tb['backward_bound_ms']:.4f} ms")
        largest.clear()

        # (c) the serving functions on (a)'s tables, against the CPU
        cpu_model = dlrm.DLRM(cfg, device="meta")
        cpu_model.load_state_dict({k: v.detach().cpu() for k, v in
                                   model.state_dict().items()}, assign=True)
        info["serve"] = {}
        with torch.no_grad():
            for cell, b in ZOO_SERVE.items():
                sb = zoo_batch(torch, cfg, b, seed=b)
                want = cpu_model({k: v.cpu() for k, v in sb.items()})
                got_c = model(sb)
                err = float((got_c.cpu() - want).abs().max())
                check(bool(torch.allclose(got_c.cpu(), want,
                                          rtol=ZOO_SERVE_TOL,
                                          atol=ZOO_SERVE_TOL)),
                      f"phase 9 (c): forward at {cell} ({b}) differs from "
                      f"the CPU by {err}")
                info["serve"][cell] = {
                    "batch": b, "max_abs_err": err,
                    "ms": time_ms(torch, lambda: model(sb), reps=5)}
            q = zoo_batch(torch, cfg, 1, seed=7)
            gen = torch.Generator(device="cuda").manual_seed(11)
            q["cand"] = torch.randn((ZOO_CANDIDATES, cfg.embed_dim),
                                    generator=gen, device="cuda")
            want = dlrm.retrieval_score(cpu_model, {k: v.cpu()
                                                    for k, v in q.items()})
            got_r = dlrm.retrieval_score(model, q)
            err = float((got_r.cpu() - want).abs().max())
            check(got_r.shape == (ZOO_CANDIDATES,) and bool(torch.allclose(
                got_r.cpu(), want, rtol=ZOO_SERVE_TOL, atol=ZOO_SERVE_TOL)),
                  f"phase 9 (c): retrieval_score differs from the CPU by "
                  f"{err}")
            info["serve"]["retrieval_cand"] = {
                "candidates": ZOO_CANDIDATES, "max_abs_err": err,
                "ms": time_ms(torch, lambda: dlrm.retrieval_score(model, q),
                              reps=5)}
        del cpu_model, model, state, trainer, q
        log(f"phase 9 (c) {card}: serving equals the CPU run: "
            f"{info['serve']}")

        # (b) one step on the card against the CPU, tables capped
        cfg_b, batch_b, card_m, cpu_m = zoo_b_models(torch, arch)
        _, again, _ = zoo_grads(torch, card_m, batch_b)  # the card's spread
        sides = {}
        for name, m in (("cuda", card_m), ("cpu", cpu_m)):
            t0 = time.perf_counter()
            loss, grads, d_emb = zoo_grads(torch, m, batch_b)
            st = adamw_init(named_params(m), opt_cfg)
            _, st, gn = adamw_update(named_params(m), grads, st, opt_cfg)
            sides[name] = (loss, float(gn), grads, st, d_emb,
                           time.perf_counter() - t0)
        (l_g, gn_g, gr_g, st_g, d_emb, s_g), (l_c, gn_c, gr_c, _, _, s_c) = \
            sides["cuda"], sides["cpu"]
        spread = {k: float((again[k] - g).norm() / g.norm().clamp(
            min=1e-30)) for k, g in gr_g.items()}
        del again
        check(abs(l_g - l_c) <= ZOO_LOSS_RTOL * abs(l_c),
              f"phase 9 (b): loss {l_g} on the card, {l_c} on the CPU")
        check(abs(gn_g - gn_c) <= ZOO_GNORM_RTOL * abs(gn_c),
              f"phase 9 (b): gradient norm {gn_g} on the card, {gn_c} on "
              f"the CPU")
        worst = zoo_grad_gap(torch, gr_g, gr_c, torch.from_numpy(
            batch_b["sparse"]).cuda(), d_emb)
        for k, w in worst.items():
            w["card_spread"] = spread[k]
            check(w["ok"], f"phase 9 (b): gradient {k} differs from the "
                           f"CPU's: {w}")
        # a Checkpointer round trip at this size
        ck_b = Checkpointer(work / "b", keep=1)
        ck_b.save(1, {"params": card_m.state_dict(), "opt": st_g})
        _, trees, _ = ck_b.restore({"params": card_m.state_dict(),
                                    "opt": st_g})
        same = all(torch.equal(trees["params"][k], v)
                   for k, v in card_m.state_dict().items()) and all(
            torch.equal(trees["opt"].mu[k], st_g.mu[k])
            and torch.equal(trees["opt"].nu[k], st_g.nu[k]) for k in st_g.mu)
        check(same, "phase 9 (b): the checkpoint does not round-trip")
        shutil.rmtree(work / "b")
        info["step_vs_cpu"] = {
            "rows": sum(cfg_b.vocab_sizes), "loss": [l_g, l_c],
            "grad_norm": [gn_g, gn_c], "grad_max_abs_err": worst,
            "seconds": [s_g, s_c]}
        log(f"phase 9 (b) {card}: one step at {sum(cfg_b.vocab_sizes)} rows "
            f"equals the CPU's: loss {l_g} / {l_c}, grad norm {gn_g} / "
            f"{gn_c}, largest norm-wise gradient difference "
            f"{max(w['norm_rel'] for w in worst.values()):.2e} (the card's "
            f"own spread up to {max(spread.values()):.2e}), a table's "
            f"largest beyond its rounding "
            f"{max(w.get('term_excess', 0) for w in worst.values()):.2e} of "
            f"its terms; checkpoint "
            f"round trip held")
        del card_m, cpu_m, sides, gr_g, gr_c, st_g, trees, d_emb

        # (d) gcn-cora at its published widths, card against CPU
        runs = {}
        for device in ("cuda", "cpu"):
            tr = launch_train.build(launch_train.parse_args(
                ["--arch", "gcn-cora", "--preset", "full", "--steps",
                 str(ZOO_GCN_STEPS), "--device", device, "--ckpt-dir",
                 str(work / device), "--ckpt-every", "1000"]))
            if device == "cpu":
                tr.params.load_state_dict({k: v.cpu() for k, v in
                                           runs["cuda_init"].items()})
            else:
                runs["cuda_init"] = {k: v.detach().clone() for k, v in
                                     tr.params.state_dict().items()}
            tr.cfg.log_every = 1
            tr.fit()
            runs[device] = [r["loss"] for r in tr.metrics_log]
        gl, cl = np.array(runs["cuda"]), np.array(runs["cpu"])
        check(len(gl) == ZOO_GCN_STEPS and np.allclose(gl, cl,
                                                       rtol=ZOO_GCN_RTOL,
                                                       atol=0),
              f"phase 9 (d): GCN losses on the card {gl} and the CPU {cl}")
        info["gcn"] = {"losses_cuda": runs["cuda"], "losses_cpu": runs["cpu"],
                       "max_rel_err": float(np.max(np.abs(gl - cl) / cl))}
        shutil.rmtree(work)
        log(f"phase 9 (d) {card}: gcn-cora {ZOO_GCN_STEPS} steps, losses "
            f"{gl[0]:.5f} -> {gl[-1]:.5f} on the card equal the CPU's "
            f"(largest relative difference {info['gcn']['max_rel_err']:.2e})")
        info["finish_s"] = time.perf_counter() - t_start
        return info

    return drive, finish


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=1000,
                    help="LUBM universities at full scale (default 1000)")
    ap.add_argument("--save-calls", type=Path, default=None,
                    help="also save the largest and smallest recorded calls "
                         "(arguments and keywords) of the kernels in "
                         "SMALLEST (torch.save) for tools/kernel_ab.py")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, ops, ref

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"phase 2: built {len(libs)} kernel libraries in {build_s:.1f} s")
    ptxas = {name: (_build.BUILD_DIR / f"{name}.ptxas.txt").read_text()
             for name in libs
             if (_build.BUILD_DIR / f"{name}.ptxas.txt").exists()}

    synthetic_checks(torch, ops, ref)

    bench = json.loads((ROOT / "benchmarks" / "BENCH_exec.json")
                       .read_text())["results"]
    rec = Recorder(ops)
    by_path: dict[str, dict] = {}

    def window(path: str, drive, recorder: Recorder | None = rec):
        """Drive one path with the launch counters set to 0 just before and
        read just after; each kernel of the path must have launched.
        ``recorder`` (phase 6's by default) keeps the path's calls."""
        if recorder is not None:
            recorder.install(path)
        ops.reset_launches()
        out = drive()
        torch.cuda.synchronize()
        by_path[path] = dict(ops.launches)
        if recorder is not None:
            recorder.remove()
        log(f"{path} path launches: {by_path[path]}")
        for name in PATH_KERNELS[path]:
            check(by_path[path][name] > 0,
                  f"{name} was never launched on the {path} path")
        return out

    parity, (full, st, static, answers) = window("static", lambda: (
        run_parity(torch, bench), run_full(torch, ops, args.scale)))
    full["profiles"] = profile_queries(torch, static[2])
    full["capacity"] = run_capacity(torch)
    params, finish = window("params", lambda: run_params(torch, ops,
                                                         *static))
    finish()
    drive, finish = sharded_phase(torch, ops, ref, static, full, card)
    rec8 = Recorder(ops)  # the sharded path's largest calls, for phase 8
    window("sharded", drive, recorder=rec8)
    sharded = finish(rec8)
    del drive, rec8
    g, maps, cpu = static[0], static[1], static[3]  # the card's engine goes
    del static, finish
    live, finish, compacted, served = window(
        "live", lambda: run_live(torch, ops, st, args.scale))
    finish()
    del st, finish
    serve = window("serve", lambda: run_serve(
        torch, ops, (g, maps, answers, cpu), served, card), recorder=None)
    compacted()
    del g, maps, answers, cpu, served, compacted
    inputs = gather_inputs(torch)
    outs = window("gather", lambda: drive_gather(torch, ops, inputs))
    t_zoo = time.perf_counter()
    drive, finish = zoo_phase(torch, ops, ref, card)
    zoo = finish(window("zoo", drive, recorder=None),
                 by_path["zoo"]["segment_gather"])
    zoo["phase_s"] = time.perf_counter() - t_zoo
    del drive, finish
    log(f"phase 9: {zoo['phase_s']:.1f} s")

    table = kernel_table(torch, ops, ref, rec, by_path)
    table.append(gather_row(torch, ops, ref, inputs, outs, by_path))
    table[-1]["train_batch"] = zoo["train_batch_call"]
    del inputs, outs
    if args.save_calls is not None:
        args.save_calls.parent.mkdir(parents=True, exist_ok=True)
        torch.save({name: {"largest": rec.calls[name][1:],
                           "smallest": rec.smallest[name][1:]}
                    for name in SMALLEST}, args.save_calls)
    hist = {p: {str(c): n for c, n in sorted(h.items())}
            for p, h in rec.cap_hist.items()}
    log(f"phase 6: expand_filter_compact calls by power-of-two capacity: "
        f"{hist}")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": ptxas, "parity": parity, "full": full,
              "params": params, "live": live, "serve": serve,
              "sharded": sharded, "zoo": zoo,
              "kernels": table,
              "efc_capacity_hist": hist,
              "total_s": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in table]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
